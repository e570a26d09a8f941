"""Simple MLP (MNIST-class), the port of `ray_tpu/models/mlp.py`.

Params are a list of `{"w": [in, out], "b": [out]}` layers, the JAX
package's layout, so its weights load with `torch.from_numpy` leaf by
leaf. `mlp_init` draws from an explicit `torch.Generator` at the same
scale as the reference (He normal, zero biases); the draws themselves
differ, since JAX's PRNG is not torch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (256, 256)
    out_dim: int = 10


def mlp_init(generator: torch.Generator, cfg: MLPConfig,
             device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """`generator` is a CPU generator: the draws are the same whatever
    the device the params land on."""
    dev = resolve_device(device)
    dims = [cfg.in_dim, *cfg.hidden, cfg.out_dim]
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator) * (2.0 / a) ** 0.5
        params.append({"w": w.to(dev), "b": torch.zeros((b,), device=dev)})
    return params


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x
