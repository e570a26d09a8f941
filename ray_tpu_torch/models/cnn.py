"""Convolutional vision trunk (Nature-DQN shape), the port of
`ray_tpu/models/cnn.py`.

The params keep the JAX package's names and layouts: HWIO conv kernels
(`conv{i}_w` [k, k, c_in, c_out]) and `dense_w` [h * w * c, dense] whose
rows are in (h, w, c) order. Frames come in NHWC, as the reference takes
them. `cnn_apply` runs each convolution in PyTorch's NCHW with the kernel
seen as OIHW, and turns the last feature map back to NHWC before the
flatten: flattening the NCHW map would feed `dense_w` its rows in
(c, h, w) order, a permuted input that fails nothing loudly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ConvSpec:
    features: int
    kernel: int
    stride: int


# The classic Atari trunk (Mnih et al. 2015): 84x84x4 -> 7x7x64.
NATURE_CNN: Tuple[ConvSpec, ...] = (
    ConvSpec(32, 8, 4), ConvSpec(64, 4, 2), ConvSpec(64, 3, 1),
)


@dataclass(frozen=True)
class CNNConfig:
    input_hw: Tuple[int, int] = (84, 84)
    input_channels: int = 4
    convs: Tuple[ConvSpec, ...] = NATURE_CNN
    dense: int = 512


def _shapes(cfg: CNNConfig) -> Dict[str, Tuple[int, ...]]:
    """Each param's shape (VALID padding)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    h, w = cfg.input_hw
    c_in = cfg.input_channels
    for i, spec in enumerate(cfg.convs):
        shapes[f"conv{i}_w"] = (spec.kernel, spec.kernel, c_in,
                                spec.features)
        shapes[f"conv{i}_b"] = (spec.features,)
        h = (h - spec.kernel) // spec.stride + 1
        w = (w - spec.kernel) // spec.stride + 1
        c_in = spec.features
    shapes["dense_w"] = (h * w * c_in, cfg.dense)
    shapes["dense_b"] = (cfg.dense,)
    return shapes


def cnn_init(generator: torch.Generator, cfg: CNNConfig,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """He-normal kernels (fan-in k * k * c_in, and h * w * c for the
    dense layer) and zero biases, drawn from the CPU `generator`."""
    dev = resolve_device(device)
    params = {}
    for name, shape in _shapes(cfg).items():
        if name.endswith("_b"):
            params[name] = torch.zeros(shape, device=dev)
            continue
        fan_in = 1
        for n in shape[:-1]:
            fan_in *= n
        params[name] = (torch.randn(shape, generator=generator)
                        * (2.0 / fan_in) ** 0.5).to(dev)
    return params


def cnn_apply(params: Dict[str, torch.Tensor], cfg: CNNConfig,
              x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) image batch -> (B, dense) features. uint8 frames are
    scaled to [0, 1] here (any input is divided by 255, as the
    reference's is)."""
    x = x.to(torch.float32) / 255.0
    x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for i, spec in enumerate(cfg.convs):
        kernel = params[f"conv{i}_w"].permute(3, 2, 0, 1)   # HWIO -> OIHW
        x = torch.relu(F.conv2d(x, kernel, params[f"conv{i}_b"],
                                stride=spec.stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) rows
    return torch.relu(x @ params["dense_w"] + params["dense_b"])
