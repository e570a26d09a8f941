"""Flagship decoder-only transformer LM, inference half, in PyTorch.

The port of `ray_tpu/models/transformer.py` for the dense configuration:
pre-norm RMSNorm blocks with a fused QKV projection, rotary embeddings,
causal attention through `ops.attention.attention` (the flash kernel at
eligible shapes), a SiLU-gated FFN and tied embeddings.

Parameters are a plain dict in the JAX package's leaf layouts, one dict per
layer instead of stacked `[L, ...]` leaves: `embed [V, D]`, and per layer
`ln1 [D]`, `wqkv [D, 3, H*hd]`, `wo [H*hd, D]`, `ln2 [D]`,
`w13 [D, 2, F]`, `w2 [F, D]`; then `ln_f [D]`. `params_from_jax` turns
the JAX package's params (as numpy arrays) into this form without
transposes, so both packages run the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs

_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w13", "w2")


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    num_experts: int = 0          # MoE is not ported: > 1 raises
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 1


Params = Dict[str, Any]


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md, 'MoE')")


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random weights, each leaf N(0, 1/fan_in), norms at 1. `generator`
    must live on `device` (default: a generator seeded with 0 there)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f, hh, v = (cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim,
                   cfg.vocab_size)

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=cfg.param_dtype) * (1.0 / fan_in) ** 0.5)

    def ones(n):
        return torch.ones((n,), device=dev, dtype=cfg.param_dtype)

    layers = [{"ln1": ones(d), "wqkv": norm((d, 3, hh), d),
               "wo": norm((hh, d), hh), "ln2": ones(d),
               "w13": norm((d, 2, f), d), "w2": norm((f, d), f)}
              for _ in range(cfg.n_layers)]
    return {"embed": norm((v, d), d), "layers": layers, "ln_f": ones(d)}


def params_from_jax(np_tree: Params, device: DeviceLike = None) -> Params:
    """The JAX package's params pytree (leaves as numpy arrays, layer leaves
    stacked `[L, ...]`) as this module's params on `device`: layer `i`
    takes slice `i` of every stacked leaf; no leaf is transposed."""
    dev = resolve_device(device)
    layers_np = np_tree["layers"]
    extra = set(layers_np) - set(_LAYER_KEYS)
    if extra:
        raise NotImplementedError(
            f"layer leaves {sorted(extra)} (MoE) are not ported yet")

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    n_layers = int(np.shape(layers_np["ln1"])[0])
    layers = [{key: t(np.asarray(layers_np[key])[i]) for key in _LAYER_KEYS}
              for i in range(n_layers)]
    return {"embed": t(np_tree["embed"]), "layers": layers,
            "ln_f": t(np_tree["ln_f"])}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Variance in float32; `x * rsqrt` is cast to x's dtype before the
    scale (cast to x's dtype too) multiplies it."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


Rope = Callable[[torch.Tensor], torch.Tensor]
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _layer(x: torch.Tensor, lp: Params, cfg: TransformerConfig, rope: Rope,
           attend: Attend):
    """One block on x [B, S, D]: `rope` rotates q and k ([B, S, H, hd]),
    `attend(q, k, v)` returns the attention output [B, S, H, hd]. Returns
    (x, k, v) so the serving engine can cache the rotated keys and the
    values."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    act = x.dtype
    y = _rmsnorm(x, lp["ln1"])
    qkv = (y @ lp["wqkv"].to(act).reshape(d, 3 * h * hd)).view(
        b, s, 3, h, hd)
    q = rope(qkv[:, :, 0])
    k = rope(qkv[:, :, 1])
    v = qkv[:, :, 2]
    o = attend(q, k, v)
    x = x + o.reshape(b, s, h * hd) @ lp["wo"].to(act)
    y = _rmsnorm(x, lp["ln2"])
    gu = (y @ lp["w13"].to(act).reshape(d, -1)).view(b, s, 2, cfg.d_ff)
    x = x + (F.silu(gu[:, :, 0]) * gu[:, :, 1]) @ lp["w2"].to(act)
    return x, k, v


def backbone(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, D] in `cfg.dtype`.
    `positions=None` means arange and keeps the flash kernel eligible;
    explicit positions take the plain attention path."""
    _check_dense(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = rotary_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=x.device)

    def rope(t):
        return apply_rotary(t, cos, sin, positions)

    def attend(q, k, v):
        return attention(q, k, v, causal=True, positions=positions)

    for lp in params["layers"]:
        x, _, _ = _layer(x, lp, cfg, rope, attend)
    return _rmsnorm(x, params["ln_f"])


def forward(params: Params, tokens, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            device: DeviceLike = None) -> torch.Tensor:
    """tokens [B, S] (ints) -> logits [B, S, V] in `cfg.dtype`, through the
    tied embedding. The params must already live on `device`."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, not "
                         f"on {dev}")
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    if tokens.numel() and not (0 <= int(tokens.min())
                               and int(tokens.max()) < cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.long, device=dev)
    x = backbone(params, tokens, cfg, positions)
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype))
