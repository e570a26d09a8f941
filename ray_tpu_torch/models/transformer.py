"""Flagship decoder-only transformer LM in PyTorch: forward, loss and the
per-layer rematerialization policies.

The port of `ray_tpu/models/transformer.py`, single-device: pre-norm
RMSNorm blocks with a fused QKV projection, rotary embeddings, causal
attention through `ops.attention.attention` (the flash kernels at eligible
shapes), a SiLU-gated FFN or, with `num_experts > 1`, a mixture of experts
(`ops.moe.moe_ffn`), and tied embeddings. `backbone` and `forward` return
the sum of the layers' load-balancing losses beside their output, as JAX's
do; `lm_loss` is the next-token cross-entropy, whole or in sequence chunks,
plus `aux_loss_weight` times that sum.

Parameters are a plain dict in the JAX package's leaf layouts, one dict per
layer instead of stacked `[L, ...]` leaves: `embed [V, D]`, and per layer
`ln1 [D]`, `wqkv [D, 3, H*hd]`, `wo [H*hd, D]`, `ln2 [D]`, then either
`w13 [D, 2, F]`, `w2 [F, D]` (dense) or `router [D, E]`, `moe_w1 [E, D, F]`,
`moe_w2 [E, F, D]` (MoE); then `ln_f [D]`. `params_from_jax` turns the JAX
package's params (as numpy arrays) into this form without transposes, so
both packages run the same weights.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import FLASH_FWD_OP, attention
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs

_DENSE_KEYS = ("ln1", "wqkv", "wo", "ln2", "w13", "w2")
_MOE_KEYS = ("ln1", "wqkv", "wo", "ln2", "router", "moe_w1", "moe_w2")


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    num_experts: int = 0          # 0 => dense FFN in every layer
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16      # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    # Recompute each layer in the backward (`torch.utils.checkpoint`),
    # saving what `remat_policy` names (a key of `_REMAT_POLICIES`).
    remat: bool = False
    remat_policy: Optional[str] = None
    aux_loss_weight: float = 0.01
    # > 0: `lm_loss` makes the [B, chunk, V] logits one sequence chunk at a
    # time and recomputes each chunk's logits GEMM in the backward, so the
    # [B, S, V] logits never exist at once.
    loss_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 1


Params = Dict[str, Any]


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random weights, each leaf N(0, 1/fan_in), norms at 1. `generator`
    must live on `device` (default: a generator seeded with 0 there).
    MoE layers take `router`, `moe_w1`, `moe_w2` (fan-in D, D, F) in place
    of `w13`, `w2`."""
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

    def layer():
        lp = {"ln1": ones(d), "wqkv": norm((d, 3, hh), d),
              "wo": norm((hh, d), hh), "ln2": ones(d)}
        if cfg.is_moe:
            e = cfg.num_experts
            lp.update(router=norm((d, e), d), moe_w1=norm((e, d, f), d),
                      moe_w2=norm((e, f, d), f))
        else:
            lp.update(w13=norm((d, 2, f), d), w2=norm((f, d), f))
        return lp

    layers = [layer() for _ in range(cfg.n_layers)]
    return {"embed": norm((v, d), d), "layers": layers, "ln_f": ones(d)}


def params_from_jax(np_tree: Params, device: DeviceLike = None) -> Params:
    """The JAX package's params pytree (leaves as numpy arrays, layer leaves
    stacked `[L, ...]`) as this module's params on `device`: layer `i`
    takes slice `i` of every stacked leaf; no leaf is transposed."""
    dev = resolve_device(device)
    layers_np = np_tree["layers"]
    keys = next((keys for keys in (_DENSE_KEYS, _MOE_KEYS)
                 if set(layers_np) == set(keys)), None)
    if keys is None:
        raise ValueError(f"layer leaves {sorted(layers_np)} are neither "
                         f"the dense {_DENSE_KEYS} nor the MoE {_MOE_KEYS}")

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    n_layers = int(np.shape(layers_np["ln1"])[0])
    layers = [{key: t(np.asarray(layers_np[key])[i]) for key in keys}
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

# The name of the value being made (JAX's `checkpoint_name`), read by the
# remat policies while the ops that make it are dispatched. Names are set
# only while `_NAMING` is on, inside a layer checkpointed under a named
# policy, so a call outside one (the serving engine's) pays for no scope.
_NAME: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "checkpoint_name", default=None)
_NAMING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "checkpoint_naming", default=False)
_UNNAMED = contextlib.nullcontext()
# The op that makes each named value: "qkv" is the fused projection's
# matmul; "attn_out" is K1, whose saved outputs (o and the row logsumexp)
# spare the backward a second K1. On the plain attention path no op is
# saved under "attn_out": its backward recomputes the probabilities either
# way, where JAX's saved o spares only the last P.V product.
_NAMED_OPS = {"qkv": torch.ops.aten.mm.default, "attn_out": FLASH_FWD_OP}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

# remat_policy -> (ops whose outputs are saved, names whose ops are saved);
# everything else in a layer is recomputed in the backward. The sets are
# those of the JAX policies: "dots" saves matmuls without batch dims
# (`dots_with_no_batch_dims_saveable`), "dots_batch" all of them
# (`dots_saveable`; on the flash path only the MoE experts' products are
# batched: `ops/moe.py` runs router, dispatch and combine as `mm`), and the
# named policies what `save_only_these_names` saves, plus K1's logsumexp.
_REMAT_POLICIES = {
    None: ((), ()),
    "dots": (_MATMULS, ()),
    "dots_batch": (_MATMULS + (torch.ops.aten.bmm.default,), ()),
    "save_attn": ((), ("attn_out",)),
    "save_attn_qkv": ((), ("attn_out", "qkv")),
}


@contextlib.contextmanager
def _named(name: str):
    token = _NAME.set(name)
    try:
        yield
    finally:
        _NAME.reset(token)


def checkpoint_name(name: str):
    """Names the value that the ops inside the block make, for the remat
    policies (the counterpart of JAX's `checkpoint_name`); a no-op outside
    a layer checkpointed under a named policy."""
    return _named(name) if _NAMING.get() else _UNNAMED


def _naming(fn: Callable) -> Callable:
    """fn with `checkpoint_name` scopes on; the checkpoint's recompute
    calls it again, so the recomputed ops carry the same names."""

    def named_fn(*args):
        token = _NAMING.set(True)
        try:
            return fn(*args)
        finally:
            _NAMING.reset(token)

    return named_fn


def _remat_policy(save_ops, save_names, ctx, op, *args, **kwargs):
    name = _NAME.get()
    if op in save_ops or (name in save_names and op == _NAMED_OPS[name]):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_layer(fn: Callable, policy_name: Optional[str]) -> Callable:
    """fn, recomputed in the backward (non-reentrant
    `torch.utils.checkpoint`) except for what the policy saves."""
    if policy_name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy_name!r}; one of "
                         f"{sorted(_REMAT_POLICIES, key=str)}")
    save_ops, save_names = _REMAT_POLICIES[policy_name]
    context_fn = noop_context_fn
    if save_ops or save_names:
        policy = functools.partial(_remat_policy, save_ops, save_names)
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       policy)
    if save_names:
        fn = _naming(fn)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def _layer(x: torch.Tensor, lp: Params, cfg: TransformerConfig, rope: Rope,
           attend: Attend):
    """One block on x [B, S, D]: `rope` rotates q and k ([B, S, H, hd]),
    `attend(q, k, v)` returns the attention output [B, S, H, hd]. Returns
    (x, aux, k, v): aux is an MoE layer's load-balancing loss (float32
    scalar) and None for a dense layer; k and v let the serving engine
    cache the rotated keys and the values."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    act = x.dtype
    y = _rmsnorm(x, lp["ln1"]).reshape(b * s, d)
    wqkv = lp["wqkv"].to(act).reshape(d, 3 * h * hd)
    with checkpoint_name("qkv"):
        qkv = torch.mm(y, wqkv)
    qkv = qkv.view(b, s, 3, h, hd)
    q = rope(qkv[:, :, 0])
    k = rope(qkv[:, :, 1])
    v = qkv[:, :, 2]
    with checkpoint_name("attn_out"):
        o = attend(q, k, v)
    x = x + o.reshape(b, s, h * hd) @ lp["wo"].to(act)
    y = _rmsnorm(x, lp["ln2"])
    if cfg.is_moe:
        ff, aux = moe_ffn(y, lp["router"], lp["moe_w1"], lp["moe_w2"],
                          top_k=cfg.moe_top_k,
                          capacity_factor=cfg.capacity_factor)
    else:
        gu = (y @ lp["w13"].to(act).reshape(d, -1)).view(b, s, 2, cfg.d_ff)
        ff = (F.silu(gu[:, :, 0]) * gu[:, :, 1]) @ lp["w2"].to(act)
        aux = None
    return x + ff, aux, k, v


def backbone(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
             positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, D] in `cfg.dtype`, the
    layers' summed load-balancing loss, a float32 scalar: zero for a dense
    model). `positions=None` means arange and keeps the flash kernel
    eligible; explicit positions take the plain attention path. With
    `cfg.remat` each layer, its MoE routing included, is recomputed in
    the backward under `cfg.remat_policy`."""
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = rotary_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=x.device)

    def rope(t):
        return apply_rotary(t, cos, sin, positions)

    def attend(q, k, v):
        return attention(q, k, v, causal=True, positions=positions)

    def block(x, lp):
        return _layer(x, lp, cfg, rope, attend)[:2]

    if cfg.remat:
        block = _checkpoint_layer(block, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, layer_aux = block(x, lp)
        if layer_aux is not None:
            aux = aux + layer_aux
    return _rmsnorm(x, params["ln_f"]), aux


def _device_tokens(params: Params, tokens, cfg: TransformerConfig,
                   device: DeviceLike) -> torch.Tensor:
    """tokens as a long tensor on `device`, where the params must live;
    ids outside the vocabulary raise here, before any gather on the
    card."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, not "
                         f"on {dev}")
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    if tokens.numel() and not (0 <= int(tokens.min())
                               and int(tokens.max()) < cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
    return tokens


def forward(params: Params, tokens, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (ints) -> (logits [B, S, V] in `cfg.dtype`, through
    the tied embedding; the load-balancing loss, as `backbone` gives it).
    The params must already live on `device`."""
    tokens = _device_tokens(params, tokens, cfg, device)
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.long,
                                    device=tokens.device)
    x, aux = backbone(params, tokens, cfg, positions)
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype)), aux


def _token_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL (over `mask`'s ones when given): the logsumexp
    upcasts the logits to float32 inside the reduction, and the target
    logit is gathered from the logits in their own dtype."""
    lse = torch.logsumexp(logits.float(), dim=-1)                # [B, S]
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    nll = lse - tgt.float()
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _chunk_nll(x_c, embed, t_c, m_c):
    logits = torch.einsum("bcd,vd->bcv", x_c, embed)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, t_c[..., None])[..., 0]
    return ((lse - tgt.float()) * m_c).sum()


def _chunked_nll(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor], chunk: int) -> torch.Tensor:
    """`_token_nll` over tied embeddings, one sequence chunk at a time: each
    chunk's [B, chunk, V] logits are reduced at once and recomputed in the
    backward (checkpointed), so no [B, S, V] tensor is kept."""
    s = x.shape[1]
    m = (torch.ones(targets.shape, dtype=torch.float32, device=x.device)
         if mask is None else mask)
    total = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_nll, x[:, sl], embed,
                                   targets[:, sl], m[:, sl],
                                   use_reentrant=False)
    return total / m.sum().clamp(min=1.0)


def lm_loss(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            device: DeviceLike = None) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar); batch = {"tokens":
    [B, S+1] ints, optional "mask": [B, S]}, plus `cfg.aux_loss_weight`
    times the layers' load-balancing loss (zero for a dense model). The
    params must already live on `device`."""
    tokens = _device_tokens(params, batch["tokens"], cfg, device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32,
                               device=tokens.device)
    x, aux = backbone(params, inputs, cfg)
    embed = params["embed"].to(cfg.dtype)
    if cfg.loss_chunk and inputs.shape[1] % cfg.loss_chunk == 0:
        loss = _chunked_nll(x, embed, targets, mask, cfg.loss_chunk)
    else:
        loss = _token_nll(torch.einsum("bsd,vd->bsv", x, embed), targets,
                          mask)
    return loss + cfg.aux_loss_weight * aux
