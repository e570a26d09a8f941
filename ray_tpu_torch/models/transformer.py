"""Flagship decoder-only transformer LM in PyTorch: forward, loss, the
per-layer rematerialization policies, and the sharded and pipelined forms.

The port of `ray_tpu/models/transformer.py`: pre-norm RMSNorm blocks with a
fused QKV projection, rotary embeddings, causal attention through
`ops.attention.attention` (the flash kernels at eligible shapes), a
SiLU-gated FFN or, with `num_experts > 1`, a mixture of experts
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

Sharded (`mesh=`): the params are DTensors placed by `param_specs` (FSDP
over dp, Megatron over tp, experts over dp), the tokens a [B, S] batch
whose rows lie over dp. The model runs as one manual region on each rank's
blocks, as a JAX `shard_map` would: activations [B/dp, S/sp, D] and q, k, v
[B/dp, S/sp, H/tp, hd], the layouts JAX's sharding constraints ask for; a
dp-sharded weight is all-gathered inside its layer (again in the remat
recompute) and its gradient reduce-scattered; the attention and FFN
outputs are summed over tp; attention is the ring over sp when sp > 1,
the flash kernels on a mesh whose axes are all 1, plain attention
otherwise. `to_pipelined` and `forward_pipelined` run the layers as GPipe
stages over pp (`parallel/pipeline.py`) with explicit positions, so plain
attention or the ring there, never flash, as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import FLASH_FWD_OP, attention
from ray_tpu_torch.ops.moe import ExpertParallel, moe_ffn
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs
from ray_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                axis_size, psum)
from ray_tpu_torch.parallel.pipeline import gpipe
from ray_tpu_torch.parallel.spmd import (P, from_local, local_block,
                                         placements, to_local, tree_map)

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


def param_specs(cfg: TransformerConfig) -> Params:
    """Specs mirroring `init_params` (dp = FSDP, tp = Megatron; experts
    over dp), one dict per layer: the JAX package's, less the layer-stack
    dim."""
    layer = {"ln1": P(None), "wqkv": P("dp", None, "tp"),
             "wo": P("tp", "dp"), "ln2": P(None)}
    if cfg.is_moe:
        layer.update(router=P(None, None), moe_w1=P("dp", None, "tp"),
                     moe_w2=P("dp", "tp", None))
    else:
        layer.update(w13=P("dp", None, "tp"), w2=P("tp", "dp"))
    return {"embed": _EMBED_SPEC,
            "layers": [dict(layer) for _ in range(cfg.n_layers)],
            "ln_f": P(None)}


_EMBED_SPEC = P("tp", "dp")


# The expert leaves stay split over dp (each rank runs its experts); every
# other dp-sharded leaf is gathered whole over dp for its product (FSDP).
_EXPERT_KEYS = ("moe_w1", "moe_w2")


@dataclass(frozen=True)
class _Manual:
    """A rank's place in the sharded model's manual region: the mesh, the
    specs of one layer's leaves and of embed, whether attention runs the
    ring body over sp, and where an MoE call's tokens and experts lie."""

    mesh: Any
    specs: Dict[str, P]
    manual_sp: bool
    experts: ExpertParallel

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def weight(self, params: Params, key: str) -> torch.Tensor:
        """The leaf's block for its product: whole over dp (FSDP gather),
        except the experts; tp shards stay."""
        spec = self.specs[key]
        t = params[key]
        if key in _EXPERT_KEYS or "dp" not in spec:
            return t
        return all_gather(t, self.group("dp"), spec.index("dp"))

    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        return psum(t, self.group("tp"))


def _manual(mesh, cfg: TransformerConfig, in_pipeline: bool = False
            ) -> _Manual:
    """In a pipeline stage the region is manual over sp too: an MoE call
    then covers the sequence block alone, as JAX's stage body does."""
    sp = mesh.get_group("sp")
    dp = mesh.get_group("dp")
    specs = dict(param_specs(replace(cfg, n_layers=1))["layers"][0],
                 embed=_EMBED_SPEC)
    return _Manual(mesh, specs, axis_size(sp) > 1,
                   ExpertParallel(batch=dp, seq=None if in_pipeline else sp,
                                  experts=dp, hidden=mesh.get_group("tp")))


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
           attend: Attend, manual: Optional[_Manual] = None):
    """One block on x [B, S, D]: `rope` rotates q and k ([B, S, H, hd]),
    `attend(q, k, v)` returns the attention output [B, S, H, hd]. Returns
    (x, aux, k, v): aux is an MoE layer's load-balancing loss (float32
    scalar) and None for a dense layer; k and v let the serving engine
    cache the rotated keys and the values. With `manual`, x and lp are this
    rank's blocks (H and F its tp share)."""
    if manual is None:
        w, tp_sum = lp.__getitem__, (lambda t: t)
    else:
        w, tp_sum = functools.partial(manual.weight, lp), manual.tp_sum
    b, s, d = x.shape
    hd = cfg.head_dim
    act = x.dtype
    y = _rmsnorm(x, w("ln1")).reshape(b * s, d)
    wqkv = w("wqkv").to(act)
    h = wqkv.shape[-1] // hd
    wqkv = wqkv.reshape(d, 3 * h * hd)
    with checkpoint_name("qkv"):
        qkv = torch.mm(y, wqkv)
    qkv = qkv.view(b, s, 3, h, hd)
    q = rope(qkv[:, :, 0])
    k = rope(qkv[:, :, 1])
    v = qkv[:, :, 2]
    with checkpoint_name("attn_out"):
        o = attend(q, k, v)
    x = x + tp_sum(o.reshape(b, s, h * hd) @ w("wo").to(act))
    y = _rmsnorm(x, w("ln2"))
    if cfg.is_moe:
        ff, aux = moe_ffn(y, w("router"), w("moe_w1"), w("moe_w2"),
                          top_k=cfg.moe_top_k,
                          capacity_factor=cfg.capacity_factor,
                          shards=None if manual is None else manual.experts)
    else:
        w13 = w("w13").to(act)
        f = w13.shape[-1]
        gu = (y @ w13.reshape(d, -1)).view(b, s, 2, f)
        ff = tp_sum((F.silu(gu[:, :, 0]) * gu[:, :, 1]) @ w("w2").to(act))
        aux = None
    return x + ff, aux, k, v


def _embed(embed: torch.Tensor, tokens: torch.Tensor,
           cfg: TransformerConfig, manual: Optional[_Manual] = None
           ) -> torch.Tensor:
    """The rows of `tokens`, in `cfg.dtype`. With `manual`, embed is the
    rank's [V/tp, D/dp] block: gathered over dp, each tp rank looks up the
    ids in its vocabulary block and the blocks are summed over tp."""
    if manual is not None:
        embed = manual.weight({"embed": embed}, "embed")
        tp = manual.group("tp")
        if axis_size(tp) > 1:
            v_loc = embed.shape[0]
            ids = tokens - axis_index(tp) * v_loc
            hit = (ids >= 0) & (ids < v_loc)
            rows = embed[ids.clamp(0, v_loc - 1)] * hit[..., None]
            return psum(rows, tp).to(cfg.dtype)
    return embed[tokens].to(cfg.dtype)


def _layers(x: torch.Tensor, layers, cfg: TransformerConfig,
            positions: Optional[torch.Tensor],
            manual: Optional[_Manual] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over x [B, S, D] -> (x, summed aux). `positions`: the
    block's global positions, or None for arange (flash-eligible). With
    `manual` and sp > 1, x is a sequence block and attention the ring
    body."""
    cos, sin = rotary_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=x.device)
    rope_pos = positions
    if manual is not None and manual.manual_sp and positions is None:
        s_loc = x.shape[1]
        rope_pos = axis_index(manual.group("sp")) * s_loc + torch.arange(
            s_loc, device=x.device)

    def rope(t):
        return apply_rotary(t, cos, sin, rope_pos)

    def attend(q, k, v):
        if manual is None:
            return attention(q, k, v, causal=True, positions=positions)
        return attention(q, k, v, causal=True, mesh=manual.mesh,
                         positions=rope_pos if manual.manual_sp
                         else positions, manual_sp=manual.manual_sp)

    def block(x, lp):
        return _layer(x, lp, cfg, rope, attend, manual)[:2]

    if cfg.remat:
        block = _checkpoint_layer(block, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        x, layer_aux = block(x, lp)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def backbone(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
             positions: Optional[torch.Tensor] = None, *, mesh=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, D] in `cfg.dtype`, the
    layers' summed load-balancing loss, a float32 scalar: zero for a dense
    model). `positions=None` means arange and keeps the flash kernel
    eligible; explicit positions take the plain attention path. With
    `cfg.remat` each layer, its MoE routing included, is recomputed in
    the backward under `cfg.remat_policy`. With `mesh`, params are
    DTensors (`param_specs`) and tokens a DTensor or a tensor every rank
    holds whole; both results are DTensors."""
    if mesh is None:
        return _backbone(params, tokens, cfg, positions)
    rep = (Replicate(),) * mesh.ndim
    local, tokens, positions, manual = _enter(params, tokens, cfg, mesh,
                                              positions)
    x, aux = _backbone(local, tokens, cfg, positions, manual)
    place = placements(mesh, P("dp", "sp", None))
    return (from_local(x, mesh, place, torch.Size((*_global_bs(mesh, x),
                                                    x.shape[2]))),
            from_local(aux, mesh, rep, torch.Size(())))


def _backbone(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
              positions, manual: Optional[_Manual] = None):
    """`backbone` on the params' (local) blocks and the token block."""
    x = _embed(params["embed"], tokens, cfg, manual)
    x, aux = _layers(x, params["layers"], cfg, positions, manual)
    return _rmsnorm(x, params["ln_f"]), aux


def _global_bs(mesh, t: torch.Tensor) -> Tuple[int, int]:
    names = mesh.mesh_dim_names
    return (t.shape[0] * mesh.size(names.index("dp")),
            t.shape[1] * mesh.size(names.index("sp")))


def _rows(t, mesh) -> torch.Tensor:
    """This rank's rows (over dp) of a [B, ...] batch tensor, every other
    dim whole: from a DTensor, or from a tensor every rank holds whole."""
    place = placements(mesh, P("dp"))
    if isinstance(t, DTensor):
        return to_local(t, place)
    return local_block(torch.as_tensor(t), mesh, place)


def _seq_block(t: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block (over sp) of dim `dim`."""
    sp = mesh.get_group("sp")
    n = axis_size(sp)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"sequence {t.shape[dim]} does not divide over "
                         f"sp={n}")
    s_loc = t.shape[dim] // n
    return t.narrow(dim, axis_index(sp) * s_loc, s_loc)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _enter(params: Params, tokens, cfg: TransformerConfig, mesh,
           positions=None, whole_seq: bool = False):
    """Into the manual region: (the params' local blocks, this rank's
    token block [B/dp, S/sp] (all of S with `whole_seq`), its global
    positions or None, the rank's `_Manual`)."""
    local = tree_map(to_local, params)
    tokens = _token_rows(tokens, cfg, mesh)
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.long,
                                    device=tokens.device)
    if not whole_seq:
        tokens = _seq_block(tokens, mesh)
        if positions is not None:
            positions = _seq_block(positions, mesh, 0)
    return local, tokens, positions, _manual(mesh, cfg)


def _token_rows(tokens, cfg: TransformerConfig, mesh) -> torch.Tensor:
    """This rank's rows of a token batch, as longs on the mesh's device."""
    return _check_ids(_rows(tokens, mesh).to(_mesh_device(mesh), torch.long),
                      cfg)


def _check_ids(tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Ids outside the vocabulary raise here, before any gather on the
    card."""
    if tokens.numel() and not (0 <= int(tokens.min())
                               and int(tokens.max()) < cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
    return tokens


def _device_tokens(params: Params, tokens, cfg: TransformerConfig,
                   device: DeviceLike) -> torch.Tensor:
    """tokens as a long tensor on `device`, where the params must live;
    ids outside the vocabulary raise here, before any gather on the
    card."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, not "
                         f"on {dev}")
    return _check_ids(torch.as_tensor(tokens, dtype=torch.long, device=dev),
                      cfg)


def forward(params: Params, tokens, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            device: DeviceLike = None, *, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (ints) -> (logits [B, S, V] in `cfg.dtype`, through
    the tied embedding; the load-balancing loss, as `backbone` gives it).
    The params must already live on `device`. With `mesh` (the params
    DTensors placed by `param_specs`), the logits are a DTensor with rows
    over dp, sequence over sp and vocabulary over tp, and aux a replicated
    DTensor."""
    if mesh is not None:
        local, tokens, positions, manual = _enter(params, tokens, cfg, mesh,
                                                  positions)
        x, aux = _backbone(local, tokens, cfg, positions, manual)
        embed = manual.weight(local, "embed")
        logits = torch.einsum("bsd,vd->bsv", x, embed.to(cfg.dtype))
        return _leave_logits(logits, aux, mesh)
    tokens = _device_tokens(params, tokens, cfg, device)
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.long,
                                    device=tokens.device)
    x, aux = backbone(params, tokens, cfg, positions)
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype)), aux


def _leave_logits(logits: torch.Tensor, aux: torch.Tensor, mesh):
    """Local [B/dp, S/sp, V/tp] logits and a replicated aux as DTensors."""
    names = mesh.mesh_dim_names
    shape = torch.Size((*_global_bs(mesh, logits),
                        logits.shape[2] * mesh.size(names.index("tp"))))
    return (from_local(logits, mesh, placements(mesh, P("dp", "sp", "tp")),
                       shape),
            from_local(aux, mesh, (Replicate(),) * mesh.ndim,
                       torch.Size(())))


def _psum_over(t: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        t = psum(t, group)
    return t


def _token_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               groups=()) -> torch.Tensor:
    """Mean next-token NLL (over `mask`'s ones when given): the logsumexp
    upcasts the logits to float32 inside the reduction, and the target
    logit is gathered from the logits in their own dtype. With `groups`
    (inside a manual region), logits and targets are this rank's block of
    the tokens, which lie over the groups' ranks in equal blocks, and the
    mean is over all of them."""
    lse = torch.logsumexp(logits.float(), dim=-1)                # [B, S]
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    nll = lse - tgt.float()
    if mask is None:
        n = math.prod(axis_size(g) for g in groups)
        loss = nll.mean()
        return loss if n == 1 else _psum_over(loss, groups) / n
    return (_psum_over((nll * mask).sum(), groups)
            / _psum_over(mask.sum(), groups).clamp(min=1.0))


def _chunk_nll(x_c, embed, t_c, m_c, vocab_group=None):
    logits = torch.einsum("bcd,vd->bcv", x_c, embed)
    if vocab_group is not None:
        logits = all_gather(logits, vocab_group, 2)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, t_c[..., None])[..., 0]
    return ((lse - tgt.float()) * m_c).sum()


def _chunked_nll(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor], chunk: int, groups=(),
                 vocab_group=None) -> torch.Tensor:
    """`_token_nll` over tied embeddings, one sequence chunk at a time: each
    chunk's [B, chunk, V] logits are reduced at once and recomputed in the
    backward (checkpointed), so no [B, S, V] tensor is kept. `groups` as
    `_token_nll`'s; `vocab_group`: the ranks whose embed blocks make the
    vocabulary."""
    s = x.shape[1]
    m = (torch.ones(targets.shape, dtype=torch.float32, device=x.device)
         if mask is None else mask)
    total = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_nll, x[:, sl], embed,
                                   targets[:, sl], m[:, sl], vocab_group,
                                   use_reentrant=False)
    return (_psum_over(total, groups)
            / _psum_over(m.sum(), groups).clamp(min=1.0))


def _nll(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
         mask: Optional[torch.Tensor], cfg: TransformerConfig,
         manual: Optional[_Manual] = None, chunked: bool = True
         ) -> torch.Tensor:
    """The NLL of x's next tokens through the tied embedding (embed in
    `cfg.dtype`); with `manual`, x, targets and mask are this rank's blocks
    and embed its vocabulary block."""
    groups, vocab = (), None
    if manual is not None:
        groups = (manual.group("dp"), manual.group("sp"))
        tp = manual.group("tp")
        vocab = tp if axis_size(tp) > 1 else None
    if chunked and cfg.loss_chunk and x.shape[1] % cfg.loss_chunk == 0:
        return _chunked_nll(x, embed, targets, mask, cfg.loss_chunk, groups,
                            vocab)
    logits = torch.einsum("bsd,vd->bsv", x, embed)
    if vocab is not None:
        logits = all_gather(logits, vocab, 2)
    return _token_nll(logits, targets, mask, groups)


def _batch(batch: Dict[str, Any], tokens: torch.Tensor, mesh=None):
    """(inputs, targets, mask) of a batch whose [B, S+1] tokens are given
    on the right device; under a mesh each is this rank's block."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("mask")
    if mask is not None:
        mask = (_rows(mask, mesh) if mesh is not None
                else torch.as_tensor(mask))
        mask = mask.to(device=tokens.device, dtype=torch.float32)
    return inputs, targets, mask


def lm_loss(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            device: DeviceLike = None, *, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar); batch = {"tokens":
    [B, S+1] ints, optional "mask": [B, S]}, plus `cfg.aux_loss_weight`
    times the layers' load-balancing loss (zero for a dense model). The
    params must already live on `device`. With `mesh`, params are
    DTensors (`param_specs`), the batch's tensors DTensors with rows over
    dp (`batch_sharding`) or tensors every rank holds whole, and the loss a
    replicated DTensor."""
    if mesh is not None:
        local, tokens, _, manual = _enter(params, batch["tokens"], cfg, mesh,
                                          whole_seq=True)
        inputs, targets, mask = (
            None if t is None else _seq_block(t, mesh)
            for t in _batch(batch, tokens, mesh))
        x, aux = _backbone(local, inputs, cfg, None, manual)
        embed = manual.weight(local, "embed").to(cfg.dtype)
        loss = _nll(x, embed, targets, mask, cfg, manual)
        return from_local(loss + cfg.aux_loss_weight * aux, mesh,
                          (Replicate(),) * mesh.ndim, torch.Size(()))
    tokens = _device_tokens(params, batch["tokens"], cfg, device)
    inputs, targets, mask = _batch(batch, tokens)
    x, aux = backbone(params, inputs, cfg)
    loss = _nll(x, params["embed"].to(cfg.dtype), targets, mask, cfg)
    return loss + cfg.aux_loss_weight * aux


def to_pipelined(params: Params, n_stages: int) -> Params:
    """The per-layer list as stacked leaves [n_stages, L/n_stages, ...] for
    pipeline-parallel execution (leading dim sharded over ``pp``): stage s
    holds layers s L/n ... (s + 1) L/n - 1, as the JAX package's reshape
    of its [L, ...] leaves does."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} stages")
    stacked = {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}
    out = dict(params)
    out["layers"] = {k: a.reshape(n_stages, a.shape[0] // n_stages,
                                  *a.shape[1:])
                     for k, a in stacked.items()}
    return out


def pipelined_param_specs(cfg: TransformerConfig) -> Params:
    """Specs matching `to_pipelined` output: layer leaves gain leading
    ``pp`` and (unsharded) layer dims before the per-layer spec."""
    base = param_specs(replace(cfg, n_layers=1))
    base["layers"] = {k: P("pp", None, *s)
                      for k, s in base["layers"][0].items()}
    return base


def _pipelined(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
               mesh, num_microbatches: int):
    """forward_pipelined's body on this rank's token rows [B/dp, S] (on the
    mesh's device): (its final hidden states [B/dp, S/sp, D] after ln_f,
    aux, the local params, the rank's `_Manual`)."""
    layers = params["layers"]
    local = tree_map(to_local, {k: v for k, v in params.items()
                                if k != "layers"})
    manual = _manual(mesh, cfg, in_pipeline=True)
    x = _embed(local["embed"], tokens, cfg, manual)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    rope = rotary_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                        device=tokens.device)

    def stage_fn(stage_layers, x_mb, pos, consts):
        n = next(iter(stage_layers.values())).shape[0]
        per_layer = [{k: a[j] for k, a in stage_layers.items()}
                     for j in range(n)]
        cos, sin = consts

        def rope_fn(t):
            return apply_rotary(t, cos, sin, pos)

        def attend(q, k, v):
            return attention(q, k, v, causal=True, mesh=mesh, positions=pos,
                             manual_sp=manual.manual_sp)

        def block(x, lp):
            return _layer(x, lp, cfg, rope_fn, attend, manual)[:2]

        if cfg.remat:
            block = _checkpoint_layer(block, cfg.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        for lp in per_layer:
            x_mb, layer_aux = block(x_mb, lp)
            if layer_aux is not None:
                aux = aux + layer_aux
        return x_mb, aux

    y, aux = gpipe(stage_fn, layers, x, positions, rope, mesh=mesh,
                   num_microbatches=num_microbatches)
    return _rmsnorm(y, local["ln_f"]), aux, local, manual


def forward_pipelined(params: Params, tokens, cfg: TransformerConfig, mesh,
                      num_microbatches: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline-parallel forward: embed and head replicated over ``pp``,
    the layer stages through the GPipe schedule (`parallel/pipeline.py`),
    with the ring body in each stage when the mesh has sp > 1. params from
    `to_pipelined`, sharded by `pipelined_param_specs`. Explicit positions,
    as JAX's: plain attention or the ring, never the flash kernels.
    Returns logits and aux as `forward` under a mesh does."""
    x, aux, local, manual = _pipelined(params, _token_rows(tokens, cfg, mesh),
                                       cfg, mesh, num_microbatches)
    embed = manual.weight(local, "embed")
    logits = torch.einsum("bsd,vd->bsv", x, embed.to(cfg.dtype))
    return _leave_logits(logits, aux, mesh)


def lm_loss_pipelined(params: Params, batch: Dict[str, Any],
                      cfg: TransformerConfig, mesh,
                      num_microbatches: int = 2) -> torch.Tensor:
    """`lm_loss` through `forward_pipelined` (never in chunks, as JAX's)."""
    tokens = _token_rows(batch["tokens"], cfg, mesh)
    x, aux, local, manual = _pipelined(params, tokens[:, :-1], cfg, mesh,
                                       num_microbatches)
    _, targets, mask = (None if t is None else _seq_block(t, mesh)
                        for t in _batch(batch, tokens, mesh))
    embed = manual.weight(local, "embed").to(cfg.dtype)
    loss = _nll(x, embed, targets, mask, cfg, manual, chunked=False)
    return from_local(loss + cfg.aux_loss_weight * aux, mesh,
                      (Replicate(),) * mesh.ndim, torch.Size(()))
