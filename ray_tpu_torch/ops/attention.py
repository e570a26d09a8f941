"""Attention: the plain softmax version, the dispatch to the causal
flash-attention kernel, and ring attention over the sequence axis.

The dispatch is `ray_tpu/ops/attention.py`'s rule: causal attention over
standard positions with a flash-eligible shape, on no mesh or a mesh whose
axes are all 1, goes to the kernels (`kernels/flash_attn.py`); a mesh with
sp > 1 goes to ring attention; everything else to `plain_attention`.
Eligibility is the JAX rule on the shape, cut to what the kernels take:
their head dims, float32 or bfloat16 (other dtypes take plain attention, as
JAX off the TPU does), and their layout (a view that fails it goes to the
kernels as a contiguous copy). The kernels' wrappers decide by the tensors'
device (CUDA launches the kernels, CPU runs their plain versions), so the
CPU tests walk the same dispatch as the card.

Ring attention: each ``sp`` rank holds one sequence block of Q/K/V; the K/V
blocks travel around the ring (`ppermute`) while a float32 online softmax
accumulates the output, so attention over S costs O(S/P) memory a rank.
Each K/V block's global positions travel with it, so the same body serves
`ring_attention` (DTensors on a mesh) and a caller already inside a manual
region (`ring_attention_manual`, a pipeline stage). Plain PyTorch, as the
JAX package computes it outside Pallas.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed import ProcessGroup
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.kernels.flash_attn import (_DTYPE_CODE, HEAD_DIMS,
                                              flash_attn_bwd, flash_attn_fwd)
from ray_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute
from ray_tpu_torch.parallel.spmd import from_local, to_local

_NEG_INF = -1e30


@torch.library.custom_op("ray_tpu_torch::flash_attn_fwd", mutates_args=())
def _flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with its row logsumexp, as one operator of the dispatcher, so a
    selective-checkpoint policy (`models/transformer.py`) can name it and
    keep its outputs: a ctypes launch is invisible to the dispatcher."""
    return flash_attn_fwd(q, k, v, return_lse=True)


FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_attn_fwd.default


class _FlashAttention(torch.autograd.Function):
    """Forward: K1 (through `FLASH_FWD_OP`), saving q, k, v, o and the row
    logsumexp. Backward: di, then K2 (dK, dV), then K3 (dQ), as the TPU
    kernel's custom VJP runs them."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = FLASH_FWD_OP(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attn_bwd(q, k, v, o, do.contiguous(), lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention, q/k/v [B, S, H, D] -> [B, S, H, D] in q's
    dtype, differentiable. The counterpart of
    `ray_tpu.ops.attention.flash_attention_tpu`: f32 scores, online
    softmax, probabilities cast to v's dtype before P.V, f32
    accumulation; its backward rounds p and ds where the TPU kernel's
    does. A call that needs no gradient (the serving engine's) launches K1
    alone, without the logsumexp or the autograd function."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attn_fwd(q, k, v)[0]


def _flash_eligible(q: torch.Tensor) -> bool:
    """The JAX rule (a sequence that tiles by 128 and a lane-aligned
    head_dim: a multiple of 128, or 64) cut to the head dims the kernels
    take, `HEAD_DIMS`; other head dims go to plain attention."""
    s, d = q.shape[1], q.shape[3]
    return (d % 128 == 0 or d == 64) and d in HEAD_DIMS and s % 128 == 0


def _kernel_layout(t: torch.Tensor) -> bool:
    """`check_inputs`' layout rule: a contiguous last dimension, the other
    strides multiples of 16 bytes, a 16-byte-aligned base."""
    per_16_bytes = 16 // t.element_size()
    return (t.stride(3) == 1
            and all(t.stride(i) % per_16_bytes == 0 for i in range(3))
            and t.data_ptr() % 16 == 0)


def _kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Optional[Tuple[torch.Tensor, ...]]:
    """q, k, v as the kernels take them, beside `_flash_eligible`'s shape
    rule: None unless all three are float32 or all bfloat16; a tensor whose
    layout the kernels refuse becomes a fresh contiguous copy (a new
    allocation, so its base is aligned too), which gives the same
    result."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return None
    return tuple(t if _kernel_layout(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Softmax attention. q/k/v: [B, S, H, D]; positions: [S] global indices
    for the causal mask (defaults to arange). Scores in float32, masked
    with -1e30, probabilities cast to v's dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        idx = (torch.arange(q.shape[1], device=q.device)
               if positions is None else positions)
        mask = idx[:, None] >= idx[None, :]
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def ring_attention_manual(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, q_pos: torch.Tensor, *,
                          group: ProcessGroup, causal: bool = True
                          ) -> torch.Tensor:
    """The ring body, on this rank's blocks inside a manual region: q/k/v
    [B, S_loc, H, D]; q_pos [S_loc] the block's global positions; `group`
    the sequence axis's ranks, block i on rank i. Scores and the online
    softmax in float32 (-1e30 masked, the row sum clamped at 1e-20); the
    output in q's dtype."""
    n = axis_size(group)
    b, s_loc, h, d = q.shape
    scale = d ** -0.5
    perm = [(j, (j + 1) % n) for j in range(n)]
    qf = q.float()
    o = q.new_zeros((b, h, s_loc, d), dtype=torch.float32)
    l = q.new_zeros((b, h, s_loc), dtype=torch.float32)
    m = q.new_full((b, h, s_loc), _NEG_INF, dtype=torch.float32)
    k_blk, v_blk, kv_pos = k, v, q_pos
    for step in range(n):
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
            scores = scores.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))           # [B,H,Q]
        p = torch.exp(scores - m_new[..., None])                # [B,H,Q,K]
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        m = m_new
        if step + 1 < n:    # the last rotation's blocks would go unused
            k_blk = ppermute(k_blk, group, perm)
            v_blk = ppermute(v_blk, group, perm)
            kv_pos = ppermute(kv_pos, group, perm)
    out = o / l.clamp(min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)                     # [B,S,H,D]


def _block_placements(t: DTensor, mesh, axis_name: str):
    """t's placements with the sequence dim (1) over `axis_name` alone;
    batch (0) and head (2) shards kept, anything else replicated: the
    layout the ring body takes."""
    names = mesh.mesh_dim_names
    return tuple(Shard(1) if names[i] == axis_name
                 else p if p in (Shard(0), Shard(2)) else Replicate()
                 for i, p in enumerate(t.placements))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp", causal: bool = True,
                   positions: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Sequence-parallel attention over `mesh`'s `axis_name`: q/k/v
    [B, S, H, D] DTensors on `mesh`, moved to sequence blocks over
    `axis_name` (batch and head shards kept); positions [S] global
    (default arange). Returns a DTensor in that layout."""
    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("ring_attention takes q, k, v as DTensors on the "
                        "mesh; inside a manual region use "
                        "ring_attention_manual")
    place = _block_placements(q, mesh, axis_name)
    ql, kl, vl = (to_local(t, place) for t in (q, k, v))
    group = mesh.get_group(axis_name)
    s_loc = ql.shape[1]
    if positions is None:
        positions = torch.arange(q.shape[1], device=ql.device)
    q_pos = positions[axis_index(group) * s_loc:][:s_loc]
    return from_local(ring_attention_manual(ql, kl, vl, q_pos, group=group,
                                            causal=causal),
                      mesh, place, q.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, mesh=None, sp_axis: str = "sp",
              positions: Optional[torch.Tensor] = None,
              manual_sp: bool = False) -> torch.Tensor:
    """Dispatch, as JAX's:
    - `manual_sp=True`: q/k/v are this rank's sequence blocks inside a
      manual region over `mesh`'s `sp_axis` (a pipeline stage, the sharded
      model); run the ring body, with the block's global positions taken
      from the rank when `positions` is None (a local arange would give a
      silently wrong causal mask).
    - a mesh with `sp_axis` > 1: `ring_attention`.
    - no mesh, or a mesh whose axes are all 1 (unsharded): the flash
      kernels for causal attention over standard positions at an eligible
      shape and dtype, else plain attention.
    - any other mesh: plain attention (batch and head shards stay local).
    DTensor inputs come back as DTensors in the layout computed."""
    if manual_sp:
        group = mesh.get_group(sp_axis)
        if positions is None:
            s_loc = q.shape[1]
            positions = axis_index(group) * s_loc + torch.arange(
                s_loc, device=q.device)
        return ring_attention_manual(q, k, v, positions, group=group,
                                     causal=causal)
    if mesh is not None and mesh.size(
            mesh.mesh_dim_names.index(sp_axis)) > 1:
        return ring_attention(q, k, v, mesh=mesh, axis_name=sp_axis,
                              causal=causal, positions=positions)
    unsharded = mesh is None or all(n == 1 for n in mesh.shape)

    def attend(q, k, v):
        # positions=None means standard arange: what the kernels' causal
        # mask implements.
        if unsharded and positions is None and causal and _flash_eligible(q):
            operands = _kernel_operands(q, k, v)
            if operands is not None:
                return flash_attention(*operands)
        return plain_attention(q, k, v, causal=causal, positions=positions)

    if not isinstance(q, DTensor):
        # Plain tensors: the whole, or this rank's batch/head block.
        return attend(q, k, v)
    # DTensors: every axis of an unsharded mesh is 1, so the local blocks
    # are the whole; on another mesh the sequence and head_dim stay whole
    # and each rank attends over its batch and head block.
    place = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                  for p in q.placements)
    ql, kl, vl = (to_local(t, place) for t in (q, k, v))
    return from_local(attend(ql, kl, vl), mesh, place, q.shape)
