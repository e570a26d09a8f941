"""Attention: the plain softmax version and the dispatch to the causal
flash-attention kernel.

The dispatch rule is `ray_tpu/ops/attention.py`'s single-device half: causal
attention over standard positions with a flash-eligible shape goes to the
kernels (`kernels/flash_attn.py`), everything else to `plain_attention`.
Eligibility is the JAX rule on the shape, cut to what the kernels take:
their head dims, float32 or bfloat16 (other dtypes take plain attention, as
JAX off the TPU does), and their layout (a view that fails it goes to the
kernels as a contiguous copy). The kernels' wrappers decide by the tensors'
device (CUDA launches the kernels, CPU runs their plain versions), so the
CPU tests walk the same dispatch as the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.kernels.flash_attn import (_DTYPE_CODE, HEAD_DIMS,
                                              flash_attn_bwd, flash_attn_fwd)

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, mesh=None,
              positions: Optional[torch.Tensor] = None,
              manual_sp: bool = False) -> torch.Tensor:
    """Single-device dispatch: the flash kernel for causal attention over
    standard (arange) positions at an eligible shape and dtype, else plain
    attention. Sequence-parallel ring attention (`manual_sp`, or a mesh)
    is not ported yet (ROADMAP.md, "Parallel layer")."""
    if manual_sp or mesh is not None:
        raise NotImplementedError(
            "ring/sequence-parallel attention is not ported yet; see "
            "ROADMAP.md, 'Parallel layer'")
    if positions is None and causal and _flash_eligible(q):
        operands = _kernel_operands(q, k, v)
        if operands is not None:
            return flash_attention(*operands)
    return plain_attention(q, k, v, causal=causal, positions=positions)
