"""Attention: the plain softmax version and the dispatch to the causal
flash-attention kernel.

The dispatch rule is `ray_tpu/ops/attention.py`'s single-device half: causal
attention over standard positions with a flash-eligible shape goes to the
kernel (`kernels/flash_attn.py`), everything else to `plain_attention`.
Eligibility looks at the shape only; the kernel's wrapper decides by the
tensors' device (CUDA launches the kernel, CPU runs its plain version), so
the CPU tests walk the same dispatch as the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.kernels.flash_attn import flash_attn_fwd

_NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention, q/k/v [B, S, H, D] -> [B, S, H, D] in q's
    dtype. The counterpart of `ray_tpu.ops.attention.flash_attention_tpu`:
    f32 scores, online softmax, probabilities cast to v's dtype before
    P.V, f32 accumulation."""
    o, _ = flash_attn_fwd(q, k, v)
    return o


def _flash_eligible(q: torch.Tensor) -> bool:
    """The kernel's shape rule: a lane-aligned head_dim (a multiple of 128,
    or 64) and a sequence that tiles by 128."""
    s, d = q.shape[1], q.shape[3]
    return (d % 128 == 0 or d == 64) and s % 128 == 0


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
    standard (arange) positions at an eligible shape, else plain
    attention. Sequence-parallel ring attention (`manual_sp`, or a mesh)
    is not ported yet (ROADMAP.md, "Parallel layer")."""
    if manual_sp or mesh is not None:
        raise NotImplementedError(
            "ring/sequence-parallel attention is not ported yet; see "
            "ROADMAP.md, 'Parallel layer'")
    if positions is None and causal and _flash_eligible(q):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, causal=causal, positions=positions)
