"""Mixture-of-experts with dense (einsum) dispatch, the GShard/Switch
pattern: the port of `ray_tpu/ops/moe.py`.

Plain tensor code, as the JAX package's is (it computes these products
outside Pallas). Gradients reach the router only through its softmax
probabilities: through each choice's gate into `combine`, and through the
mean probability into the load-balancing loss. The choices, positions and
one-hots carry none.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows of `idx` over `n` classes, all zero where idx
    lies outside [0, n), as `jax.nn.one_hot` gives them
    (`F.one_hot` raises there)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).float()


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] router outputs -> (dispatch [T, E, C] of 0/1, combine
    [T, E, C], aux_loss float32 scalar), float32.

    Each token takes k experts by rounds of argmax over the probabilities
    not yet taken (the first index on ties, as JAX's argmax); an expert's C
    slots fill in token order, round after round, so the capacity is
    shared across the k choices, and a choice past it is dropped. A kept
    choice's combine weight is its probability over the sum of the token's
    kept probabilities. aux is the Switch Transformer's load-balancing loss
    E sum_e density_e density_proxy_e, density from the top-1 choice."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)

    top1 = torch.argmax(probs, dim=-1)
    density = _one_hot(top1, e).mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = e * (density * density_proxy).sum()

    remaining = probs
    # Per-expert fill across the k choices, so capacity is shared.
    fill = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    gates, masks = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                   # [T]
        mask = _one_hot(idx, e)                                 # [T, E]
        gate = (probs * mask).sum(dim=-1)                       # [T]
        # Position of each token within its chosen expert's buffer
        # (integers, exact in float32 below 2^24 tokens).
        pos_in_expert = (torch.cumsum(mask, dim=0) - mask) + fill[None, :]
        pos = (pos_in_expert * mask).sum(dim=-1)                # [T]
        keep = (pos < capacity) & (gate > 0)
        pos_oh = _one_hot(pos.to(torch.int32), capacity)        # [T, C]
        sel = mask * keep[:, None]                              # [T, E]
        gates.append(gate * keep)
        masks.append(sel[:, :, None] * pos_oh[:, None, :])      # [T, E, C]
        fill = fill + sel.sum(dim=0).to(torch.int32)
        remaining = remaining * (1.0 - mask)

    dispatch = sum(masks)
    denom = sum(gates)
    denom = torch.where(denom > 0, denom, 1.0)
    combine = sum((gate / denom)[:, None, None] * m
                  for gate, m in zip(gates, masks))
    return dispatch, combine, aux_loss


def capacity(n_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: max(int(capacity_factor * n_tokens * top_k /
    num_experts), top_k), with Python's truncating `int`, as JAX's."""
    return max(int(capacity_factor * n_tokens * top_k / num_experts), top_k)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation (torch's own
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25,
            activation: Callable[[torch.Tensor], torch.Tensor] = gelu_tanh
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x [B, S, D]; router_w [D, E]; w1 [E, D, F];
    w2 [E, F, D]. Returns (y [B, S, D] in x's dtype, aux_loss float32).

    Each expert has `capacity(B S, E, top_k, capacity_factor)` slots. The
    router runs in float32 (tokens and weights upcast);
    dispatch, combine and the expert weights are cast to x's dtype before
    the dispatch, expert and combine products."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    t = b * s
    tokens = x.reshape(t, d)
    n_slots = capacity(t, e, top_k, capacity_factor)

    # JAX's einsums, written so that the batch-free ones (router, dispatch
    # "tec,td->ecd", combine "tec,ecd->td") are matrix products (`aten.mm`)
    # and the per-expert ones batched (`aten.bmm`): the split the "dots"
    # remat policy makes.
    logits = tokens.float() @ router_w.float()                  # [T, E]
    dispatch, combine, aux = top_k_gating(logits, top_k, n_slots)

    dispatch = dispatch.to(x.dtype).view(t, e * n_slots)
    combine = combine.to(x.dtype).view(t, e * n_slots)
    expert_in = (dispatch.t() @ tokens).view(e, n_slots, d)     # [E, C, D]
    h = activation(torch.bmm(expert_in, w1.to(x.dtype)))        # [E, C, F]
    expert_out = torch.bmm(h, w2.to(x.dtype))                   # [E, C, D]
    y = combine @ expert_out.view(e * n_slots, d)               # [T, D]
    return y.view(b, s, d), aux
