"""Rotary position embeddings (RoPE): each head splits into halves (not
interleaved pairs), with float32 cos/sin tables."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotary_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, [max_len, head_dim // 2] float32 each."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)
    return torch.cos(ang), torch.sin(ang)


def rotary_rows(cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor):
    """Table rows for `positions`, clamped to the table's last row. Padding
    positions can run past `max_len` (a prefill bucket or a cached-prefill
    tail padded to a power of two); JAX clamps such gathers, and an
    unclamped index is a device-side assert on a card."""
    idx = positions.clamp(0, cos.shape[0] - 1)
    return cos[idx], sin[idx]


def rotate_halves(x: torch.Tensor, c: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """`x` [..., D] with `c`/`s` broadcastable to [..., D/2]; the result is
    cast back to x's dtype (the tables promote it to float32)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [S] global indices (default arange)."""
    if positions is None:
        positions = torch.arange(x.shape[-3], device=x.device)
    c, s = rotary_rows(cos, sin, positions)
    return rotate_halves(x, c[:, None, :], s[:, None, :])
