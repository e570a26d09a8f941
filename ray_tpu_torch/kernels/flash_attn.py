"""Wrapper of the causal flash-attention forward kernel
(`csrc/flash_attn_fwd.cu`), the port of K1, the forward of the Pallas TPU
kernel behind `ray_tpu.ops.attention.flash_attention_tpu`, and its plain
PyTorch version.

`flash_attn_fwd` checks its inputs, then launches the kernel for CUDA
tensors or runs `flash_attn_fwd_plain` for CPU tensors. There is no other
path: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.kernels import build

# Kernel launches since the counter was last set to 0 (plain-version calls
# on the CPU do not count).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# Keys per tile of the kernel's online softmax (kBlockK in the source): the
# running max, and so the scale at which p is rounded, moves per tile.
BLOCK_K = 64
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (two threads
    racing here declare the same signatures on the same library)."""
    global _lib
    if _lib is None:
        lib = build.library("flash_attn_fwd")
        ptr = ctypes.c_void_p
        lib.flash_attn_fwd.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ptr, ptr, ptr, ctypes.c_float, ptr]
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: q, k, v of one shape [B, S, H, D], one dtype
    (float32 or bfloat16) and one device; D in (64, 128); S a multiple of
    128; the last dimension contiguous and the other strides multiples of
    4 elements on a 16-byte-aligned base, so every row loads as whole
    16-byte (f32) or 8-byte (bf16) vectors."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    b, s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {_HEAD_DIMS}")
    if s == 0 or s % 128:
        raise ValueError(f"sequence length {s} is not a positive multiple "
                         f"of 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(t.stride(i) % 4 for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dimension, strides that "
                f"are multiples of 4 and a 16-byte-aligned base; got "
                f"strides {t.stride()}")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   return_lse: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal attention, q/k/v [B, S, H, D] -> (o [B, S, H, D] in q's
    dtype, row logsumexp [B, H, S] float32 or None)."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    return _launch(q, k, v, return_lse)


def _launch(q, k, v, return_lse):
    global launches
    lib = _library()
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)

    def strides(t):
        return (ctypes.c_int64 * 3)(t.stride(0), t.stride(1), t.stride(2))

    qs, ks, vs = strides(q), strides(k), strides(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            b, s, h, d, ctypes.cast(qs, ctypes.c_void_p),
            ctypes.cast(ks, ctypes.c_void_p),
            ctypes.cast(vs, ctypes.c_void_p), d ** -0.5, stream)
    if err:
        raise RuntimeError("flash_attn_fwd launch failed: "
                           + lib.flash_attn_error_string(err).decode())
    launches += 1
    return o, lse


def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, return_lse: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch: float32 scores scaled by
    D^-1/2, the causal mask key <= query, and the online softmax's
    rounding: over tiles of BLOCK_K keys, p = exp(score - running max up to
    its tile) is cast to v's dtype before P.V (as K1 casts p), while the
    row sum l takes p unrounded; P.V is accumulated in float32, divided by
    l and written in q's dtype, contiguous. In float32 the cast is exact
    and this is softmax(scores) V."""
    b, s, h, _ = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    tiles = scores.view(b, h, s, s // BLOCK_K, BLOCK_K)
    # Running max per tile; key 0 is never masked, so every tile's is finite.
    m = torch.cummax(tiles.amax(-1), dim=-1).values          # [b, h, q, t]
    p = torch.exp(tiles - m[..., None])
    rescale = torch.exp(m - m[..., -1:])[..., None]          # to the last max
    l = (p * rescale).sum((-2, -1))                          # [b, h, q]
    probs = (p.to(v.dtype).float() * rescale).view(b, h, s, s)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    o = o / l.transpose(1, 2)[..., None]
    lse = m[..., -1] + torch.log(l) if return_lse else None
    return o.to(q.dtype).contiguous(), lse
