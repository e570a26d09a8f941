"""Wrappers of the causal flash-attention kernels and their plain PyTorch
versions: the forward (`csrc/flash_attn_fwd.cu`, the port of K1) and the
backward (`csrc/flash_attn_bwd.cu`: dK/dV, the port of K2, and dQ, the port
of K3) of the Pallas TPU kernel behind
`ray_tpu.ops.attention.flash_attention_tpu`. Both sources run bf16 on the
tensor cores (TMA and wgmma) and float32 on the CUDA cores. The float32
backward sums q.k and dO.v by sequential FMAs, the plain version's order:
on the tensor cores as 3xTF32 (three TF32 passes) its error is 1.6-3x
float32 FMA's, which a peaked softmax (q and k x4) turns into a miss of
the float32 tolerance. The sources' header notes say more.

Each wrapper checks its inputs, then launches its kernel for CUDA tensors
or runs its plain version for CPU tensors. There is no other path: a CUDA
tensor a kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ray_tpu_torch.kernels import build

# Kernel launches since a counter was last set to 0 (plain-version calls
# on the CPU do not count): K1, K2 (dK/dV) and K3 (dQ).
launches = 0
dkv_launches = 0
dq_launches = 0
_count_lock = threading.Lock()


def _count_launch(counter: str) -> None:
    """Add one to the module-level count `counter`. Engines on several
    threads launch at once (a serving fleet), and `+=` on a module global
    is not atomic across threads."""
    with _count_lock:
        globals()[counter] += 1

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Head dims 64, 128 and 256 run kernels instantiated for each; wider ones
# (384, 512, 1024, ...) the D-slice kernels, where D is a runtime count of
# 128-column chunks and a block owns one chunk of the output's columns (in
# the forward, the blocks of a row block form a thread-block cluster that
# forms S once; the sources' header notes).
# Keys per tile of the kernel's online softmax (64-key tiles in both routes
# of the source, at every head dim): the running max, and so the scale at
# which p is rounded, moves per tile.
BLOCK_K = 64
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The forward kernel's library with its C signatures declared (two
    threads racing here declare the same signatures on the same
    library)."""
    global _lib
    if _lib is None:
        lib = build.library("flash_attn_fwd")
        ptr = ctypes.c_void_p
        lib.flash_attn_fwd.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ptr, ptr, ptr, ctypes.c_float, ptr]
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_fwd_dslice_info.argtypes = [ctypes.c_int,
                                                   ctypes.c_int, ptr]
        lib.flash_attn_fwd_dslice_info.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    """The backward kernels' library with its C signatures declared."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.library("flash_attn_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        head = [i32, ptr, ptr, ptr, ptr, ptr, ptr]     # dtype, q..di
        tail = [i32, i32, i32, i32, ptr, ptr, ptr, ctypes.c_float, ptr]
        lib.flash_attn_bwd_dkv.argtypes = head + [ptr, ptr] + tail
        lib.flash_attn_bwd_dkv.restype = i32
        lib.flash_attn_bwd_dq.argtypes = head + [ptr] + tail
        lib.flash_attn_bwd_dq.restype = i32
        lib.flash_attn_bwd_error_string.argtypes = [i32]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def kernel_head_dim(d: int) -> bool:
    """JAX's rule for the TPU kernel's head dim: 64, or a positive
    multiple of 128."""
    return d == 64 or (d > 0 and d % 128 == 0)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take: q, k, v of one shape [B, S, H, D], one dtype
    (float32 or bfloat16) and one device; D 64 or a multiple of 128
    (`kernel_head_dim`); S a multiple of 128; the last dimension
    contiguous and the other strides multiples of 16 bytes (4 float32 or
    8 bfloat16 elements) on a 16-byte-aligned base,
    so every row loads as whole 16-byte vectors and the bf16 backward's
    TMA tensor maps take the strides as they are. Contiguous tensors and
    views of a fused [B, S, 3, H, D] projection qualify."""
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
    if not kernel_head_dim(d):
        raise ValueError(f"head_dim {d} is neither 64 nor a multiple of 128")
    if s == 0 or s % 128:
        raise ValueError(f"sequence length {s} is not a positive multiple "
                         f"of 128")
    per_16_bytes = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 \
                or any(t.stride(i) % per_16_bytes for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dimension, strides that "
                f"are multiples of 16 bytes and a 16-byte-aligned base; "
                f"got strides {t.stride()} of {q.dtype}")


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


def dslice_info(dtype: torch.dtype, d: int) -> dict:
    """How K1's D-slice kernel of `dtype` runs at head dim `d` (above 256)
    on the current card: `cluster` blocks a cluster, `clusters_per_row_
    block`, `chunks_per_block` (128-column chunks of S a block forms),
    `smem_bytes` a block, and `max_active_clusters`
    (cudaOccupancyMaxActiveClusters)."""
    lib = _library()
    out = (ctypes.c_int * 5)()
    err = lib.flash_attn_fwd_dslice_info(_DTYPE_CODE[dtype], d, out)
    if err:
        raise RuntimeError("flash_attn_fwd_dslice_info failed: "
                           + lib.flash_attn_error_string(err).decode())
    return dict(zip(("cluster", "clusters_per_row_block",
                     "chunks_per_block", "smem_bytes",
                     "max_active_clusters"), out))


def _strides(t: torch.Tensor) -> ctypes.Array:
    """t's (batch, seq, head) strides as a C int64[3]; a `c_void_p`
    argument takes the array as its address."""
    return (ctypes.c_int64 * 3)(t.stride(0), t.stride(1), t.stride(2))


def _launch(q, k, v, return_lse):
    lib = _library()
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)

    qs, ks, vs = _strides(q), _strides(k), _strides(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            b, s, h, d, qs, ks, vs, d ** -0.5, stream)
    if err:
        raise RuntimeError("flash_attn_fwd launch failed: "
                           + lib.flash_attn_error_string(err).decode())
    _count_launch("launches")
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


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     di: torch.Tensor) -> None:
    """What the backward kernels take: q, k, v as `check_inputs` says; dO
    contiguous, of q's shape, dtype and device; lse (the forward's row
    logsumexp) and di (sum of o * dO over D) contiguous float32 [B, H, S]
    on that device."""
    check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(f"dO must be a contiguous {tuple(q.shape)} "
                         f"{q.dtype} tensor on {q.device}; got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(b, h, s)} tensor on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       di: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of causal flash attention, each [B, S, H, D] contiguous in
    q's dtype: K2 for CUDA tensors, `flash_attn_bwd_dkv_plain` for CPU
    ones."""
    check_bwd_inputs(q, k, v, do, lse, di)
    if q.device.type == "cpu":
        return flash_attn_bwd_dkv_plain(q, k, v, do, lse, di)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    dk, dv = torch.empty_like(do), torch.empty_like(do)
    _launch_bwd("flash_attn_bwd_dkv", q, k, v, do, lse, di, dk, dv)
    _count_launch("dkv_launches")
    return dk, dv


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      di: torch.Tensor) -> torch.Tensor:
    """dQ of causal flash attention, [B, S, H, D] contiguous in q's dtype:
    K3 for CUDA tensors, `flash_attn_bwd_dq_plain` for CPU ones."""
    check_bwd_inputs(q, k, v, do, lse, di)
    if q.device.type == "cpu":
        return flash_attn_bwd_dq_plain(q, k, v, do, lse, di)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    dq = torch.empty_like(do)
    _launch_bwd("flash_attn_bwd_dq", q, k, v, do, lse, di, dq)
    _count_launch("dq_launches")
    return dq


def _launch_bwd(fn_name, q, k, v, do, lse, di, *outs):
    lib = _bwd_library()
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            *(t.data_ptr() for t in outs), b, s, h, d, _strides(q),
            _strides(k), _strides(v), d ** -0.5, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           + lib.flash_attn_bwd_error_string(err).decode())


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum over D of o * dO in float32, [B, H, S] contiguous: the one
    reduction the TPU kernel's backward makes outside its kernels."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of causal flash attention from the forward's inputs,
    output and row logsumexp: di, then K2, then K3."""
    di = attention_di(o, do)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, di)
    return flash_attn_bwd_dq(q, k, v, do, lse, di), dk, dv


def _bwd_plain_terms(q, k, v, do, lse, di):
    """float32 [B, H, S, S] round(p) and round(ds) as the kernels make
    them: p = exp(q.k * D^-1/2 - lse) under key <= query, ds = p * (dO.v -
    di) * D^-1/2, each rounded to q's dtype (exact in float32).

    dO.v of bf16 inputs is evaluated in float64 and rounded once to
    float32: every product of two bf16 values is exact, so this is the
    function itself, and the kernels' tensor-core sums (chains of k-steps
    added in float32) are held to it rather than to a float32 GEMM's own
    summation order. That order matters where a peaked softmax makes dp -
    di cancel (p near 1 at one key): ds and dQ there are summation noise,
    and at D 256 a float32 GEMM's noise alone exceeds the bf16 gate's
    absolute tolerance (tools/bwd_peaked.py). float32 inputs keep the
    float32 GEMM, whose order the float32 kernels repeat."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(scores - lse[..., None]).masked_fill(~mask, 0.0)
    exact = torch.float32 if q.dtype == torch.float32 else torch.float64
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(exact), v.to(exact)).float()
    ds = p * (dp - di[..., None]) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_attn_bwd_dkv_plain(q, k, v, do, lse, di):
    """K2's function in plain PyTorch: dV = round(p)^T dO and dK =
    round(ds)^T q, accumulated in float32, in q's dtype, contiguous."""
    p, ds = _bwd_plain_terms(q, k, v, do, lse, di)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(q.dtype).contiguous(), dv.to(q.dtype).contiguous()


def flash_attn_bwd_dq_plain(q, k, v, do, lse, di):
    """K3's function in plain PyTorch: dQ = round(ds) k, accumulated in
    float32, in q's dtype, contiguous."""
    _, ds = _bwd_plain_terms(q, k, v, do, lse, di)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype).contiguous()


def flash_attn_bwd_plain(q, k, v, o, do, lse):
    """`flash_attn_bwd` with the kernels' plain versions, on any device."""
    di = attention_di(o, do)
    dk, dv = flash_attn_bwd_dkv_plain(q, k, v, do, lse, di)
    return flash_attn_bwd_dq_plain(q, k, v, do, lse, di), dk, dv
