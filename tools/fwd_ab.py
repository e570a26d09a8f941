#!/usr/bin/env python3
"""A/B of the attention forward kernel (K1, both routes) on one CUDA card:
another source of `flash_attn_fwd.cu` (BASE) against the tree's, in one
process.

    python3 tools/fwd_ab.py BASE.cu [--launches 60] [--repeats 3]
                                    [--dtype bfloat16|float32] [--wide]
                                              # from the repository root

BASE is built with the tree's nvcc flags (and `kernels/csrc` on the include
path, so it may include `hopper.cuh`) into the kernels' build directory and
called through the same C entry point; ptxas's register and spill lines
of both builds are printed. For each case (bf16: the train
step's shape, D 64 at it, a ragged S 384, a peaked row with q, k scaled by
4; float32: the engine's prefill buckets S 128-1024; heads of 256: the
D-256 train step's shape, a peaked row and the float32 serving width;
heads wider than 256: `chip_smoke.WIDE_SHAPES`, the D-slice kernels' rows
of chip_smoke's K1 phase on the same inputs, which `--wide` runs alone) and
each side it prints the worst diff/tol of o under `chip_smoke.py`'s K1
gate (KERNEL_TOL, plus the flip bound in bf16; above 1 fails) with the
lse error, and how many of `--launches` further launches on the same
inputs differ bitwise from the first; then whether the two sides agree
bitwise, and each side's time over alternating runs (base, tree, tree,
base, ...; CUDA events over 20 launches each) beside the bound, the plain
version's time and `scaled_dot_product_attention`'s. A BASE that refuses a
case (an older source without D 256) is reported so and left out of that
case's timing. Exits 1 if the tree's side fails the gate or differs
between launches.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.kernels import build, flash_attn  # noqa: E402

# (shape [B, S, H, D], dtype, layout, factor on q and k, seed)
CASES = [
    ((16, 1024, 12, 128), "bfloat16", "qkv", 1.0, 7),
    ((16, 1024, 12, 64), "bfloat16", "qkv", 1.0, 7),
    ((2, 384, 3, 128), "bfloat16", "contiguous", 1.0, 5),
    ((4, 1024, 12, 128), "bfloat16", "qkv", 4.0, 112),
    ((1, 1024, 12, 128), "float32", "contiguous", 1.0, 3),
    ((1, 512, 12, 128), "float32", "contiguous", 1.0, 2),
    ((1, 256, 12, 128), "float32", "contiguous", 1.0, 1),
    ((1, 128, 12, 128), "float32", "contiguous", 1.0, 0),
    ((16, 1024, 6, 256), "bfloat16", "qkv", 1.0, 7),
    ((4, 1024, 6, 256), "bfloat16", "qkv", 4.0, 112),
    ((1, 1024, 6, 256), "float32", "qkv", 1.0, 3),
] + [
    # chip_smoke's D-slice K1 rows, each with the seed chip_smoke draws its
    # inputs from (its place among KERNEL_SHAPES).
    (shape, dtype, layout, qk,
     cs.KERNEL_SHAPES.index((shape, dtype, layout, qk)))
    for shape, dtype, layout, qk in cs.WIDE_SHAPES
]


def load_base(path: str) -> ctypes.CDLL:
    """BASE built like the tree's kernels, with the entry point's signature
    declared."""
    digest = hashlib.sha256(open(path, "rb").read())
    for header in sorted(build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"fwd_ab_base-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC), "-o", str(out), path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"BASE does not build:\n{proc.stdout}"
                               f"{proc.stderr}")
        print_ptxas("base", proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                   i32, i32, ptr, ptr, ptr, ctypes.c_float,
                                   ptr]
    lib.flash_attn_fwd.restype = i32
    return lib


def print_ptxas(side: str, log: str) -> None:
    """ptxas's register and spill lines, one per kernel instantiation."""
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {side}: {line.strip()}", flush=True)


def launch(lib, q, k, v, o, lse):
    b, s, h, d = q.shape
    err = lib.flash_attn_fwd(
        flash_attn._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, s, h, d,
        flash_attn._strides(q), flash_attn._strides(k),
        flash_attn._strides(v), d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: {err}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("base", help="another flash_attn_fwd.cu")
    parser.add_argument("--launches", type=int, default=60)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        help="run only the cases of this type")
    parser.add_argument("--wide", action="store_true",
                        help="run only the cases of heads wider than 256 "
                             "(the D-slice kernels)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    libs = {"base": load_base(args.base), "tree": flash_attn._library()}
    print_ptxas("tree", build.build_log.get("flash_attn_fwd", {})
                .get("log", ""))
    ok = True
    for shape, dtype, layout, qk, seed in CASES:
        if args.dtype not in (None, dtype) or (args.wide and
                                               shape[3] <= 256):
            continue
        b, s, h, d = shape
        q, k, v = cs.kernel_inputs(shape, dtype, layout, qk, seed)
        tag = f"{dtype} {list(shape)} {layout} q,k x{qk:g} seed {seed}"

        def outputs():
            return (torch.empty((b, s, h, d), dtype=q.dtype, device="cuda"),
                    torch.empty((b, h, s), device="cuda"))

        first, sides = {}, dict(libs)
        for side, lib in libs.items():
            o, lse = outputs()
            try:
                launch(lib, q, k, v, o, lse)
            except RuntimeError as e:
                if side == "tree":
                    raise
                print(f"{tag} {side}: refuses the case ({e})", flush=True)
                del sides[side]
                continue
            torch.cuda.synchronize()
            _, worst, _, lse_err = cs.fwd_errors(q, k, v, o, lse)
            o2, lse2 = outputs()
            differ = 0
            for _ in range(args.launches):
                launch(lib, q, k, v, o2, lse2)
                differ += not (torch.equal(o, o2) and torch.equal(lse, lse2))
            torch.cuda.synchronize()
            first[side] = (o, lse)
            if side == "tree":
                ok = ok and worst <= 1 and lse_err <= 1e-3 and differ == 0
            print(f"{tag} {side}: worst diff/tol {worst:.3f}, lse_err "
                  f"{lse_err:.3e}; {differ} of {args.launches} launches "
                  f"differ", flush=True)
        if "base" in first:
            same = all(torch.equal(x, y)
                       for x, y in zip(first["base"], first["tree"]))
            print(f"   base and tree bitwise-equal: {same}", flush=True)
        times = {side: [] for side in sides}
        o, lse = outputs()
        for i in range(2 * args.repeats):
            order = ("base", "tree") if i % 2 == 0 else ("tree", "base")
            for side in (x for x in order if x in sides):
                lib = sides[side]
                times[side].append(cs.cuda_ms(
                    lambda: launch(lib, q, k, v, o, lse), 20))
        plain = cs.cuda_ms(lambda: flash_attn.flash_attn_fwd_plain(q, k, v),
                           5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        bound, _, bound_by = cs.attention_bound(shape, dtype, 0.0)
        flops = cs.attention_flops(shape)
        print("   ms: " + "; ".join(
            f"{side} " + " ".join(f"{t:.4f}" for t in ts) + " (best "
            f"{flops / min(ts) / 1e9:.1f} TFLOP/s)"
            for side, ts in times.items())
            + f"; bound {bound:.4f} ({bound_by}); plain {plain:.4f}; "
            f"SDPA {sdpa:.4f}", flush=True)
        del q, k, v, o, lse, first
        torch.cuda.empty_cache()
    print("tree OK" if ok else "tree FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
