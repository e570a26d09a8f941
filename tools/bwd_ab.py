#!/usr/bin/env python3
"""A/B of the attention backward kernels (K2: dK, dV; K3: dQ), bf16 and
float32, on one CUDA card: another source of `flash_attn_bwd.cu` (BASE)
against the tree's, in one process.

    python3 tools/bwd_ab.py BASE.cu [--launches 60] [--repeats 3]
                            [--dtype bfloat16|float32]
                                              # from the repository root

BASE is built with the tree's nvcc flags (and `kernels/csrc` on the include
path, so it may include `hopper.cuh`) into the kernels' build directory
and called through the same C entry points. For each case (bf16: the
train step's shape, D 64, a ragged S 384 and peaked rows with q, k scaled
by 4; float32: the serving width contiguous and as QKV views, a peaked row
and a ragged S 384; heads of 256: the D-256 train step's shape, a peaked
row and the float32 serving width; `--dtype` keeps one type's cases) and
each side it prints the worst diff/tol of dQ, dK and dV under
`chip_smoke.py`'s gate (BWD_TOL, in bf16 plus the flip bound; above 1
fails), and how many of `--launches` further launches on the same inputs
differ bitwise from the first; then whether the two sides agree bitwise,
and each kernel's time over alternating runs (base, tree, tree, base,
...; CUDA events over 20 launches each) and the base's fastest over the
tree's, beside the plain versions' times and the backward of one
`scaled_dot_product_attention` call (the K2+K3 pair). A BASE that refuses
a case (an older source without D 256) is reported so and left out of
that case's timing. Exits 1 if the tree's side fails the gate or differs
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
    ((4, 1024, 12, 128), "bfloat16", "qkv", 4.0, 4),
    ((4, 1024, 12, 64), "bfloat16", "qkv", 4.0, 112),
    ((1, 1024, 12, 128), "float32", "contiguous", 1.0, 7),
    ((1, 1024, 12, 128), "float32", "qkv", 1.0, 7),
    ((4, 1024, 12, 128), "float32", "qkv", 4.0, 112),
    ((2, 384, 3, 128), "float32", "contiguous", 1.0, 5),
    ((16, 1024, 6, 256), "bfloat16", "qkv", 1.0, 7),
    ((4, 1024, 6, 256), "bfloat16", "qkv", 4.0, 112),
    ((1, 1024, 6, 256), "float32", "qkv", 1.0, 7),
]


def load_base(path: str) -> ctypes.CDLL:
    """BASE built like the tree's kernels, with the entry points'
    signatures declared."""
    digest = hashlib.sha256(open(path, "rb").read())
    for header in sorted(build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"ab_base-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC), "-o", str(out), path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"BASE does not build:\n{proc.stdout}"
                               f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    head = [i32, ptr, ptr, ptr, ptr, ptr, ptr]
    tail = [i32, i32, i32, i32, ptr, ptr, ptr, ctypes.c_float, ptr]
    lib.flash_attn_bwd_dkv.argtypes = head + [ptr, ptr] + tail
    lib.flash_attn_bwd_dq.argtypes = head + [ptr] + tail
    lib.flash_attn_bwd_dkv.restype = lib.flash_attn_bwd_dq.restype = i32
    return lib


def launch(lib, name, q, k, v, do, lse, di, *outs):
    b, s, h, d = q.shape
    err = getattr(lib, name)(
        flash_attn._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        *(t.data_ptr() for t in outs),
        b, s, h, d, flash_attn._strides(q), flash_attn._strides(k),
        flash_attn._strides(v), d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {err}")


def grads(lib, q, k, v, do, lse, di, outs):
    launch(lib, "flash_attn_bwd_dq", q, k, v, do, lse, di, outs[0])
    launch(lib, "flash_attn_bwd_dkv", q, k, v, do, lse, di, outs[1],
           outs[2])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("base", help="another flash_attn_bwd.cu")
    parser.add_argument("--launches", type=int, default=60)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        help="only this type's cases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    libs = {"base": load_base(args.base),
            "tree": flash_attn._bwd_library()}
    ok = True
    for shape, dtype, layout, qk, seed in CASES:
        if args.dtype not in (None, dtype):
            continue
        dt = getattr(torch, dtype)
        b, s, h, d = shape
        gen = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
        qkv[:, :, :2] *= qk
        q, k, v = qkv.to(dt).unbind(2)
        if layout == "contiguous":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        do = torch.randn(shape, generator=gen, device="cuda").to(dt)
        o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        di = flash_attn.attention_di(o, do)
        tag = f"{dtype} {list(shape)} {layout} q,k x{qk:g} seed {seed}"
        first, sides = {}, dict(libs)
        for side, lib in libs.items():
            outs = [torch.empty_like(do) for _ in range(3)]
            try:
                grads(lib, q, k, v, do, lse, di, outs)
            except RuntimeError as e:
                if side == "tree":
                    raise
                print(f"{tag} {side}: refuses the case ({e})", flush=True)
                del sides[side]
                continue
            torch.cuda.synchronize()
            errs = cs.bwd_errors(q, k, v, do, lse, di, *outs)
            again = [torch.empty_like(do) for _ in range(3)]
            differ = 0
            for _ in range(args.launches):
                grads(lib, q, k, v, do, lse, di, again)
                differ += not all(torch.equal(x, y)
                                  for x, y in zip(again, outs))
            torch.cuda.synchronize()
            first[side] = outs
            worst = max(e[1] for e in errs.values())
            if side == "tree":
                ok = ok and worst <= 1 and differ == 0
            print(f"{tag} {side}: worst diff/tol "
                  + ", ".join(f"{n} {e[1]:.3f}" for n, e in errs.items())
                  + f"; {differ} of {args.launches} launches differ",
                  flush=True)
        if "base" in first:
            same = all(torch.equal(x, y)
                       for x, y in zip(first["base"], first["tree"]))
            print(f"   base and tree bitwise-equal: {same}", flush=True)
        times = {(side, kn): [] for side in sides for kn in ("dkv", "dq")}
        outs = [torch.empty_like(do) for _ in range(3)]
        for i in range(2 * args.repeats):
            order = ("base", "tree") if i % 2 == 0 else ("tree", "base")
            for side in (x for x in order if x in sides):
                lib = sides[side]
                times[(side, "dkv")].append(cs.cuda_ms(
                    lambda: launch(lib, "flash_attn_bwd_dkv", q, k, v, do,
                                   lse, di, outs[1], outs[2]), 20))
                times[(side, "dq")].append(cs.cuda_ms(
                    lambda: launch(lib, "flash_attn_bwd_dq", q, k, v, do,
                                   lse, di, outs[0]), 20))
        bounds = cs.bwd_bounds(shape, dtype, 0.0)
        plain = {
            "dkv": cs.cuda_ms(lambda: flash_attn.flash_attn_bwd_dkv_plain(
                q, k, v, do, lse, di), 3, warmup=1),
            "dq": cs.cuda_ms(lambda: flash_attn.flash_attn_bwd_dq_plain(
                q, k, v, do, lse, di), 3, warmup=1)}
        torch.cuda.empty_cache()
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa = cs.cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
        del out, qt, kt, vt
        for kn in ("dkv", "dq"):
            line = "; ".join(
                f"{side} " + " ".join(f"{t:.4f}" for t in times[(side, kn)])
                for side in sides)
            speedup = ""
            if "base" in sides:
                ratio = (min(times[("base", kn)])
                         / min(times[("tree", kn)]))
                speedup = f"; base over tree (fastest of each) {ratio:.3f}"
            print(f"   {kn} ms: {line}; bound {bounds[kn][0]:.4f}; plain "
                  f"{plain[kn]:.4f}{speedup}", flush=True)
        print(f"   SDPA backward (K2+K3 pair) ms {sdpa:.4f}", flush=True)
        del q, k, v, do, o, lse, di, qkv, first, outs
        torch.cuda.empty_cache()
    print("tree OK" if ok else "tree FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
