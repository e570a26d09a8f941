#!/usr/bin/env python3
"""The numerics of float32 products on the tensor cores as 3xTF32, on one
CUDA card (`tools/tf32x3_products.cu` over the mma.sync m16n8k8 helpers of
`ray_tpu_torch/kernels/csrc/hopper.cuh`, which the float32 attention
backward kernels use).

    python3 tools/tf32x3_products.py        # from the repository root

For each case, 1024 independent tiles, each one warp's chain of products as
the kernels run it:
- A B^T, [16 x D] [64 x D]^T over D 64 and 128 (S = Q K^T, dP = dO V^T):
  normal operands, and operands x4 (the peaked-softmax rows, q and k x4);
- P X, [16 x 64] [64 x D], P from the accumulator layout with the permuted
  k (dV += P^T dO, dK += dS^T Q, dQ += dS K): P like p (exp(s - row max),
  in (0, 1]) and like ds (p times a normal draw times D^-1/2), X normal or
  x4.

Each method's error against float64 on the same float32 inputs: 3xTF32 (hi
+ lo split, three passes), one TF32 pass, a sequential float32 FMA over the
chain (the CUDA-core kernels' arithmetic) and torch's float32 matmul with
TF32 off. It prints the largest absolute error, the largest error over
sum |a b| of its dot product, and the worst error over chip_smoke.py's
float32 tolerance (BWD_TOL: 1e-4 + 1e-4 |exact|). The decision: 3xTF32's
worst error/tol must stay within a quarter (0.25) at every case; exits 1
if it does not, or if a launch fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.kernels import build  # noqa: E402

TILES = 1024
LIMIT = 0.25   # of BWD_TOL["float32"]


def load() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "tf32x3_products.so"
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
         os.path.join(ROOT, "tools", "tf32x3_products.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tf32x3_abt, lib.tf32x3_ax):
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32]
        fn.restype = i32
    return lib


def fma_chain(a, b, kind):
    """Sequential float32 FMA over the chain's k, as a CUDA-core kernel
    sums: A B^T ([T, 16, K] x [T, 64, K]) or P X ([T, 16, K] x [T, K, D])."""
    n = b.shape[1] if kind == "abt" else b.shape[2]
    acc = torch.zeros(a.shape[0], 16, n, device=a.device)
    for i in range(a.shape[2]):
        col = b[:, :, i] if kind == "abt" else b[:, i, :]
        acc = torch.addcmul(acc, a[:, :, i, None], col[:, None, :])
    return acc


def matmul(a, b, kind):
    return a @ (b.transpose(1, 2) if kind == "abt" else b)


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32x3_products: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    lib = load()
    atol, rtol = cs.BWD_TOL["float32"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = []
    for d in (64, 128):
        cases.append((f"A B^T D {d}, normal", "abt", d,
                      randn(TILES, 16, d), randn(TILES, 64, d)))
        cases.append((f"A B^T D {d}, x4", "abt", d,
                      4 * randn(TILES, 16, d), 4 * randn(TILES, 64, d)))
        s = 2 * randn(TILES, 16, 64)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        ds = p * randn(TILES, 16, 64) * d ** -0.5
        cases.append((f"P X D {d}, p-like P", "ax", d, p,
                      randn(TILES, 64, d)))
        cases.append((f"P X D {d}, ds-like P", "ax", d, ds,
                      randn(TILES, 64, d)))
        cases.append((f"P X D {d}, ds-like P, X x4", "ax", d, ds,
                      4 * randn(TILES, 64, d)))
    ok, worst_3x = True, 0.0
    for name, kind, d, a, b in cases:
        a, b = a.contiguous(), b.contiguous()
        exact = matmul(a.double(), b.double(), kind)
        mag = matmul(a.double().abs(), b.double().abs(), kind)
        got = {}
        for mode, label in ((0, "3xTF32"), (1, "1xTF32")):
            n = exact.shape[2]
            c = torch.empty(TILES, 16, n, device="cuda")
            fn = lib.tf32x3_abt if kind == "abt" else lib.tf32x3_ax
            rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), TILES, d,
                    mode)
            if rc:
                print(f"{name} {label}: launch failed ({rc})", flush=True)
                return 1
            got[label] = c
        got["float32 FMA"] = fma_chain(a, b, kind)
        got["torch float32 matmul"] = matmul(a, b, kind)
        stats = {}
        for label, x in got.items():
            err = (x.double() - exact).abs()
            stats[label] = (err.max().item(), (err / mag).max().item(),
                            (err / (atol + rtol * exact.abs())).max().item())
        worst_3x = max(worst_3x, stats["3xTF32"][2])
        ok = ok and stats["3xTF32"][2] <= LIMIT
        ratio = stats["3xTF32"][1] / stats["float32 FMA"][1]
        print(f"{name}: " + "; ".join(
            f"{label} max abs {e:.3e}, max err/sum|ab| {r:.3e}, worst "
            f"err/tol {t:.2e}" for label, (e, r, t) in stats.items())
            + f"; 3xTF32 over float32 FMA (err/sum|ab|) {ratio:.2f}",
            flush=True)
    print(f"decision: 3xTF32 worst err/tol {worst_3x:.3e} against the limit "
          f"{LIMIT} of BWD_TOL float32 ({atol:g}, {rtol:g}): "
          + ("tensor cores (3xTF32)" if ok else "CUDA cores"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
