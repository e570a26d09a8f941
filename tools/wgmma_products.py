#!/usr/bin/env python3
"""The wgmma products of the bf16 attention kernels, one at a time, on one
CUDA card (`tools/wgmma_products.cu` over the helpers of
`ray_tpu_torch/kernels/csrc/hopper.cuh`).

    python3 tools/wgmma_products.py        # from the repository root

1. Each product alone on one 64-row tile, D 64, 128 and 256, against a
   float32 matmul of the same bf16 inputs: A B^T with both operands
   K-major from TMA-loaded, 128-byte swizzled shared memory (S = Q K^T,
   dP = dO V^T); round(P) X with P as register A fragments in the
   accumulator layout and X read transposed (O += P V, dV += P^T dO, dK
   += dS^T Q, dQ += dS K), at D 128 and 256 also as one m64n128k16 per
   k-step and pair of slabs (`gemm_ax_wide`: the forward's O += P V, the
   D 256 backward's sums). Fails (exit 1) if one errs by more than 1e-3.
2. The float32 accumulation error of A B^T over [1024, D] bf16 inputs
   when each 64 x 64 tile sums its D / 16 k-steps as chains of P k-steps
   added in float32, against float64, beside torch's float32 matmul and
   a sequential float32 FMA over D.
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


def load() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "wgmma_products.so"
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
         os.path.join(ROOT, "tools", "wgmma_products.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgmma_abt.argtypes = [ptr, ptr, ptr, i32]
    lib.wgmma_ax.argtypes = [ptr, ptr, ptr, i32]
    lib.wgmma_ax_wide.argtypes = [ptr, ptr, ptr, i32]
    lib.wgmma_chains.argtypes = [ptr, ptr, ptr, i32, i32]
    for fn in (lib.wgmma_abt, lib.wgmma_ax, lib.wgmma_ax_wide,
               lib.wgmma_chains):
        fn.restype = i32
    return lib


def error_stats(x, exact):
    e = x.double() - exact
    return (f"max abs {e.abs().max().item():.3e}, mean abs "
            f"{e.abs().mean().item():.3e}, mean {e.mean().item():+.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("wgmma_products: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for d in (64, 128, 256):
        a, b, x = (torch.randn(64, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        p = torch.randn(64, 64, generator=gen, device="cuda")
        c = torch.zeros(64, 64, device="cuda")
        rc = lib.wgmma_abt(a.data_ptr(), b.data_ptr(), c.data_ptr(), d)
        err = (c - a.float() @ b.float().T).abs().max().item()
        print(f"A B^T, D {d}: rc {rc}, max abs error {err:.3e}", flush=True)
        ok = ok and rc == 0 and err <= 1e-3
        c = torch.zeros(64, d, device="cuda")
        rc = lib.wgmma_ax(p.data_ptr(), x.data_ptr(), c.data_ptr(), d)
        err = (c - p.bfloat16().float() @ x.float()).abs().max().item()
        print(f"round(P) X, D {d}: rc {rc}, max abs error {err:.3e}",
              flush=True)
        ok = ok and rc == 0 and err <= 1e-3
        if d >= 128:
            c = torch.zeros(64, d, device="cuda")
            rc = lib.wgmma_ax_wide(p.data_ptr(), x.data_ptr(), c.data_ptr(),
                                   d)
            err = (c - p.bfloat16().float() @ x.float()).abs().max().item()
            print(f"round(P) X at N 128, D {d}: rc {rc}, max abs error "
                  f"{err:.3e}", flush=True)
            ok = ok and rc == 0 and err <= 1e-3
    for d, chains in ((256, (16, 8, 4)), (128, (8, 4, 1)), (64, (4, 2, 1))):
        a, b = (torch.randn(1024, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        exact = a.double() @ b.double().T
        fma = torch.zeros(1024, 1024, device="cuda")
        for i in range(d):
            fma = torch.addcmul(fma, a[:, i:i + 1].float(),
                                b[:, i].float()[None, :])
        print(f"D {d}: torch float32 matmul "
              f"{error_stats(a.float() @ b.float().T, exact)}", flush=True)
        print(f"D {d}: sequential float32 FMA {error_stats(fma, exact)}",
              flush=True)
        for chain in chains:
            c = torch.zeros(1024, 1024, device="cuda")
            rc = lib.wgmma_chains(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  d, chain)
            ok = ok and rc == 0
            print(f"D {d}: wgmma, {d // 16 // chain} chain(s) of {chain} "
                  f"k-steps {error_stats(c, exact)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
