#!/usr/bin/env python3
"""Build and run `tools/dsmem_bench.cu` on one CUDA card: what a hand-off
through distributed shared memory costs (st.async and bulk copies, ring
and broadcast, clusters of 2-8 blocks), the measurement behind the
D-slice K1 kernels' design (PERF.md §6).

    python3 tools/dsmem_bench.py            # from the repository root

Prints the card's name and power limit, then one line a case.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ray_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    import chip_smoke

    print(chip_smoke.smi(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = build.BUILD_DIR / "dsmem_bench"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [build.nvcc(), *flags, "-I", str(build.CSRC), "-o", str(exe),
         os.path.join(ROOT, "tools", "dsmem_bench.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
