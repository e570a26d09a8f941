#!/usr/bin/env python3
"""Mutation check of `chip_smoke.py`'s bf16 gradient gate, on one CUDA card.

    python3 tools/grad_gate_mutation.py      # from the repository root

For each mutation (none, dK x 1.02, dQ x 1.02) it copies the port and
`chip_smoke.py` into a temporary directory outside the checkout, edits the
copy's flash-attention backward (`ops/attention.py`) to scale that
gradient, and runs the copy's gradient phase (`phase_grad`: the gate at
full depth and at GRAD_GATE_LAYERS) in a process of its own on the
flagship weights. Prints one line a mutation: whether the gate passed or
the PhaseError it raised. The gate holds when the unmutated copy passes
and every mutated one fails. The checkout is not written (a kernel build
found in it is copied along, so the copies do not rebuild).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALL = "        return flash_attn_bwd(q, k, v, o, do.contiguous(), lse)\n"
MUTATIONS = {
    "none": None,
    "dK x 1.02": "(g[0], g[1] * 1.02, g[2])",
    "dQ x 1.02": "(g[0] * 1.02, g[1], g[2])",
}
CHILD = """
import dataclasses, sys, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
params, cfg = cs.flagship_params()
cfg = dataclasses.replace(cfg, remat=True, remat_policy="save_attn_qkv")
try:
    cs.phase_grad(params, cfg, cs.smi())
    print("GATE passes")
except cs.PhaseError as e:
    print(f"GATE fails: {e}")
"""


def run(label: str, grads) -> str:
    with tempfile.TemporaryDirectory(prefix="grad_gate_mutation_") as tmp:
        shutil.copytree(os.path.join(ROOT, "ray_tpu_torch"),
                        os.path.join(tmp, "ray_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
        path = os.path.join(tmp, "ray_tpu_torch", "ops", "attention.py")
        with open(path) as f:
            src = f.read()
        if src.count(CALL) != 1:
            raise SystemExit("grad_gate_mutation: the flash backward call "
                             "in ops/attention.py moved; update CALL")
        if grads is not None:
            src = src.replace(CALL, CALL.replace(
                "return flash_attn_bwd(",
                f"return (lambda g: {grads})(flash_attn_bwd(").replace(
                    "lse)\n", "lse))\n"))
            with open(path, "w") as f:
                f.write(src)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp,
                              capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("GATE", "grad "))]
    for ln in lines:
        if ln.startswith("grad "):
            print(f"  {label}: {ln}", flush=True)
    verdict = next((ln for ln in lines if ln.startswith("GATE")),
                   f"no verdict (exit {proc.returncode}): "
                   f"{proc.stderr[-2000:]}")
    return verdict


def main() -> int:
    ok = True
    for label, grads in MUTATIONS.items():
        verdict = run(label, grads)
        print(f"mutation {label}: {verdict}", flush=True)
        want = "GATE passes" if grads is None else "GATE fails"
        ok = ok and verdict.startswith(want)
    print(f"grad gate mutation check: "
          f"{'holds' if ok else 'DOES NOT HOLD'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
