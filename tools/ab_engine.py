#!/usr/bin/env python3
"""A/B of the serving engine between two checkouts of the repository on one
CUDA card: `chip_smoke.py`'s engine phase (flagship float32 weights, paged
decode, 8 requests) from each checkout in turn, one process a run.

    python3 tools/ab_engine.py BASE_DIR CHANGE_DIR [--pairs 10] [--log FILE]

Runs go base, change, change, base, ... (each pair in the opposite order to
the one before), so drift over the call weighs on both sides alike. Each
run prints the engine phase's metrics; the summary gives each metric's
median and quartiles for each side and the median of the paired
differences (change minus base). A run that fails its checks ends the A/B
with a non-zero exit.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

# One run: the checkout's own chip_smoke.py and ray_tpu_torch, its kernels
# built (cached in its _build/), then the engine phase alone.
RUN = '''
import sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
import ray_tpu_torch
assert ray_tpu_torch.__file__.startswith({tree!r}), ray_tpu_torch.__file__
from ray_tpu_torch.kernels import build
from ray_tpu_torch.models import TransformerConfig, init_params
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
cfg = TransformerConfig(dtype=torch.float32, **cs.FLAGSHIP)
params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
cs.phase_engine(params, cfg, {label!r})
'''
METRICS = ("tokens_per_s", "ttft_p50_ms", "prefill_s", "decode_s")


def parse(line: str) -> dict:
    out = {}
    for key in METRICS:
        m = re.search(rf"{key} ([0-9.]+)", line)
        if m is None:
            raise ValueError(f"no {key} in: {line}")
        out[key] = float(m.group(1))
    return out


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--log", default=None,
                    help="file for every run's full output")
    args = ap.parse_args()
    trees = {"base": os.path.abspath(args.base),
             "change": os.path.abspath(args.change)}
    order = []
    for i in range(args.pairs):
        order += ["base", "change"] if i % 2 == 0 else ["change", "base"]
    runs = {"base": [], "change": []}
    log = open(args.log, "w") if args.log else None
    try:
        for n, side in enumerate(order):
            proc = subprocess.run(
                [sys.executable, "-c",
                 RUN.format(tree=trees[side], label=side)],
                cwd=trees[side], capture_output=True, text=True)
            if log:
                log.write(f"== run {n} {side} rc={proc.returncode}\n"
                          f"{proc.stdout}{proc.stderr[-3000:]}\n")
                log.flush()
            lines = [x for x in proc.stdout.splitlines()
                     if x.startswith("engine flagship")]
            if proc.returncode or not lines:
                print(f"run {n} {side} failed (rc {proc.returncode}):\n"
                      f"{proc.stderr[-2000:]}", flush=True)
                return 1
            m = parse(lines[0])
            runs[side].append(m)
            print(f"run {n:2d} {side:6s} " + " ".join(
                f"{k} {m[k]:g}" for k in METRICS), flush=True)
    finally:
        if log:
            log.close()
    pairs = list(zip(runs["base"], runs["change"]))
    for key in METRICS:
        parts = []
        for side in ("base", "change"):
            q1, q2, q3 = quartiles([m[key] for m in runs[side]])
            parts.append(f"{side} median {q2:g} (quartiles {q1:g}, {q3:g})")
        diff = statistics.median(c[key] - b[key] for b, c in pairs)
        print(f"{key}: " + "; ".join(parts)
              + f"; median paired change - base {diff:g} over "
                f"{len(pairs)} pairs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
