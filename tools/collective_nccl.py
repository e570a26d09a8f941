#!/usr/bin/env python3
"""`ray_tpu_torch.util.collective` across cards: a group of N actors on the
port's cluster runtime, one card leased by each, over NCCL, each op held
to its numpy result.

    python3 tools/collective_nccl.py [--ranks 4] [--device cuda|cpu]

`--device cpu` runs the same ops over gloo on N CPU actors (the rehearsal
of a call on the cards, where NCCL, which takes one rank a card, needs N
cards). Rank r contributes float32 `r + 1 + arange(8)`; the ops are
allreduce (sum, max, min, product), allgather, broadcast from the last
rank, reducescatter, reduce to rank 0, barrier, and a send/recv from rank
0 to rank 1 on each card (CUDA tensors in and out), then the same
allreduce on a 64 MiB tensor, BIG_CALLS times, each timed between two
barriers. One JSON line: each op's agreement with numpy (exact: the values
are small integers), the big allreduce's median, fastest and slowest
seconds (a call's time is its slowest member's) and the median's bus rate,
and the card's name and power limit. With `--nccl-debug DIR`, NCCL logs
its setup into DIR (NCCL_DEBUG=INFO) and the line adds the transports its
channels took ("P2P/CUMEM", "SHM", ...). Exits non-zero if an op disagrees
or the run does not finish within its deadline.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DEADLINE_S = 600
BIG_ELEMENTS = 16 << 20         # float32: 64 MiB
BIG_CALLS = 20


class Member:
    """One group member: its device (the leased card's cuda:0, or the
    CPU) and the ops' results as lists."""

    def __init__(self, rank: int, world: int, backend: str):
        import torch

        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device("cuda", 0) if backend == "nccl" \
            else torch.device("cpu")

    def setup(self) -> dict:
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(self.world, self.rank, self.backend,
                                  group_name="tool")
        return {"rank": col.get_rank("tool"),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def ops(self) -> dict:
        import torch

        from ray_tpu_torch.util import collective as col

        x = (torch.arange(8, dtype=torch.float32, device=self.device)
             + self.rank + 1)
        out = {}
        for op in ("sum", "max", "min", "product"):
            out[f"allreduce_{op}"] = col.allreduce(
                x, group_name="tool", op=op).tolist()
        out["allgather"] = [t.tolist() for t in
                            col.allgather(x, group_name="tool")]
        out["broadcast"] = col.broadcast(
            x, src_rank=self.world - 1, group_name="tool").tolist()
        out["reducescatter"] = col.reducescatter(
            x, group_name="tool").tolist()
        red = col.reduce(x, dst_rank=0, group_name="tool")
        out["reduce"] = red.tolist() if self.rank == 0 else None
        col.barrier(group_name="tool")
        if self.rank == 0:
            col.send(x * 10, dst_rank=1, group_name="tool")
            out["recv"] = None
        elif self.rank == 1:
            out["recv"] = col.recv(torch.zeros_like(x), src_rank=0,
                                   group_name="tool").tolist()
        else:
            out["recv"] = None
        out["device"] = str(x.device)
        big = torch.ones(BIG_ELEMENTS, device=self.device)
        col.allreduce(big, group_name="tool")          # warm-up
        out["big_s"], out["big_ok"] = [], True
        for _ in range(BIG_CALLS):
            col.barrier(group_name="tool")
            t0 = time.perf_counter()
            got = col.allreduce(big, group_name="tool")
            out["big_s"].append(time.perf_counter() - t0)
            out["big_ok"] &= bool((got == self.world).all())
        col.destroy_collective_group("tool")
        return out


def expected(world: int) -> dict:
    import numpy as np

    xs = [np.arange(8, dtype=np.float32) + r + 1 for r in range(world)]
    total = np.sum(xs, axis=0)
    chunk = 8 // world
    return {"allreduce_sum": total.tolist(),
            "allreduce_max": np.max(xs, axis=0).tolist(),
            "allreduce_min": np.min(xs, axis=0).tolist(),
            "allreduce_product": np.prod(xs, axis=0).tolist(),
            "allgather": [x.tolist() for x in xs],
            "broadcast": xs[-1].tolist(),
            "reducescatter": [total[r * chunk:(r + 1) * chunk].tolist()
                              for r in range(world)],
            "reduce": total.tolist(),
            "recv": (xs[0] * 10).tolist()}


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def nccl_transports(log_dir: str) -> dict:
    """{transport: channels} over the members' NCCL logs, from lines such
    as "Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read"."""
    counts: dict = {}
    for path in glob.glob(os.path.join(log_dir, "nccl.*.log")):
        with open(path, errors="replace") as f:
            for line in f:
                m = re.search(r"Channel .* via (\S+)", line)
                if m:
                    counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nccl-debug", metavar="DIR",
                    help="have NCCL log its setup into DIR")
    args = ap.parse_args()
    world = args.ranks
    if 8 % world:
        print("--ranks must divide 8", file=sys.stderr)
        return 2
    backend = "nccl" if args.device == "cuda" else "gloo"
    if args.nccl_debug:
        os.makedirs(args.nccl_debug, exist_ok=True)
        # The members inherit these: the workers' environment is the
        # driver's.
        os.environ.update(
            NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,P2P,SHM,NET",
            NCCL_DEBUG_FILE=os.path.join(os.path.abspath(args.nccl_debug),
                                         "nccl.%h.%p.log"))

    import ray_tpu_torch

    if backend == "nccl":
        import torch

        if torch.cuda.device_count() < world:
            print(f"NCCL takes one rank a card: {world} ranks need {world} "
                  f"cards, this machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        ray_tpu_torch.init(num_cpus=world + 2)
        opts = {"num_cpus": 1, "num_gpus": 1}
    else:
        ray_tpu_torch.init(num_cpus=world + 2, num_gpus=0)
        opts = {"num_cpus": 1}
    try:
        cls = ray_tpu_torch.remote(**opts)(Member)
        members = [cls.remote(r, world, backend) for r in range(world)]
        t0 = time.perf_counter()
        setup = ray_tpu_torch.get([m.setup.remote() for m in members],
                                  timeout=DEADLINE_S)
        init_s = time.perf_counter() - t0
        outs = ray_tpu_torch.get([m.ops.remote() for m in members],
                                 timeout=DEADLINE_S)
    finally:
        ray_tpu_torch.shutdown()
    want = expected(world)
    agree = {}
    for key, value in want.items():
        if key == "reducescatter":
            got = [o[key] for o in outs]
        elif key in ("reduce", "recv"):
            got = outs[0 if key == "reduce" else 1][key]
        else:
            got = [o[key] for o in outs]
            value = [value] * world
        agree[key] = got == value
    agree["big_allreduce"] = all(o["big_ok"] for o in outs)
    calls = [max(o["big_s"][i] for o in outs) for i in range(BIG_CALLS)]
    big_s = statistics.median(calls)
    nbytes = BIG_ELEMENTS * 4
    # A ring all-reduce moves 2 (N - 1) / N of the tensor through each
    # member's link: NCCL's "bus bandwidth".
    bus = nbytes * 2 * (world - 1) / world / big_s if world > 1 else None
    print(json.dumps({
        "backend": backend, "ranks": world, "setup": setup,
        "devices": sorted({o["device"] for o in outs}),
        "init_s": round(init_s, 4), "agree": agree,
        "big_allreduce_bytes": nbytes, "big_allreduce_calls": BIG_CALLS,
        "big_allreduce_s": big_s, "big_allreduce_min_s": min(calls),
        "big_allreduce_max_s": max(calls), "bus_bytes_per_s": bus,
        "nccl_transports": (nccl_transports(args.nccl_debug)
                            if args.nccl_debug else None),
        "card": smi()}), flush=True)
    return 0 if all(agree.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
