#!/usr/bin/env python3
"""A compiled graph's `"device"` edge across cards: the float32 flagship
forward as a two-stage pipeline of actors on the port's cluster runtime,
each leasing its own card, in an NCCL `util.collective` group of 2, the
hidden state moving head -> tail over NCCL send/recv; against the same
pipeline with an `"array"` edge (host bytes through the RPC plane).

    python3 tools/cgraph_nccl.py [--ranks 2] [--device cuda|cpu]

The head holds the embedding and layers 0-5, the tail layers 6-11, the
final norm and the tied-embedding logits, from which it gives each
position's log-probability of the next token and the last position's
logits; both make the weights from seed 0 (chip_smoke.py's flagship)
and keep their half. BATCHES batches of [4, 512] token ids (numpy seed)
go through the `"array"` graph, then the `"device"` graph, each after
one warm-up execution. One JSON line: whether the `"device"` edge's
outputs are bitwise the `"array"` edge's, the route the head's edge
resolved (group, its rank, the tail's), and each edge's ms a batch and
MB/s of hidden state (12.58 MB a batch at the flagship width), with the
card's name and power limit. `--device cpu` rehearses over gloo with a
narrow model on CPU actors. Exits non-zero if the outputs differ, the
edge took no collective route, or the run misses its deadline.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DEADLINE_S = 600
BATCHES, BATCH, SEQ = 16, 4, 512
IN_FLIGHT = 4
GROUP = "cgraph_tool"
FLAGSHIP = dict(vocab_size=32768, d_model=1536, n_layers=12, n_heads=12,
                d_ff=6144, max_seq_len=1024)
NARROW = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=1, d_ff=128,
              max_seq_len=512)


class Stage:
    """One half of the model on this process's device (its leased card's
    cuda:0, or the CPU)."""

    def __init__(self, half: str, widths: dict, device: str):
        from dataclasses import replace

        import torch

        from ray_tpu_torch.models import TransformerConfig, init_params

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        cfg = TransformerConfig(dtype=torch.bfloat16, **widths)
        params = init_params(
            cfg, torch.Generator(device=self.device).manual_seed(0),
            device=self.device)
        self.cfg = replace(cfg, dtype=torch.float32)
        split = widths["n_layers"] // 2
        self.embed, self.ln_f = params["embed"], params["ln_f"]
        self.layers = (params["layers"][:split] if half == "head"
                       else params["layers"][split:])

    def join(self, world: int, rank: int, backend: str) -> dict:
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, backend, group_name=GROUP)
        return {"rank": col.get_rank(GROUP),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def leave(self) -> bool:
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group(GROUP)
        return True

    def routes(self) -> list:
        """The collective routes this process's `"device"` edges took."""
        from ray_tpu_torch.cgraph import channel

        return [list(c._route) for c in list(channel._registry.values())
                if c.kind == "device" and c._route is not None]

    def hidden(self, tokens):
        import numpy as np
        import torch

        from ray_tpu_torch.models.transformer import (_check_ids, _embed,
                                                      _layers)

        with torch.no_grad():
            t = _check_ids(torch.from_numpy(np.array(tokens, np.int64)),
                           self.cfg).to(self.device)
            return _layers(_embed(self.embed, t, self.cfg), self.layers,
                           self.cfg, None)[0]

    def score(self, hidden, tokens):
        import numpy as np
        import torch

        from ray_tpu_torch.models.transformer import _layers, _rmsnorm

        with torch.no_grad():
            x = _layers(hidden, self.layers, self.cfg, None)[0]
            logits = torch.einsum("bsd,vd->bsv", _rmsnorm(x, self.ln_f),
                                  self.embed.to(self.cfg.dtype))
            t = torch.from_numpy(np.array(tokens, np.int64)).to(
                logits.device)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            return (logp.gather(-1, t[:, 1:, None])[..., 0].contiguous(),
                    logits[:, -1].contiguous())


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def run_edge(ray, head, tail, kind: str, batches) -> tuple:
    """(outputs, seconds for the batches) through a compiled graph whose
    hidden edge is `kind`, after one warm-up execution."""
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        dag = tail.score.bind(head.hidden.bind(inp).with_channel(kind), inp)
    compiled = dag.experimental_compile(max_in_flight=IN_FLIGHT)
    try:
        ray.get(compiled.execute(batches[0]), timeout=DEADLINE_S)
        t0 = time.perf_counter()
        refs = [compiled.execute(b) for b in batches]
        outs = [ray.get(r, timeout=DEADLINE_S) for r in refs]
        return outs, time.perf_counter() - t0
    finally:
        compiled.teardown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.ranks != 2:
        print("the pipeline has two stages: --ranks 2", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    import ray_tpu_torch

    if args.device == "cuda":
        if torch.cuda.device_count() < 2:
            print(f"NCCL takes one rank a card: 2 stages need 2 cards, this "
                  f"machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        backend, widths = "nccl", FLAGSHIP
        ray_tpu_torch.init(num_cpus=4)
        opts = {"num_cpus": 1, "num_gpus": 1}
    else:
        backend, widths = "gloo", NARROW
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        opts = {"num_cpus": 1}
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, widths["vocab_size"], (BATCH, SEQ),
                            dtype=np.int64) for _ in range(BATCHES)]
    try:
        cls = ray_tpu_torch.remote(**opts)(Stage)
        head = cls.remote("head", widths, args.device)
        tail = cls.remote("tail", widths, args.device)
        t0 = time.perf_counter()
        setup = ray_tpu_torch.get(
            [head.join.remote(2, 0, backend), tail.join.remote(2, 1, backend)],
            timeout=DEADLINE_S)
        setup_s = time.perf_counter() - t0
        push, push_s = run_edge(ray_tpu_torch, head, tail, "array", batches)
        p2p, p2p_s = run_edge(ray_tpu_torch, head, tail, "device", batches)
        routes = ray_tpu_torch.get(head.routes.remote(), timeout=60)
        ray_tpu_torch.get([head.leave.remote(), tail.leave.remote()],
                          timeout=60)
    finally:
        ray_tpu_torch.shutdown()
    bitwise = [all(torch.equal(x, y) for x, y in zip(a, b))
               for a, b in zip(p2p, push)]
    hidden_b = BATCH * SEQ * widths["d_model"] * 4
    edge = {}
    for kind, secs in (("array", push_s), ("device", p2p_s)):
        edge[kind] = {"ms_a_batch": secs / BATCHES * 1e3,
                      "hidden_MBps": hidden_b * BATCHES / secs / 1e6}
    print(json.dumps({
        "backend": backend, "ranks": 2, "setup": setup,
        "setup_s": round(setup_s, 4), "widths": widths,
        "batches": BATCHES, "batch": [BATCH, SEQ],
        "hidden_bytes": hidden_b, "device_edge_route": routes,
        "bitwise_equal": sum(bitwise), "edges": edge,
        "device_over_array": push_s / p2p_s, "card": smi()}), flush=True)
    return 0 if all(bitwise) and routes == [[GROUP, 0, 1]] else 1


if __name__ == "__main__":
    sys.exit(main())
