#!/usr/bin/env python3
"""Where a serving fleet's decode time goes on one CUDA card: flagship
float32 engines (paged decode, 16-token blocks, 512 a pool), each on a
thread of its own as `ServeFleet` hosts them, decoding alone and three at
once.

    python3 tools/fleet_decode.py [--rows 4] [--new 32] [--interval 0.0002]

Cases, in turn, in one process, each after an untimed pass of its own:
- `one`: one engine serving `--rows` requests, each a 512-token prompt of
  its own plus a tail of 3-16 tokens, `--new` tokens each;
- `three`: three engines at once, `--rows` requests each;
- `three, interval I`: the same with the interpreter's thread switch
  interval (`sys.setswitchinterval`, 5 ms by default) at I: the longest a
  thread that wants the GIL back waits while another runs Python;
- `three processes`: three engines, each in a process of its own (spawn,
  each with its own copy of the weights and its own CUDA context),
  started together at a barrier.

Each case prints the engines' mean decode step (host clock around the
synchronized step, `stats()`), prefill seconds, tokens/s over the wall,
and, from a second pass under `torch.profiler`, the card's busy share
(the union of its activities' intervals over the pass's wall; not
measured across processes). Cases are compared within one call only.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHARED = 512


def _model_and_config():
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve.engine import (EngineConfig,
                                            TransformerEngineModel)

    cfg = TransformerConfig(dtype=torch.float32, **cs.FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    return (cfg, lambda: TransformerEngineModel(params, cfg),
            EngineConfig(max_batch_size=8, block_size=16, num_blocks=512))


def _requests(rng, vocab_size, rows):
    return [rng.integers(2, vocab_size, SHARED + int(n)).tolist()
            for n in rng.integers(3, 17, rows)]


def _process_engine(index, rows, new, barrier, results):
    """One engine in a process of its own: an untimed pass, then a timed
    one that starts at `barrier` with the other processes'."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.engine import InferenceEngine

    cfg, make_model, config = _model_and_config()
    rng = np.random.default_rng(100 + index)
    for timed in (False, True):
        eng = InferenceEngine(make_model(), config)
        eng.start()
        work = _requests(rng, cfg.vocab_size, rows)
        if timed:
            barrier.wait(timeout=300)
        t0 = time.perf_counter()
        streams = [eng.submit(r, new) for r in work]
        tokens = sum(len(list(s)) for s in streams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.stop()
    st = eng.stats()
    results.put((wall, tokens, st["steps"], st["decode_s"],
                 st["prefill_s"]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=4)
    p.add_argument("--new", type=int, default=32)
    p.add_argument("--interval", type=float, default=0.0002)
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from ray_tpu_torch.kernels import build
    from ray_tpu_torch.serve.engine import InferenceEngine

    if not torch.cuda.is_available():
        print("fleet_decode: no CUDA device", file=sys.stderr)
        return 1
    card = cs.smi()
    print(card, flush=True)
    build.build()
    cfg, make_model, config = _model_and_config()
    rng = np.random.default_rng(4)

    def requests():
        return _requests(rng, cfg.vocab_size, args.rows)

    def make(n_engines):
        return [InferenceEngine(make_model(), config)
                for _ in range(n_engines)]

    def serve(engines):
        """The engines at once, each on its own thread, on fresh prompts
        (no prefix shared between passes): (wall s, tokens, [stats])."""
        work = [requests() for _ in engines]
        outs = [None] * len(engines)

        def drive(i):
            streams = [engines[i].submit(r, args.new) for r in work[i]]
            outs[i] = [len(list(s)) for s in streams]

        for eng in engines:
            eng.start()
        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(len(engines))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for eng in engines:
            eng.stop()
        return wall, sum(map(sum, outs)), [e.stats() for e in engines]

    def busy_share(engines):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _, _ = serve(engines)
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if not spans:
            return None
        return cs.busy_union(spans) / 1e6 / wall

    default = sys.getswitchinterval()
    for label, n, interval in (("one", 1, default), ("three", 3, default),
                               (f"three, interval {args.interval:g}", 3,
                                args.interval)):
        sys.setswitchinterval(interval)
        serve(make(n))                            # untimed
        wall, tokens, stats = serve(make(n))
        steps = sum(s["steps"] for s in stats)
        decode_ms = sum(s["decode_s"] for s in stats) / max(steps, 1) * 1e3
        busy = busy_share(make(n))
        print(f"fleet_decode {label}: {n} engine(s) x {args.rows} rows, "
              f"{tokens} tokens in {wall:.3f} s, tokens_per_s "
              f"{tokens / wall:.2f}, decode step {decode_ms:.3f} ms (mean "
              f"over {steps} engine steps), prefill_s "
              f"{sum(s['prefill_s'] for s in stats):.3f}, card busy share "
              f"{'not measured' if busy is None else f'{busy:.4f}'} "
              f"[{card}]", flush=True)
    sys.setswitchinterval(default)

    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(3), ctx.Queue()
    procs = [ctx.Process(target=_process_engine,
                         args=(i, args.rows, args.new, barrier, results))
             for i in range(3)]
    for proc in procs:
        proc.start()
    try:
        got = [results.get(timeout=600) for _ in procs]
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    steps = sum(g[2] for g in got)
    tokens = sum(g[1] for g in got)
    wall = max(g[0] for g in got)
    print(f"fleet_decode three processes: 3 engine(s) x {args.rows} rows, "
          f"{tokens} tokens in {wall:.3f} s (the slowest process), "
          f"tokens_per_s {tokens / wall:.2f}, decode step "
          f"{sum(g[3] for g in got) / max(steps, 1) * 1e3:.3f} ms (mean "
          f"over {steps} engine steps), prefill_s "
          f"{sum(g[4] for g in got):.3f}, card busy share not measured "
          f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
