#!/usr/bin/env python3
"""What `ClusterRuntime._run_user_code`, the cancellable frame every task
and actor call on a worker runs its code in, adds to a call that no cancel
reaches: the best of five timings of `_run_user_code(task_id, f)` and of
`f()`, f a no-op, each over N calls, on the host.

    python3 tools/user_code_overhead.py [--calls N]

Prints one JSON line with the microseconds a call of each and their
difference. No runtime is started: the method runs against an object that
holds only the worker-side fields it reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import timeit
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200_000)
    n = ap.parse_args().calls

    from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

    worker = types.SimpleNamespace(
        _user_code_threads={}, _cancel_sent=set(), _cancel_swallowed=set(),
        _cancel_armed={}, _cancel_lock=threading.Lock())
    worker._leave_cancelled = ClusterRuntime._leave_cancelled.__get__(worker)
    run = ClusterRuntime._run_user_code

    def noop():
        return None

    bare = min(timeit.repeat(noop, number=n, repeat=5)) / n
    wrapped = min(timeit.repeat(lambda: run(worker, "task", noop),
                                number=n, repeat=5)) / n
    print(json.dumps({"calls": n, "bare_us": bare * 1e6,
                      "run_user_code_us": wrapped * 1e6,
                      "added_us": (wrapped - bare) * 1e6}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
