"""Run a function on N gloo ranks on the CPU, for the port's parallel tests.

    results = run_ranks(fn, 8, *args)

`fn(*args)` runs once in each of N fresh processes (the `spawn` start
method; a child imports `fn`'s module by name, so keep it free of JAX), after
`torch.distributed` was initialised there with gloo, a process-group timeout
and one thread per rank. The ranks meet at a `TCPStore` that this process
serves on a port the system picks (bound once, so no other process can take
it between the pick and the bind). It returns each rank's result in rank
order; the results must pickle (numpy arrays, numbers). If a rank raises,
`run_ranks` raises with that rank's traceback. Two deadlines: every rank
has joined the process group within STARTUP_S (spawning N interpreters
that import torch, which a loaded machine slows), and all are done within
`deadline_s` of the last one joining; past either it kills them and
raises. Every child is gone when it returns.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, List

# A rank that waits on a peer that died fails within this many seconds,
# and the whole run within the deadline.
PG_TIMEOUT_S = 60
STARTUP_S = 300
DEADLINE_S = 120
_READY = "ready"   # a rank's message once it has joined the process group


def _rank_main(fn_name, args, rank: int, world: int, port: int,
               results) -> None:
    try:
        import torch
        import torch.distributed as dist

        module, name = fn_name
        fn = getattr(importlib.import_module(module), name)

        torch.set_num_threads(1)
        timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", port, world, False, timeout)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world, timeout=timeout)
        results.put((rank, _READY, None))
        try:
            out = fn(*args)
        except BaseException:
            # Reported before the group goes down, so that it reaches the
            # parent ahead of the peers' errors about the lost connection.
            results.put((rank, False, traceback.format_exc()))
            dist.destroy_process_group()
            return
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args,
              deadline_s: float = DEADLINE_S) -> List[Any]:
    import torch.distributed as dist

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # The ranks' store: port 0 binds a free port and holds it.
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          datetime.timedelta(seconds=PG_TIMEOUT_S),
                          wait_for_workers=False)
    port = store.port
    env = {"OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # The function goes by name: `start` waits while a child unpickles
    # what it is sent, and unpickling a module that imports torch would
    # run the children's imports one after another.
    fn_name = (fn.__module__, fn.__qualname__)
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn_name, args, r, world, port, results),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out, errors = {}, {}     # errors in the order they came: the first
    # is the cause, later ones are peers that lost it.
    ready = set()
    start = time.monotonic()
    end = start + STARTUP_S
    try:
        # Drain the queue before joining: a child blocks on exit until
        # what it put is read.
        while len(out) + len(errors) < world:
            left = end - time.monotonic()
            if left <= 0:
                if len(ready) < world:
                    raise TimeoutError(
                        f"{world - len(ready)} of {world} ranks had not "
                        f"joined the process group after {STARTUP_S} s")
                raise TimeoutError(
                    f"{world - len(out) - len(errors)} of {world} ranks "
                    f"not done {deadline_s} s after the last joined (at "
                    f"{joined_s:.1f} s)")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                if errors or any(p.exitcode not in (None, 0)
                                 for p in procs):
                    # A rank failed or died: the others may wait on it
                    # until the process-group timeout; stop now.
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if errors or dead:
                        break
                continue
            if ok == _READY:
                ready.add(rank)
                if len(ready) == world:
                    joined_s = time.monotonic() - start
                    end = time.monotonic() + deadline_s
                continue
            (out if ok else errors)[rank] = val
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, end - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        del store
    if errors:
        rank = next(iter(errors))
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    if len(out) < world:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"ranks ended without a result (exit codes "
                           f"{codes})")
    return [out[r] for r in range(world)]
