"""Streaming task-pool executor, the port of `ray_tpu/data/executor.py`.

Reference equivalent: `python/ray/data/_internal/execution/
streaming_executor.py:60` (+ task-pool map operator): blocks flow through
the plan as they materialize, with a bounded in-flight window providing
backpressure — a slow consumer stalls the producers instead of the whole
dataset materializing in the object store.

A chain of map stages is fused into ONE remote task per block (read ->
transform*), the same fusion the reference's optimizer performs for
compatible map operators; stateful stages run on an actor pool
(`actor_compute.py`).

Each block task returns its per-operator wall times next to the block, so
`Dataset.stats()` reports the remote compute time per operator plus the
driver's wait time.

The port sends functions by reference (it has no cloudpickle): on a
cluster, every read task and transform must pickle, so a user's function
is defined at a module's top level. Without a runtime the chain runs in
this process and takes any callable.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.stats import DatasetStats, block_rows_bytes


def _op_name(fn: Callable, index: int) -> str:
    name = getattr(fn, "__name__", "")
    if not name or name == "<lambda>":
        name = f"transform_{index}"
    return name


def _run_chain_timed(read_task: Callable[[], Block],
                     transforms: List[Callable[[Block], Block]]) -> dict:
    """Fused read->transform* chain + per-operator timing, shipped back
    with the block."""
    t0 = time.perf_counter()
    block = read_task()
    dt = time.perf_counter() - t0
    rows, nbytes = block_rows_bytes(block)
    ops = [("read", dt, rows, nbytes)]
    for i, t in enumerate(transforms):
        t0 = time.perf_counter()
        block = t(block)
        dt = time.perf_counter() - t0
        rows, nbytes = block_rows_bytes(block)
        ops.append((_op_name(t, i), dt, rows, nbytes))
    return {"block": block, "ops": ops}


class StreamingExecutor:
    """Pull-driven: iterating schedules up to `max_in_flight` block tasks;
    each consumed block admits the next task (backpressure window)."""

    def __init__(self, read_tasks: List[Callable[[], Block]],
                 transforms: List[Callable[[Block], Block]],
                 max_in_flight: int = 4, locality: str = "driver",
                 stats: Optional[DatasetStats] = None):
        self.read_tasks = read_tasks
        self.transforms = transforms
        self.max_in_flight = max(1, max_in_flight)
        self.locality = locality
        self.stats = stats

    def _record(self, payload: dict) -> Block:
        if self.stats is not None:
            for i, (name, dt, rows, nbytes) in enumerate(payload["ops"]):
                self.stats.record_op(i, name, dt, rows, nbytes)
        return payload["block"]

    def __iter__(self) -> Iterator[Block]:
        import ray_tpu_torch

        run = ray_tpu_torch.remote(num_cpus=1)(_run_chain_timed)
        pending = list(self.read_tasks)
        # Submission order is preserved in the output (deterministic
        # ordering, like the reference's preserve_order execution option).
        window: List = []
        while pending or window:
            while pending and len(window) < self.max_in_flight:
                window.append(run.remote(pending.pop(0), self.transforms))
            ref, window = window[0], window[1:]
            t0 = time.perf_counter()
            payload = ray_tpu_torch.get(ref, timeout=600)
            if self.stats is not None:
                self.stats.record_wait(time.perf_counter() - t0)
            yield self._record(payload)

    def run_local(self) -> Iterator[Block]:
        """In-process execution (no runtime): Dataset stays usable as a
        plain library."""
        for rt in self.read_tasks:
            yield self._record(_run_chain_timed(rt, self.transforms))
