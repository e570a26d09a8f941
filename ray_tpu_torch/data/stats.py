"""Per-operator Dataset execution statistics, the port of
`ray_tpu/data/stats.py`.

Reference equivalent: `python/ray/data/_internal/stats.py`
(DatasetStats / StatsDict) and the `Dataset.stats()` report users paste
into issues: one line per operator with wall time, rows, throughput,
block counts, and the wait-vs-compute split that says whether the
bottleneck is the pipeline or the consumer.

Design: stats objects live on the driver. The streaming executor runs
read->transform chains remotely and ships a tiny per-block timing list
back with each block (`executor._run_chain_timed`), so per-operator wall
time is the REAL remote compute time, not the driver's view of it. Time
the driver spends blocked on `ray_tpu_torch.get` is recorded separately as
wait time (consumer-visible latency that is NOT operator compute).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


def block_rows_bytes(block) -> Tuple[int, int]:
    """(num_rows, heap_bytes) of a column-dict block."""
    rows = 0
    nbytes = 0
    for v in block.values():
        arr = np.asarray(v)
        rows = max(rows, len(arr))
        nbytes += arr.nbytes
    return rows, nbytes


class OpStats:
    """Accumulated execution counters for one logical operator."""

    __slots__ = ("name", "wall_s", "rows", "bytes", "blocks",
                 "min_block_s", "max_block_s")

    def __init__(self, name: str):
        self.name = name
        self.wall_s = 0.0
        self.rows = 0
        self.bytes = 0
        self.blocks = 0
        self.min_block_s = float("inf")
        self.max_block_s = 0.0

    def add(self, wall_s: float, rows: int, nbytes: int) -> None:
        self.wall_s += wall_s
        self.rows += rows
        self.bytes += nbytes
        self.blocks += 1
        self.min_block_s = min(self.min_block_s, wall_s)
        self.max_block_s = max(self.max_block_s, wall_s)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "wall_s": self.wall_s,
                "rows": self.rows, "bytes": self.bytes,
                "blocks": self.blocks}


class DatasetStats:
    """Stats for one execution of a Dataset (reference: Dataset.stats()).

    Operators are keyed by (position, name) so a chain like
    read -> map(a) -> map(a) keeps two distinct entries.
    """

    def __init__(self):
        self._ops: Dict[Tuple[int, str], OpStats] = {}
        self._lock = threading.Lock()
        self.wait_s = 0.0          # consumer blocked on block arrival
        self.start_time = time.perf_counter()
        self.total_wall_s: Optional[float] = None

    # -- recording ------------------------------------------------------
    def record_op(self, index: int, name: str, wall_s: float,
                  rows: int, nbytes: int) -> None:
        key = (index, name)
        with self._lock:
            op = self._ops.get(key)
            if op is None:
                op = self._ops[key] = OpStats(name)
            op.add(wall_s, rows, nbytes)

    def fold_op(self, index: int, other: OpStats) -> None:
        """Accumulate another execution's operator entry (exact counts,
        unlike record_op which counts one block per call)."""
        key = (index, other.name)
        with self._lock:
            op = self._ops.get(key)
            if op is None:
                op = self._ops[key] = OpStats(other.name)
            op.wall_s += other.wall_s
            op.rows += other.rows
            op.bytes += other.bytes
            op.blocks += other.blocks
            op.min_block_s = min(op.min_block_s, other.min_block_s)
            op.max_block_s = max(op.max_block_s, other.max_block_s)

    def record_wait(self, seconds: float) -> None:
        with self._lock:
            self.wait_s += seconds

    def finalize(self) -> None:
        """Stamp total wall time at iteration end (idempotent: the first
        finalize — full drain or early consumer stop — wins)."""
        if self.total_wall_s is None:
            self.total_wall_s = time.perf_counter() - self.start_time

    # -- views ----------------------------------------------------------
    @property
    def operators(self) -> List[OpStats]:
        with self._lock:
            return [self._ops[k] for k in sorted(self._ops,
                                                 key=lambda k: k[0])]

    def op(self, name: str) -> Optional[OpStats]:
        for o in self.operators:
            if o.name == name:
                return o
        return None

    def compute_s(self) -> float:
        return sum(o.wall_s for o in self.operators)

    def to_dict(self) -> Dict[str, Any]:
        return {"operators": [o.to_dict() for o in self.operators],
                "wait_s": self.wait_s,
                "total_wall_s": self.total_wall_s,
                "compute_s": self.compute_s()}

    # -- report ---------------------------------------------------------
    @staticmethod
    def _fmt_bytes(n: float) -> str:
        for unit in ("B", "KB", "MB", "GB"):
            if abs(n) < 1024.0:
                return f"{n:.1f}{unit}"
            n /= 1024.0
        return f"{n:.1f}TB"

    def summary_string(self) -> str:
        """Human-readable per-operator report (reference: the text
        `Dataset.stats()` returns)."""
        lines = ["Dataset execution stats:"]
        for o in self.operators:
            if o.wall_s > 0 and o.rows > 0:
                rate = f"{o.rows / o.wall_s:,.0f} rows/s"
                brate = self._fmt_bytes(o.bytes / o.wall_s) + "/s"
            elif o.wall_s > 0:
                rate, brate = "- rows/s", "-"  # rows unknown (exchange)
            else:
                rate, brate = "inf rows/s", "-"
            per_block = (f"min={o.min_block_s * 1e3:.2f}ms "
                         f"max={o.max_block_s * 1e3:.2f}ms"
                         if o.blocks else "")
            lines.append(
                f"* {o.name}: {o.wall_s * 1e3:.2f}ms total, "
                f"{o.blocks} blocks, {o.rows} rows "
                f"[{rate}, {brate}] {per_block}".rstrip())
        compute = self.compute_s()
        total = self.total_wall_s
        lines.append(f"* consumer wait: {self.wait_s * 1e3:.2f}ms, "
                     f"operator compute: {compute * 1e3:.2f}ms")
        if total is not None:
            lines.append(f"* end-to-end wall: {total * 1e3:.2f}ms")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.summary_string()


def timed_block_iter(source: Iterator, stats: Optional[DatasetStats],
                     index: int, name: str) -> Iterator:
    """Wrap a block iterator so each block's production time lands on one
    coarse operator entry (actor-pool stages, materialized fetches — the
    paths where fine-grained remote timing isn't available)."""
    if stats is None:
        yield from source
        return
    while True:
        t0 = time.perf_counter()
        try:
            block = next(source)
        except StopIteration:
            return
        dt = time.perf_counter() - t0
        rows, nbytes = block_rows_bytes(block)
        stats.record_op(index, name, dt, rows, nbytes)
        yield block
