"""Node memory monitor + worker-killing policy (OOM defense).

Reference equivalent: `src/ray/common/memory_monitor.h:52` (threshold
sampling of /proc + cgroup limits) and
`src/ray/raylet/worker_killing_policy.h:34` (pick a victim worker instead
of letting the kernel OOM-kill the raylet). Policy here mirrors the
reference's retriable-FIFO default with the group-by-owner tie-break:
kill the NEWEST leased task first (its lost work is smallest and it is
retriable), preferring owners with multiple running tasks so no caller
is starved completely.

The monitor is process-agnostic: the raylet feeds it candidate workers
and it returns victims; killing and the retriable OutOfMemoryError reply
stay in the raylet.

The port's copy of `ray_tpu/core/memory_monitor.py`.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_CGROUP_V2_ROOT = "/sys/fs/cgroup"


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            raw = f.read().strip()
        return None if raw == "max" else int(raw)
    except (OSError, ValueError):
        return None


def node_memory_usage() -> Tuple[int, int]:
    """(used_bytes, total_bytes) for this node.

    cgroup-v2 limits win over /proc/meminfo when present (containers:
    the box's meminfo lies about what WE may use — reference:
    memory_monitor.cc GetMemoryBytes cgroup handling)."""
    cg_limit = _read_int(f"{_CGROUP_V2_ROOT}/memory.max")
    cg_used = _read_int(f"{_CGROUP_V2_ROOT}/memory.current")
    if cg_limit and cg_used is not None:
        return cg_used, cg_limit
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    if total is None or avail is None:
        return 0, 1
    return total - avail, total


def process_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


@dataclass
class WorkerCandidate:
    """What the killing policy needs to know about one leased worker."""

    worker_id: str
    pid: int
    task_id: Optional[str]
    owner_address: Optional[str]   # task submitter (group-by-owner)
    granted_at: float              # lease grant time (newest dies first)
    retriable: bool = True


def pick_victim(candidates: Sequence[WorkerCandidate]
                ) -> Optional[WorkerCandidate]:
    """Reference policy composition (worker_killing_policy.h): prefer
    retriable tasks; among those, group by owner and take the newest
    task of the owner with the MOST running tasks (that owner keeps
    making progress on its older tasks); fall back to the newest
    non-retriable task only when nothing is retriable."""
    if not candidates:
        return None
    retriable = [c for c in candidates if c.retriable]
    pool = retriable or list(candidates)
    by_owner: dict = {}
    for c in pool:
        by_owner.setdefault(c.owner_address, []).append(c)
    owner, tasks = max(by_owner.items(),
                       key=lambda kv: (len(kv[1]),
                                       max(c.granted_at for c in kv[1])))
    return max(tasks, key=lambda c: c.granted_at)


class MemoryMonitor:
    """Threshold sampler. `tick()` returns the victim to kill (or None);
    the caller owns the actual kill + retry semantics."""

    def __init__(self,
                 usage_threshold: float,
                 candidates_fn: Callable[[], List[WorkerCandidate]],
                 usage_fn: Callable[[], Tuple[int, int]] =
                 node_memory_usage,
                 min_kill_interval_s: float = 1.0):
        self.usage_threshold = usage_threshold
        self._candidates_fn = candidates_fn
        self._usage_fn = usage_fn
        self._min_kill_interval_s = min_kill_interval_s
        self._last_kill = 0.0
        self.last_usage_fraction = 0.0

    def tick(self) -> Optional[WorkerCandidate]:
        used, total = self._usage_fn()
        if total <= 0:
            return None
        frac = self.last_usage_fraction = used / total
        if frac < self.usage_threshold:
            return None
        if time.monotonic() - self._last_kill < self._min_kill_interval_s:
            return None  # give the last kill time to free memory
        victim = pick_victim(self._candidates_fn())
        if victim is not None:
            self._last_kill = time.monotonic()
            logger.warning(
                "memory usage %.1f%% >= %.1f%%: killing worker %s "
                "(task %s, rss %.0f MB) to protect the node",
                frac * 100, self.usage_threshold * 100,
                victim.worker_id[:8], (victim.task_id or "?")[:12],
                process_rss(victim.pid) / 1e6)
        return victim
