"""Per-process metrics time-series buffer (round 17 observability).

The metrics registry (`util/metrics.py`) answers "what is the value
now"; this module makes that answer shippable over time.  Each process
keeps a `Recorder`: every capture interval it diffs the registry
snapshot against the previous one and appends a **delta-encoded** entry
to a bounded ring — counters and histogram buckets ship increments,
gauges ship levels, and series that did not move ship nothing at all.
The pending ring survives raylet hiccups (entries are only dropped on
ack or when the ring overflows), so a transient push failure loses no
points, only delays them.

Transport is piggybacked on plumbing that already exists:

    worker Recorder --ts_batch on report_metrics--> raylet
    raylet fold (its workers + own runtime gauges)
                   --metrics on the GCS heartbeat--> GCS retention store

so the fleet-wide cost is one coalesced payload per node per heartbeat
interval — O(nodes), not O(processes).

Zero-cost-off discipline mirrors `core/flight.py`: one module-level
``enabled`` bool checked at every call site, toggled through an env
flag that child processes inherit at spawn.

The port's copy of `ray_tpu/core/metrics_ts.py`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

ENV_FLAG = "RAY_TPU_METRICS_PIPELINE"


def _env_enabled() -> bool:
    val = os.environ.get(ENV_FLAG, "1").strip().lower()
    return val not in ("0", "false", "no", "off", "")


enabled: bool = _env_enabled()


def enable() -> None:
    """Turn the pipeline on for this process and for future children."""
    global enabled
    enabled = True
    os.environ[ENV_FLAG] = "1"


def disable() -> None:
    """Turn the pipeline off for this process and for future children."""
    global enabled
    enabled = False
    os.environ[ENV_FLAG] = "0"


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Deterministic identity for a (name, labels) series.

    The same key is computed by every producer and by the GCS store, so
    a series re-pushed after a GCS restart lands on its recovered
    metadata instead of registering a duplicate.
    """
    return name + "|" + ",".join(
        f"{k}={labels[k]}" for k in sorted(labels))


class Recorder:
    """Delta-encodes registry snapshots into a bounded pending ring.

    Entries are wire-ready batches::

        {"t": <wall time>, "series": [[name, type, labels, payload], ...]}

    where payload is a float increment (counter), a float level (gauge),
    or ``[bucket_deltas, sum_delta, count_delta, boundaries]``
    (histogram — boundaries ride along so quantile-over-time needs no
    out-of-band schema).  A series' first-ever entry carries a fifth
    element, its help string, which the GCS persists as series metadata.
    """

    def __init__(self, capacity: int = 128) -> None:
        self._capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._prev: Dict[Tuple[str, Any], Any] = {}
        self._seen: set = set()
        self._pending: List[Dict[str, Any]] = []
        self.dropped = 0  # entries evicted unacked (ring overflow)

    def configure(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, capacity)

    def capture(self, snapshot: List[Dict[str, Any]],
                t: Optional[float] = None) -> bool:
        """Diff `snapshot` (registry shape) against the previous capture
        and queue one delta entry.  Returns True if anything changed."""
        series: List[List[Any]] = []
        with self._lock:
            for metric in snapshot:
                name = metric.get("name")
                mtype = metric.get("type")
                help_text = metric.get("help", "")
                for sample in metric.get("samples", ()):
                    tags = dict(sample.get("tags") or {})
                    key = (name, tuple(sorted(tags.items())))
                    first = key not in self._seen
                    if mtype == "histogram":
                        buckets = list(sample.get("buckets") or ())
                        total = float(sample.get("sum", 0.0))
                        count = int(sample.get("count", 0))
                        prev = self._prev.get(key)
                        if prev is None:
                            b_delta = buckets
                            s_delta, c_delta = total, count
                        else:
                            pb, ps, pc = prev
                            if len(pb) != len(buckets):  # boundaries changed
                                pb = [0] * len(buckets)
                                ps, pc = 0.0, 0
                            b_delta = [b - p for b, p in zip(buckets, pb)]
                            s_delta, c_delta = total - ps, count - pc
                        self._prev[key] = (buckets, total, count)
                        if c_delta <= 0 and not first:
                            continue
                        payload: Any = [b_delta, s_delta, c_delta,
                                        list(sample.get("boundaries") or ())]
                    elif mtype == "counter":
                        value = float(sample.get("value", 0.0))
                        prev_v = self._prev.get(key)
                        delta = value if prev_v is None else value - prev_v
                        self._prev[key] = value
                        if delta == 0 and not first:
                            continue
                        payload = delta
                    else:  # gauge (and anything unknown degrades to one)
                        value = float(sample.get("value", 0.0))
                        if self._prev.get(key) == value and not first:
                            continue
                        self._prev[key] = value
                        payload = value
                    entry = [name, mtype, tags, payload]
                    if first:
                        self._seen.add(key)
                        entry.append(help_text)
                    series.append(entry)
            if not series:
                return False
            self._pending.append(
                {"t": time.time() if t is None else t, "series": series})
            overflow = len(self._pending) - self._capacity
            if overflow > 0:
                del self._pending[:overflow]
                self.dropped += overflow
            return True

    def pending(self) -> List[Dict[str, Any]]:
        """Unacked entries, oldest first (a snapshot — safe to ship)."""
        with self._lock:
            return list(self._pending)

    def ack(self, n: int) -> None:
        """Drop the oldest `n` entries after a successful push."""
        if n <= 0:
            return
        with self._lock:
            del self._pending[:n]

    def reset(self) -> None:
        with self._lock:
            self._prev.clear()
            self._seen.clear()
            self._pending.clear()
            self.dropped = 0


_recorder = Recorder()


def recorder() -> Recorder:
    return _recorder


def capture(snapshot: List[Dict[str, Any]],
            t: Optional[float] = None) -> bool:
    if not enabled:
        return False
    return _recorder.capture(snapshot, t=t)


def pending() -> List[Dict[str, Any]]:
    return _recorder.pending()


def ack(n: int) -> None:
    _recorder.ack(n)
