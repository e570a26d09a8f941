"""Per-call attribution for the task-plane hot path.

Reference equivalent: the per-RPC latency histograms the reference keeps
in `stats/metric_defs.h` (e.g. `scheduler_task_time`) that make a task
regression attributable to a stage instead of an archaeology project.

Design constraints, in order:

1. **Zero cost when off.** Every instrumentation site is guarded by the
   module-level `enabled` bool — one global load per call site, no
   function call, no clock read. The hot path (submit -> lease -> push
   -> decode -> dispatch) pays nothing in normal operation.
2. **Cheap when on.** `record()` is two dict ops on a plain dict; spans
   accumulate (count, total_s, max_s) per label, never per-event lists,
   so a 100k-task bench can't blow memory.
3. **Cross-process.** The driver enables attribution via the
   `RAY_TPU_ATTRIBUTION` env var, which spawned workers inherit; the
   worker folds its own decode/execute timings into each task reply
   (a few ints, only when enabled) so the driver-side snapshot covers
   both sides of the wire without a separate scrape protocol.

Labels the port records (`snapshot()` reads them):

- ``submit.encode``     spec construction + template/wire encode
- ``submit.lease``      time waiting for a leased worker (pool hit ~= 0)
- ``submit.push_rtt``   push_task RPC round trip (includes execution)
- ``submit.inline`` / ``submit.remote``  counts of the dispatch split
  (caller-thread inline executions vs leased pushes)
- ``rpc.frame_write``   transport write syscalls (batched writer)
- ``wire.decode_task``  validated task-spec decode
- ``worker.decode``, ``worker.arg_resolve``, ``worker.exec``,
  ``worker.result_pack``  the worker-side split, folded from replies;
  ``inline.arg_resolve`` / ``inline.exec`` / ``inline.result_pack`` are
  its caller-thread analogue
- ``lease.batch_size`` / ``lease.return_batch``  dimensionless
  distributions (``value()``: count = batched grant or return RPCs,
  mean/max = leases per RPC)
- ``get.local_shm``     node-local shm reads that bypassed the raylet
- ``get.pull_rpc``      gets that did take the raylet pull_object RPC
- ``get.nd_view``       array gets served as a zero-copy view over the
  store segment (no pickler ran)
- ``engine.model_step``, ``engine.kv_gather``, ``engine.kv_write``  the
  serving engine's step parts

The port's copy of `ray_tpu/core/attribution.py`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

ENV_FLAG = "RAY_TPU_ATTRIBUTION"

# Module-level guard, read directly by hot-path call sites:
#   if attribution.enabled: t0 = time.perf_counter(); ...
enabled = bool(os.environ.get(ENV_FLAG))

_lock = threading.Lock()
_stats: Dict[str, list] = {}   # label -> [count, total_s, max_s]


def enable() -> None:
    """Turn attribution on for this process AND processes spawned after
    this call (the env var rides into workers via their inherited
    environment)."""
    global enabled
    enabled = True
    os.environ[ENV_FLAG] = "1"


def disable() -> None:
    global enabled
    enabled = False
    os.environ.pop(ENV_FLAG, None)


def reset() -> None:
    with _lock:
        _stats.clear()
        # Value-label markers are part of the recorded state: a label
        # reused as a duration after reset must not keep rendering in
        # sample units.
        _value_labels.clear()


def record(label: str, dt: float) -> None:
    """Fold one span of `dt` seconds into `label`'s accumulator."""
    s = _stats.get(label)
    if s is None:
        with _lock:
            s = _stats.setdefault(label, [0, 0.0, 0.0])
    # Benign races on += under the GIL can undercount slightly; a
    # profiler trades that for not taking a lock per span.
    s[0] += 1
    s[1] += dt
    if dt > s[2]:
        s[2] = dt


def count(label: str, n: int = 1) -> None:
    """Count an event with no duration (e.g. a bypass hit)."""
    s = _stats.get(label)
    if s is None:
        with _lock:
            s = _stats.setdefault(label, [0, 0.0, 0.0])
    s[0] += n


_value_labels: set = set()


def value(label: str, v: float) -> None:
    """Fold a dimensionless sample (e.g. a lease batch size) into
    `label`: snapshot reports mean/max in the sample's own units
    instead of microseconds."""
    _value_labels.add(label)
    record(label, v)


def snapshot() -> Dict[str, Dict[str, float]]:
    """{label: {count, total_ms, mean_us, max_us}} for reporting."""
    out = {}
    with _lock:
        items = [(k, list(v)) for k, v in _stats.items()]
    for label, (n, total, mx) in sorted(items):
        if label in _value_labels:
            out[label] = {
                "count": n,
                "total": round(total, 3),
                "mean": round(total / n, 2) if n else 0.0,
                "max": round(mx, 2),
            }
            continue
        out[label] = {
            "count": n,
            "total_ms": round(total * 1e3, 3),
            "mean_us": round(total / n * 1e6, 2) if n else 0.0,
            "max_us": round(mx * 1e6, 2),
        }
    return out


def fold(remote: Dict[str, Any], prefix: str = "worker.") -> None:
    """Fold a worker-reported fragment into the local table.

    Duration entries arrive as microsecond ints: ``{label: us}``.
    Dimensionless entries (worker-side `value()` samples) MUST arrive
    marked — ``{label: [sample, "v"]}``, built with `value_marked` —
    because `_value_labels` is process-local: an unmarked sample folded
    from a worker fragment would render as microseconds in the owner's
    `snapshot()`."""
    for label, us in remote.items():
        if isinstance(us, (list, tuple)):
            # (sample, "v") marker: a dimensionless value() sample.
            value(prefix + label, us[0])
        else:
            record(prefix + label, us / 1e6)


def value_marked(v: float) -> list:
    """Wrap a dimensionless sample for a cross-process fragment so
    `fold()` on the receiving side keeps its units (see `fold`)."""
    return [v, "v"]
