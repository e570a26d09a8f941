"""Application metrics: Counter / Gauge / Histogram.

Reference equivalent: `python/ray/util/metrics.py` (the user facade over
the C++ OpenCensus stats layer, `src/ray/stats/metric.h:147-201`) and the
per-node metrics agent that exports Prometheus
(`python/ray/_private/metrics_agent.py:416`).

Design here: each process keeps a local `MetricsRegistry`; worker/driver
processes periodically push snapshots to their raylet
(`report_metrics` RPC), which merges them with its own runtime gauges and
serves the union to the dashboard's cluster-wide `/metrics` endpoint in
Prometheus text exposition format.

The port's copy of `ray_tpu/util/metrics.py`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base: a named instrument with fixed tag keys."""

    type_name = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None,
                 registry: Optional["MetricsRegistry"] = None):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        # Registration is deferred to _register_self(), called by each
        # subclass AFTER its sample state exists: the push thread may
        # snapshot the registry concurrently with construction.
        self._registry = registry

    def _register_self(self) -> None:
        (self._registry or default_registry()).register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> None:
        self._default_tags = dict(tags)

    def _resolve_tags(self, tags: Optional[Dict[str, str]]
                      ) -> Dict[str, str]:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"tags {sorted(extra)} not declared in tag_keys for "
                f"metric {self.name}")
        return merged

    def samples(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonic count (reference: util/metrics.py Counter)."""

    type_name = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[Tuple, float] = {}
        self._register_self()

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        key = _tag_key(self._resolve_tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"tags": dict(k), "value": v}
                    for k, v in self._values.items()]


class Gauge(Metric):
    """Last-set value (reference: util/metrics.py Gauge)."""

    type_name = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[Tuple, float] = {}
        self._register_self()

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = _tag_key(self._resolve_tags(tags))
        with self._lock:
            self._values[key] = float(value)

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"tags": dict(k), "value": v}
                    for k, v in self._values.items()]


class Histogram(Metric):
    """Bucketed observations (reference: util/metrics.py Histogram;
    Prometheus cumulative-bucket exposition)."""

    type_name = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None,
                 registry: Optional["MetricsRegistry"] = None):
        if not boundaries:
            boundaries = [0.001, 0.01, 0.1, 1.0, 10.0, 100.0]
        if list(boundaries) != sorted(boundaries):
            raise ValueError("histogram boundaries must be sorted")
        self.boundaries = [float(b) for b in boundaries]
        super().__init__(name, description, tag_keys, registry)
        # per tag-set: [bucket_counts..., +Inf], sum, count
        self._state: Dict[Tuple, Dict[str, Any]] = {}
        self._register_self()

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = _tag_key(self._resolve_tags(tags))
        with self._lock:
            st = self._state.setdefault(
                key, {"buckets": [0] * (len(self.boundaries) + 1),
                      "sum": 0.0, "count": 0})
            for i, bound in enumerate(self.boundaries):
                if value <= bound:
                    st["buckets"][i] += 1
                    break
            else:
                st["buckets"][-1] += 1
            st["sum"] += value
            st["count"] += 1

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"tags": dict(k), "buckets": list(st["buckets"]),
                     "boundaries": list(self.boundaries),
                     "sum": st["sum"], "count": st["count"]}
                    for k, st in self._state.items()]


class MetricsRegistry:
    """Process-local instrument registry + snapshot/merge/render."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name} already registered with type "
                    f"{existing.type_name}")
            self._metrics[metric.name] = metric

    def snapshot(self) -> List[Dict[str, Any]]:
        """Serializable view of every instrument (the push payload)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return [{"name": m.name, "type": m.type_name,
                 "help": m.description, "samples": m.samples()}
                for m in metrics]


_default_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _default_registry
    with _registry_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


_instrument_cache: Dict[str, Any] = {}
_instrument_cache_lock = threading.Lock()


def get_instruments(key: str, build):
    """Build-once instrument set per process, shared by every subsystem
    (serve proxies/router/replica, train session/executor, data
    shuffle). Constructing the same instrument twice would shadow the
    first registration in the registry, so first use is locked."""
    inst = _instrument_cache.get(key)
    if inst is None:
        with _instrument_cache_lock:
            inst = _instrument_cache.get(key)
            if inst is None:
                inst = _instrument_cache[key] = build()
    return inst


# ---------------------------------------------------------------------------
# Prometheus text exposition (consumed by the dashboard /metrics endpoint).
# ---------------------------------------------------------------------------

def _fmt_tags(tags: Dict[str, str], extra: Optional[Dict[str, str]] = None
              ) -> str:
    merged = dict(tags)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def render_prometheus(snapshots: List[Dict[str, Any]],
                      extra_tags: Optional[Dict[str, str]] = None) -> str:
    """One process's snapshot list -> Prometheus text format."""
    out: List[str] = []
    for m in snapshots:
        name = m["name"]
        out.append(f"# HELP {name} {m.get('help', '')}")
        out.append(f"# TYPE {name} {m['type']}")
        for s in m.get("samples", []):
            tags = s.get("tags", {})
            if m["type"] == "histogram":
                acc = 0
                for bound, cnt in zip(s["boundaries"], s["buckets"]):
                    acc += cnt
                    out.append(
                        f"{name}_bucket"
                        f"{_fmt_tags({**tags, 'le': repr(bound)}, extra_tags)}"
                        f" {acc}")
                acc += s["buckets"][-1]
                out.append(
                    f"{name}_bucket"
                    f"{_fmt_tags({**tags, 'le': '+Inf'}, extra_tags)} {acc}")
                out.append(f"{name}_sum{_fmt_tags(tags, extra_tags)} "
                           f"{s['sum']}")
                out.append(f"{name}_count{_fmt_tags(tags, extra_tags)} "
                           f"{s['count']}")
            else:
                out.append(
                    f"{name}{_fmt_tags(tags, extra_tags)} {s['value']}")
    return "\n".join(out) + "\n"


def merge_snapshots(per_source: List[Tuple[Dict[str, str],
                                           List[Dict[str, Any]]]]
                    ) -> List[Dict[str, Any]]:
    """Merge snapshots from several processes; each source's identifying
    tags (pid/worker_id) are folded into its samples' tags so series stay
    distinct."""
    merged: Dict[str, Dict[str, Any]] = {}
    for source_tags, snaps in per_source:
        for m in snaps:
            slot = merged.setdefault(
                m["name"], {"name": m["name"], "type": m["type"],
                            "help": m.get("help", ""), "samples": []})
            for s in m.get("samples", []):
                s2 = dict(s)
                s2["tags"] = {**s.get("tags", {}), **source_tags}
                slot["samples"].append(s2)
    return list(merged.values())


class _PushState:
    """Background pusher: flush the default registry to a callback every
    interval (used by worker/driver runtimes to report to the raylet)."""

    def __init__(self, push_fn, interval_s: float):
        self._push = push_fn
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-push")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush_now()

    def flush_now(self) -> None:
        try:
            snap = default_registry().snapshot()
            if snap:
                self._push(snap)
        except Exception:
            pass  # raylet briefly unreachable: drop this push

    def stop(self) -> None:
        self._stop.set()


_push_state: Optional[_PushState] = None


def start_metrics_push(push_fn, interval_s: float) -> None:
    global _push_state
    if _push_state is None:
        _push_state = _PushState(push_fn, interval_s)


def stop_metrics_push() -> None:
    global _push_state
    if _push_state is not None:
        _push_state.stop()
        _push_state = None


def flush_metrics_push() -> None:
    """Push the current snapshot NOW (bypassing the interval). Used by
    short-lived processes — e.g. training workers at gang shutdown —
    whose final observations would otherwise die with the process
    before the next periodic push."""
    st = _push_state
    if st is not None:
        st.flush_now()
