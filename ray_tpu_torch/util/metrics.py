"""Application metrics: Counter / Gauge / Histogram, the part of
`ray_tpu/util/metrics.py` that Serve's instruments use.

Each process keeps a local `MetricsRegistry` (`default_registry()`);
`snapshot()` is its serializable view. The reference pushes snapshots to
its raylet for the dashboard's `/metrics`; the port has no runtime yet,
so readers (tests, benches) take the snapshot in process.
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
        # subclass AFTER its sample state exists: a reader may snapshot
        # the registry concurrently with construction.
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
    """Process-local instrument registry + snapshot."""

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
        """Serializable view of every instrument."""
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
    (the serving engine and fleet). Constructing the same instrument twice would shadow the
    first registration in the registry, so first use is locked."""
    inst = _instrument_cache.get(key)
    if inst is None:
        with _instrument_cache_lock:
            inst = _instrument_cache.get(key)
            if inst is None:
                inst = _instrument_cache[key] = build()
    return inst
