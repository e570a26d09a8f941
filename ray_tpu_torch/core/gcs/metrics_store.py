"""GCS-side metrics retention store + SLO burn-rate tracker (round 17).

Receives the per-node coalesced batches piggybacked on raylet
heartbeats (see `core/metrics_ts.py` for the wire format) and keeps,
per series:

  * **metadata** — name, type, labels, help, histogram boundaries.
    Registered once per series and persisted through the GCS WAL
    (`metric_series` table), so identity survives a kill -9.
  * **cumulative state** — exact running totals folded at ingest
    (counters sum their increments, histograms their bucket
    increments), so the Prometheus exposition at `GET /metrics` is a
    true monotone counter view regardless of ring eviction.
  * **a retention ring** — the most recent N delta points, feeding the
    windowed query engine (`rate()`, quantile-over-time on pushed
    histogram buckets, label aggregation).  Ring data is deliberately
    in-memory only: after a restart the recovered metadata makes
    re-pushed series land on their old identity (no duplicates) while
    history restarts empty — the cheap half of durability that
    actually matters for alerting.

The SLO layer evaluates declarative objectives against the store with
the multi-window burn-rate recipe (error budget consumed per unit time,
checked over a long and a short window so a page needs both sustained
and current burn).  State transitions surface as `slo.burn` flight
events, landing on the merged `/api/timeline` next to the stalls that
caused them.

The port's copy of `ray_tpu/core/gcs/metrics_store.py`.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.metrics_ts import series_key


class _Series:
    __slots__ = ("meta", "ring", "counter_total", "gauge_last",
                 "hist_buckets", "hist_sum", "hist_count")

    def __init__(self, meta: Dict[str, Any], points: int) -> None:
        self.meta = meta
        self.ring: deque = deque(maxlen=max(2, points))
        self.counter_total = 0.0
        self.gauge_last = 0.0
        self.hist_buckets: List[float] = []
        self.hist_sum = 0.0
        self.hist_count = 0


class MetricsStore:
    """Retention rings + query engine over pushed delta batches."""

    def __init__(self, max_series: int = 2000, points: int = 512,
                 on_register: Optional[Callable[[str, Dict], None]] = None,
                 ) -> None:
        self.max_series = max_series
        self.points = points
        self.on_register = on_register
        self.series: Dict[str, _Series] = {}
        self.dropped_series = 0
        self.points_ingested = 0
        self.batches_ingested = 0

    # -- ingest ----------------------------------------------------------

    def adopt_metadata(self, metadata: Dict[str, Dict]) -> None:
        """Recreate (empty-ring) series for WAL-recovered metadata, so a
        re-pushed series after restart reuses its identity."""
        for key, meta in metadata.items():
            if key not in self.series:
                self.series[key] = _Series(dict(meta), self.points)

    def ingest(self, batch: List[Dict[str, Any]],
               extra_labels: Optional[Dict[str, str]] = None) -> None:
        """Fold one node's pushed batch (a list of delta entries)."""
        for entry in batch:
            t = float(entry.get("t") or time.time())
            for item in entry.get("series", ()):
                name, mtype, labels, payload = item[0], item[1], \
                    dict(item[2]), item[3]
                help_text = item[4] if len(item) > 4 else None
                if extra_labels:
                    for k, v in extra_labels.items():
                        labels.setdefault(k, v)
                key = series_key(name, labels)
                s = self.series.get(key)
                if s is None:
                    if len(self.series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    meta = {"name": name, "type": mtype, "labels": labels,
                            "help": help_text or ""}
                    if mtype == "histogram":
                        meta["boundaries"] = list(payload[3])
                    s = self.series[key] = _Series(meta, self.points)
                    if self.on_register is not None:
                        self.on_register(key, meta)
                elif help_text and not s.meta.get("help"):
                    s.meta["help"] = help_text
                if mtype == "histogram":
                    b_delta, s_delta, c_delta = \
                        payload[0], payload[1], payload[2]
                    if len(s.hist_buckets) != len(b_delta):
                        s.hist_buckets = [0.0] * len(b_delta)
                        s.meta["boundaries"] = list(payload[3])
                    for i, d in enumerate(b_delta):
                        s.hist_buckets[i] += d
                    s.hist_sum += s_delta
                    s.hist_count += int(c_delta)
                    s.ring.append((t, (b_delta, s_delta, int(c_delta))))
                elif mtype == "counter":
                    s.counter_total += payload
                    s.ring.append((t, payload))
                else:
                    s.gauge_last = payload
                    s.ring.append((t, payload))
                self.points_ingested += 1
            self.batches_ingested += 1

    # -- reads -----------------------------------------------------------

    def latest_fold(self) -> List[Dict[str, Any]]:
        """The cluster-wide fold, shaped like a registry snapshot (the
        shape `util.metrics.render_prometheus` consumes)."""
        by_name: Dict[str, Dict[str, Any]] = {}
        for s in self.series.values():
            meta = s.meta
            out = by_name.setdefault(meta["name"], {
                "name": meta["name"], "type": meta["type"],
                "help": meta.get("help", ""), "samples": []})
            if meta["type"] == "histogram":
                if not s.hist_buckets:
                    continue  # metadata-only (recovered, nothing pushed)
                out["samples"].append({
                    "tags": dict(meta["labels"]),
                    "buckets": list(s.hist_buckets),
                    "boundaries": list(meta.get("boundaries", ())),
                    "sum": s.hist_sum, "count": s.hist_count})
            elif meta["type"] == "counter":
                if not s.ring:
                    continue
                out["samples"].append({"tags": dict(meta["labels"]),
                                       "value": s.counter_total})
            else:
                if not s.ring:
                    continue
                out["samples"].append({"tags": dict(meta["labels"]),
                                       "value": s.gauge_last})
        return [m for m in by_name.values() if m["samples"]]

    def _select(self, name: str,
                labels: Optional[Dict[str, str]]) -> List[_Series]:
        out = []
        for s in self.series.values():
            if s.meta["name"] != name:
                continue
            if labels and any(s.meta["labels"].get(k) != v
                              for k, v in labels.items()):
                continue
            out.append(s)
        return out

    @staticmethod
    def _window_points(s: _Series, since: float) -> List[Tuple[float, Any]]:
        return [(t, p) for t, p in s.ring if t >= since]

    def window_histogram(self, name: str, window_s: float,
                         labels: Optional[Dict[str, str]] = None,
                         now: Optional[float] = None,
                         ) -> Tuple[List[float], List[float], float, int]:
        """Summed bucket increments over the window across matching
        series → (boundaries, bucket_counts, sum, count)."""
        now = time.time() if now is None else now
        since = now - window_s
        boundaries: List[float] = []
        buckets: List[float] = []
        total_sum, total_count = 0.0, 0
        for s in self._select(name, labels):
            if s.meta["type"] != "histogram":
                continue
            sb = list(s.meta.get("boundaries", ()))
            for t, (b_delta, s_delta, c_delta) in \
                    self._window_points(s, since):
                if not boundaries:
                    boundaries = sb
                    buckets = [0.0] * len(b_delta)
                if len(b_delta) != len(buckets):
                    continue  # incompatible boundaries; skip
                for i, d in enumerate(b_delta):
                    buckets[i] += d
                total_sum += s_delta
                total_count += c_delta
        return boundaries, buckets, total_sum, total_count

    @staticmethod
    def bucket_quantile(boundaries: List[float], buckets: List[float],
                        q: float) -> Optional[float]:
        total = sum(buckets)
        if total <= 0:
            return None
        target = q * total
        acc = 0.0
        for i, c in enumerate(buckets):
            acc += c
            if acc >= target:
                return (boundaries[i] if i < len(boundaries)
                        else boundaries[-1] if boundaries else float("inf"))
        return boundaries[-1] if boundaries else None

    def query(self, name: str, window_s: float = 60.0, agg: str = "raw",
              labels: Optional[Dict[str, str]] = None,
              group_by: Optional[List[str]] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Windowed read.  agg: raw | rate | sum | avg | max | min | pNN
        (e.g. p99 — quantile-over-time on pushed histogram buckets)."""
        now = time.time() if now is None else now
        since = now - window_s
        matched = self._select(name, labels)
        out: Dict[str, Any] = {"series": name, "window_s": window_s,
                               "agg": agg, "matched": len(matched)}

        if agg.startswith("p") and agg[1:].replace(".", "").isdigit():
            q = float(agg[1:]) / 100.0
            boundaries, buckets, hsum, hcount = self.window_histogram(
                name, window_s, labels, now=now)
            out["value"] = self.bucket_quantile(boundaries, buckets, q)
            out["count"] = hcount
            out["sum"] = hsum
            return out

        if agg == "raw":
            rows = []
            for s in matched:
                pts = []
                for t, p in self._window_points(s, since):
                    if s.meta["type"] == "histogram":
                        pts.append([round(t, 3), p[2]])
                    else:
                        pts.append([round(t, 3), p])
                rows.append({"labels": s.meta["labels"], "points": pts})
            out["results"] = rows
            return out

        # Scalar-per-group aggregations.
        groups: Dict[Tuple, Dict[str, Any]] = {}
        for s in matched:
            gkey = tuple((k, s.meta["labels"].get(k, ""))
                         for k in (group_by or ()))
            g = groups.setdefault(gkey, {"labels": dict(gkey), "values": []})
            pts = self._window_points(s, since)
            if not pts:
                continue
            if agg == "rate":
                if s.meta["type"] == "histogram":
                    inc = sum(p[2] for _, p in pts)
                elif s.meta["type"] == "counter":
                    inc = sum(p for _, p in pts)
                else:  # gauge: net change over the window
                    inc = pts[-1][1] - pts[0][1]
                g["values"].append(inc / max(window_s, 1e-9))
            else:  # gauge-style: latest value per series
                p = pts[-1][1]
                g["values"].append(p[2] if s.meta["type"] == "histogram"
                                   else p)
        rows = []
        for g in groups.values():
            vals = g["values"]
            if agg in ("rate", "sum"):
                v = sum(vals)
            elif agg == "avg":
                v = sum(vals) / len(vals) if vals else None
            elif agg == "max":
                v = max(vals) if vals else None
            elif agg == "min":
                v = min(vals) if vals else None
            else:
                raise ValueError(f"unknown agg {agg!r}")
            rows.append({"labels": g["labels"], "value": v})
        out["results"] = rows
        return out

    def stats(self) -> Dict[str, Any]:
        return {"series": len(self.series),
                "dropped_series": self.dropped_series,
                "points_ingested": self.points_ingested,
                "batches_ingested": self.batches_ingested}


# -- SLO burn-rate tracking ----------------------------------------------

_DEFAULT_PAGE_BURN = 10.0
_DEFAULT_WARN_BURN = 2.0


class SloTracker:
    """Declarative objectives evaluated against the retention store.

    Two objective kinds:

      * ``latency_quantile`` — ``<series> p<q*100> < threshold_s over
        window_s``.  Error fraction = fraction of histogram
        observations above the threshold in the window; error budget =
        1 - q.
      * ``error_ratio`` — ``<bad_series> / <total_series> < max_ratio
        over window_s``.  Error fraction = bad rate / total rate;
        budget = max_ratio.

    Burn rate = error fraction / budget.  The state machine is the
    standard multi-window recipe: **page** when both the long window
    (the objective's own) and the short window (long/12) burn at >=
    page_burn, **warning** at >= warn_burn, else **ok** — so a page
    needs burn that is both sustained and still happening.
    """

    def __init__(self, on_transition: Optional[
            Callable[[str, str, str, float], None]] = None) -> None:
        self.slos: Dict[str, Dict[str, Any]] = {}
        self.state: Dict[str, Dict[str, Any]] = {}
        self.on_transition = on_transition

    def register(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        name = spec.get("name")
        if not name:
            raise ValueError("SLO spec needs a 'name'")
        kind = spec.get("objective", "latency_quantile")
        if kind not in ("latency_quantile", "error_ratio"):
            raise ValueError(f"unknown SLO objective {kind!r}")
        if kind == "latency_quantile":
            if not spec.get("series"):
                raise ValueError("latency_quantile SLO needs 'series'")
            spec.setdefault("q", 0.99)
            if "threshold_s" not in spec:
                raise ValueError("latency_quantile SLO needs 'threshold_s'")
        else:
            if not spec.get("bad_series") or not spec.get("total_series"):
                raise ValueError(
                    "error_ratio SLO needs 'bad_series' and 'total_series'")
            spec.setdefault("max_ratio", 0.01)
        spec.setdefault("window_s", 300.0)
        spec.setdefault("page_burn", _DEFAULT_PAGE_BURN)
        spec.setdefault("warn_burn", _DEFAULT_WARN_BURN)
        self.slos[name] = spec
        self.state.setdefault(name, {
            "state": "ok", "burn_long": 0.0, "burn_short": 0.0,
            "since": time.time(), "transitions": 0})
        return spec

    def remove(self, name: str) -> bool:
        self.state.pop(name, None)
        return self.slos.pop(name, None) is not None

    def _error_fraction(self, store: MetricsStore, spec: Dict[str, Any],
                        window_s: float, now: float) -> Tuple[float, float]:
        """→ (error_fraction, event_count) over `window_s`."""
        labels = spec.get("labels")
        if spec.get("objective", "latency_quantile") == "latency_quantile":
            boundaries, buckets, _, count = store.window_histogram(
                spec["series"], window_s, labels, now=now)
            if count <= 0:
                return 0.0, 0.0
            threshold = float(spec["threshold_s"])
            good = 0.0
            for i, c in enumerate(buckets):
                ub = boundaries[i] if i < len(boundaries) else float("inf")
                if ub <= threshold:
                    good += c
            return max(0.0, (count - good) / count), float(count)
        bad = store.query(spec["bad_series"], window_s, "rate",
                          labels=spec.get("bad_labels") or labels, now=now)
        total = store.query(spec["total_series"], window_s, "rate",
                            labels=spec.get("total_labels") or labels,
                            now=now)
        bad_v = sum(r["value"] or 0.0 for r in bad["results"])
        tot_v = sum(r["value"] or 0.0 for r in total["results"])
        if tot_v <= 0:
            return 0.0, 0.0
        return max(0.0, bad_v / tot_v), tot_v * window_s

    def evaluate(self, store: MetricsStore,
                 now: Optional[float] = None) -> List[Tuple[str, str, str]]:
        """Re-evaluate every SLO; returns [(name, old, new)] transitions."""
        now = time.time() if now is None else now
        transitions = []
        for name, spec in self.slos.items():
            long_w = float(spec["window_s"])
            short_w = max(1.0, long_w / 12.0)
            if spec.get("objective",
                        "latency_quantile") == "latency_quantile":
                budget = max(1e-9, 1.0 - float(spec["q"]))
            else:
                budget = max(1e-9, float(spec["max_ratio"]))
            frac_long, n_long = self._error_fraction(
                store, spec, long_w, now)
            frac_short, _ = self._error_fraction(store, spec, short_w, now)
            burn_long = frac_long / budget
            burn_short = frac_short / budget
            if burn_long >= spec["page_burn"] and \
                    burn_short >= spec["page_burn"]:
                new_state = "page"
            elif burn_long >= spec["warn_burn"] and \
                    burn_short >= spec["warn_burn"]:
                new_state = "warning"
            else:
                new_state = "ok"
            st = self.state[name]
            st["burn_long"] = round(burn_long, 4)
            st["burn_short"] = round(burn_short, 4)
            st["events_long"] = n_long
            if new_state != st["state"]:
                old = st["state"]
                st["state"] = new_state
                st["since"] = now
                st["transitions"] += 1
                transitions.append((name, old, new_state))
                if self.on_transition is not None:
                    self.on_transition(name, old, new_state, burn_long)
        return transitions

    def status(self, store: MetricsStore) -> List[Dict[str, Any]]:
        """The `GET /api/slo` payload."""
        out = []
        now = time.time()
        for name, spec in self.slos.items():
            st = self.state.get(name, {})
            row = {"name": name, "spec": spec, "state": st.get("state", "ok"),
                   "burn_long": st.get("burn_long", 0.0),
                   "burn_short": st.get("burn_short", 0.0),
                   "since": st.get("since"),
                   "transitions": st.get("transitions", 0)}
            if spec.get("objective",
                        "latency_quantile") == "latency_quantile":
                boundaries, buckets, _, count = store.window_histogram(
                    spec["series"], float(spec["window_s"]),
                    spec.get("labels"), now=now)
                row["current_quantile_s"] = MetricsStore.bucket_quantile(
                    boundaries, buckets, float(spec["q"]))
                row["window_events"] = count
            out.append(row)
        return out
