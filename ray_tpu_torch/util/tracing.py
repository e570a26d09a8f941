"""Distributed tracing with W3C `traceparent` context propagation, the port
of `ray_tpu/util/tracing.py`.

Reference equivalent: `python/ray/util/tracing/tracing_helper.py:34` —
spans around task submit/execute with the trace context injected into the
task spec so a worker's span parents to its caller's, across processes.

A `traceparent` string (`00-<trace_id>-<span_id>-01`) rides the task
specs' `trace_ctx` field (core/wire.py) and Serve's request metadata.
Nesting in one thread or task is automatic through a contextvar; a caller
whose span must parent one on another thread, loop or process passes its
`current_traceparent()` explicitly (the router puts it in the request
metadata, so one trace id covers proxy -> router -> replica).

`enable_tracing(out_dir)` turns recording on and exports it: every
process appends its spans to `<out_dir>/<pid>.jsonl` (a daemon thread
flushes twice a second, and `atexit` once more), and sets
`RAY_TPU_TRACE_DIR`, `RAY_TPU_TRACE_SAMPLE` and `RAY_TPU_TRACE_SPAN_CAP`
so that the processes a cluster spawns afterwards turn it on at their
first span. `collect(out_dir)` merges every process's file and
`to_chrome_trace` renders them for chrome://tracing or Perfetto. Head
sampling is decided once at a trace's root and carried on the
traceparent's flags byte, so every process on the request's path agrees;
an unsampled trace still propagates its context but records nothing. A
per-trace span cap bounds what one request can record in a process.

`spans()` and `clear()` read and empty this process's own record of its
spans (the newest 65536), flushed or not. `disable_tracing()` stops the
recording and the flusher thread and gives back the environment variables
that `enable_tracing` set.

Off (the default), `span` costs one flag test and one environment lookup.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import os
import random
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

_enabled = False
_dir: Optional[str] = None
_buf: List[dict] = []            # spans not yet flushed to _dir
_recent: List[dict] = []         # this process's spans, for spans()
_buf_lock = threading.Lock()
_FLUSH_AT = 256
_RECENT_MAX = 65536              # oldest spans drop past this
_FLUSH_EVERY_S = 0.5

# Head sampling (reference: OpenTelemetry's TraceIdRatioBased sampler)
# and a per-trace span cap (its span limits).
_sample_rate = 1.0
_span_cap: Optional[int] = None
_span_counts: dict = {}          # trace_id -> spans recorded here
_SPAN_COUNT_MAX_TRACES = 4096    # bound the counter table itself

_ENV = ("RAY_TPU_TRACE_DIR", "RAY_TPU_TRACE_SAMPLE",
        "RAY_TPU_TRACE_SPAN_CAP")
_env_before: Optional[Dict[str, Optional[str]]] = None

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)   # (trace_id, span_id, sampled)

_flusher: Optional[threading.Thread] = None
_flusher_stop = threading.Event()
_atexit_registered = False


def enable_tracing(out_dir: Optional[str] = None, *,
                   sample_rate: Optional[float] = None,
                   max_spans_per_trace: Optional[int] = None) -> None:
    """Turn span recording on, with its export to `out_dir` (default:
    `RAY_TPU_TRACE_DIR`, else `$TMPDIR/ray_tpu_tracing`). Processes spawned
    afterwards inherit the directory, rate and cap through the
    environment.

    `sample_rate` (0..1) is the probability that a trace ROOT records;
    the default, 1.0, records every request (for tests and debugging).
    `max_spans_per_trace` caps the spans one trace records in a process.
    """
    global _enabled, _dir, _sample_rate, _span_cap, _env_before
    if _env_before is None:
        _env_before = {k: os.environ.get(k) for k in _ENV}
    if sample_rate is None:
        sample_rate = float(os.environ.get("RAY_TPU_TRACE_SAMPLE", "1.0"))
    _sample_rate = min(1.0, max(0.0, sample_rate))
    os.environ["RAY_TPU_TRACE_SAMPLE"] = repr(_sample_rate)
    if max_spans_per_trace is None:
        cap = os.environ.get("RAY_TPU_TRACE_SPAN_CAP")
        max_spans_per_trace = int(cap) if cap else None
    _span_cap = max_spans_per_trace
    if _span_cap is not None:
        os.environ["RAY_TPU_TRACE_SPAN_CAP"] = str(_span_cap)
    if out_dir is None:
        out_dir = os.environ.get("RAY_TPU_TRACE_DIR") or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "ray_tpu_tracing")
    os.makedirs(out_dir, exist_ok=True)
    with _buf_lock:
        _flush_locked()          # what was recorded for the old directory
        _dir = out_dir
    os.environ["RAY_TPU_TRACE_DIR"] = out_dir
    _enabled = True
    _start_flusher()


def _start_flusher() -> None:
    """Spans must reach the file without waiting for _FLUSH_AT: a Serve
    replica records a few spans a request, and another process's
    `collect()` cannot flush this one's buffer."""
    global _flusher, _atexit_registered
    if not _atexit_registered:
        atexit.register(flush)
        _atexit_registered = True
    if _flusher is not None and _flusher.is_alive():
        return
    _flusher_stop.clear()

    def loop():
        while not _flusher_stop.wait(_FLUSH_EVERY_S):
            try:
                flush()
            except Exception:  # noqa: BLE001 — a full disk drops spans
                pass

    _flusher = threading.Thread(target=loop, daemon=True, name="trace-flush")
    _flusher.start()


def disable_tracing() -> None:
    """Stop recording: flush what is buffered, end the flusher thread and
    restore the environment variables `enable_tracing` set."""
    global _enabled, _flusher, _env_before
    _enabled = False
    _flusher_stop.set()
    if _flusher is not None and _flusher is not threading.current_thread():
        _flusher.join(timeout=5.0)
    _flusher = None
    try:
        flush()
    except OSError:
        pass
    if _env_before is not None:
        for k, v in _env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _env_before = None


def tracing_enabled() -> bool:
    return _enabled


def _maybe_autoenable() -> None:
    """Workers: a driver that enabled tracing before the cluster started
    passed its directory down in the environment; the first span turns
    recording on."""
    if not _enabled and os.environ.get("RAY_TPU_TRACE_DIR"):
        enable_tracing(os.environ["RAY_TPU_TRACE_DIR"])


def current_traceparent() -> Optional[str]:
    """W3C traceparent for the ACTIVE span (None outside any span or
    with tracing off). The flags byte carries the sampling decision."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-{'01' if ctx[2] else '00'}"


def _parse_traceparent(tp: Optional[str]):
    if not tp:
        return None
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    sampled = parts[3] != "00"
    return parts[1], parts[2], sampled


def _under_span_cap(trace_id: str) -> bool:
    if _span_cap is None:
        return True
    n = _span_counts.get(trace_id, 0)
    if n >= _span_cap:
        return False
    if len(_span_counts) >= _SPAN_COUNT_MAX_TRACES:
        _span_counts.clear()   # bounded memory beats exact caps
    _span_counts[trace_id] = n + 1
    return True


def _record(span: dict) -> None:
    with _buf_lock:
        if not _under_span_cap(span["trace_id"]):
            return
        _recent.append(span)
        if len(_recent) > _RECENT_MAX:
            del _recent[:-_RECENT_MAX]
        if _dir is None:
            return
        _buf.append(span)
        if len(_buf) >= _FLUSH_AT:
            _flush_locked()


def _flush_locked() -> None:
    if not _dir or not _buf:
        return
    path = os.path.join(_dir, f"{os.getpid()}.jsonl")
    with open(path, "a") as f:
        for s in _buf:
            f.write(json.dumps(s) + "\n")
    _buf.clear()


def flush() -> None:
    """Append this process's unwritten spans to `<out_dir>/<pid>.jsonl`."""
    with _buf_lock:
        _flush_locked()


def spans() -> List[dict]:
    """The spans recorded in this process, oldest first."""
    with _buf_lock:
        return list(_recent)


def clear() -> None:
    """Forget this process's recorded spans (written files stay)."""
    with _buf_lock:
        _recent.clear()
        _buf.clear()


@contextlib.contextmanager
def span(name: str, *, parent: Optional[str] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Record one span. `parent` is a traceparent string (defaults to the
    ambient span via the contextvar — nesting in one context is
    automatic; a caller on another thread or process passes the
    header)."""
    _maybe_autoenable()
    if not _enabled:
        yield None
        return
    parent_ctx = _parse_traceparent(parent) or _ctx.get()
    if parent_ctx:
        trace_id, sampled = parent_ctx[0], parent_ctx[2]
    else:
        # Trace root: the head-sampling decision, inherited by every
        # descendant span in every process via the traceparent flags.
        sampled = _sample_rate >= 1.0 or random.random() < _sample_rate
        trace_id = (secrets.token_hex(16) if sampled
                    else f"{random.getrandbits(128):032x}")
    if not sampled:
        # Unsampled spans record nothing anywhere; their ids only ever
        # appear as parent ids of other never-recorded spans. A PRNG id
        # keeps this path free of the os.urandom syscall.
        span_id = f"{random.getrandbits(64):016x}"
        token = _ctx.set((trace_id, span_id, False))
        try:
            yield {"trace_id": trace_id, "span_id": span_id,
                   "sampled": False}
        finally:
            _ctx.reset(token)
        return
    span_id = secrets.token_hex(8)
    token = _ctx.set((trace_id, span_id, True))
    t0 = time.time()
    err: Optional[str] = None
    try:
        yield {"trace_id": trace_id, "span_id": span_id}
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
        raise
    finally:
        _ctx.reset(token)
        rec = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_ctx[1] if parent_ctx else None,
            "start_us": int(t0 * 1e6),
            "dur_us": int((time.time() - t0) * 1e6),
            "pid": os.getpid(),
            "attributes": attributes or {},
        }
        if err:
            rec["error"] = err
        _record(rec)


def collect(out_dir: Optional[str] = None) -> List[dict]:
    """Merge every process's span file (driver side), files in name
    order, each file's spans in the order written."""
    flush()
    d = out_dir or _dir or os.environ.get("RAY_TPU_TRACE_DIR")
    if not d or not os.path.isdir(d):
        return []
    spans_: List[dict] = []
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".jsonl"):
            continue
        with open(os.path.join(d, fname)) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        spans_.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass  # torn concurrent write
    return spans_


def to_chrome_trace(spans: List[dict],
                    filename: Optional[str] = None):
    """Chrome-trace JSON ("X" complete events keyed by trace) for
    chrome://tracing / Perfetto; written to `filename` when given."""
    events = [{
        "name": s["name"], "ph": "X", "ts": s["start_us"],
        "dur": max(s["dur_us"], 1), "pid": s.get("pid", 0),
        "tid": int(s["span_id"][:6], 16),
        "args": {**s.get("attributes", {}),
                 "trace_id": s["trace_id"],
                 "parent_id": s.get("parent_id")},
    } for s in spans]
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
