"""Tracing with W3C `traceparent` context propagation, the port of
`ray_tpu/util/tracing.py` for one process.

A span records into an in-process buffer; `spans()` reads it. Nesting in
one thread or task is automatic through a contextvar, and a caller whose
span must parent one on another thread or loop passes its
`current_traceparent()` explicitly (the router puts it in the request
metadata, and the replica's span parents to it), so one trace id covers
proxy -> router -> replica. An inbound traceparent whose flags say
"not sampled" records nothing below it.

Left out until the cluster runtime: the reference's flush of each
process's buffer to a file and the cross-process `collect`, and its
head-sampling rate and per-trace span cap (every local trace records).

Off (the default), `span` costs one flag test.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

_enabled = False
_buf: List[dict] = []
_buf_lock = threading.Lock()
_BUF_MAX = 65536                 # oldest spans drop past this

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)   # (trace_id, span_id, sampled)


def enable_tracing() -> None:
    """Turn span recording on."""
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


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


def spans() -> List[dict]:
    """The spans recorded in this process, oldest first."""
    with _buf_lock:
        return list(_buf)


def clear() -> None:
    with _buf_lock:
        _buf.clear()


@contextlib.contextmanager
def span(name: str, *, parent: Optional[str] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Record one span. `parent` is a traceparent string (defaults to the
    ambient span via the contextvar — nesting in one context is
    automatic; a caller on another thread passes the header)."""
    if not _enabled:
        yield None
        return
    parent_ctx = _parse_traceparent(parent) or _ctx.get()
    if parent_ctx:
        trace_id, sampled = parent_ctx[0], parent_ctx[2]
    else:
        trace_id, sampled = secrets.token_hex(16), True
    if not sampled:
        # Unsampled spans record nothing; their ids only ever appear as
        # parent ids of other never-recorded spans.
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
        with _buf_lock:
            _buf.append(rec)
            del _buf[:-_BUF_MAX]
