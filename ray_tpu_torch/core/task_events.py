"""Task event buffer: the substrate for timeline() and the state API.

Reference equivalent: `src/ray/core_worker/task_event_buffer.h:202` —
every worker/driver buffers task lifecycle events locally (bounded, drop
oldest) and flushes them to the GCS task-event store periodically; the
driver's `timeline()` and `ray_tpu list tasks` read them back.

The port's copy of `ray_tpu/core/task_events.py`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# Lifecycle points (reference: rpc::TaskStatus).
SUBMITTED = "SUBMITTED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"


class TaskEventBuffer:
    def __init__(self, capacity: int = 16384):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def record(self, task_id: str, name: str, event: str,
               **extra: Any) -> None:
        e = {"task_id": task_id, "name": name, "event": event,
             "ts": time.time(), **extra}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(e)

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def snapshot(self, job_id: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
        """Non-destructive view (local-mode's event 'store')."""
        with self._lock:
            events = list(self._events)
        if job_id is not None:
            events = [e for e in events if e.get("job_id") == job_id]
        return events

    def __len__(self) -> int:
        return len(self._events)


_buffer: Optional[TaskEventBuffer] = None
_buffer_lock = threading.Lock()


def task_event_buffer() -> TaskEventBuffer:
    global _buffer
    with _buffer_lock:
        if _buffer is None:
            _buffer = TaskEventBuffer()
        return _buffer


def write_trace(trace: List[Dict[str, Any]],
                filename: Optional[str]) -> List[Dict[str, Any]]:
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def events_to_chrome_trace(events: List[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
    """Pair RUNNING/FINISHED events into chrome://tracing 'X' slices
    (reference: ray timeline's chrome-trace export)."""
    starts: Dict[str, Dict[str, Any]] = {}
    trace: List[Dict[str, Any]] = []
    for e in sorted(events, key=lambda x: x["ts"]):
        tid = e["task_id"]
        if e["event"] == RUNNING:
            starts[tid] = e
        elif e["event"] in (FINISHED, FAILED) and tid in starts:
            s = starts.pop(tid)
            trace.append({
                "ph": "X", "cat": "task", "name": e["name"],
                "pid": e.get("node_id", s.get("node_id", "node"))[:8],
                "tid": e.get("worker_id", s.get("worker_id", "worker"))[:8],
                "ts": s["ts"] * 1e6, "dur": (e["ts"] - s["ts"]) * 1e6,
                "args": {"task_id": tid,
                         "failed": e["event"] == FAILED},
            })
        elif e["event"] == SUBMITTED:
            trace.append({
                "ph": "i", "cat": "task", "name": f"submit:{e['name']}",
                "pid": e.get("node_id", "driver")[:8], "tid": "submit",
                "ts": e["ts"] * 1e6, "s": "t",
                "args": {"task_id": tid},
            })
    return trace
