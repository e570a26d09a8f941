"""Per-process flight recorder: always-on event rings + stall forensics.

Reference intuition: Dapper (Sigelman et al., 2010) and "The Tail at
Scale" (Dean & Barroso, 2013) — tail anomalies are only fixable once
*always-on, low-overhead* recording makes individual episodes
attributable after the fact: a whole-process stall of hundreds of ms
swings every task-plane number, and only a record of what the loop was
doing when it hit can explain it. This module is that capability:

1. **Event ring.** A fixed-capacity ring of the most recent events
   ``(t_monotonic, tid, category, label, dur_us, arg)``, written
   lock-free (single list store per event; racing writers on distinct
   threads are GIL-benign exactly like ``attribution.record`` — a rare
   collision loses one event, never corrupts). Hot-path call sites
   guard with the module-level ``enabled`` bool, same zero-cost-off
   discipline as ``attribution.enabled`` — when the recorder is off a
   call site pays one global load. Unlike attribution (off by default,
   an explicit profiling mode) the flight recorder defaults ON: its
   purpose is to already hold the evidence when an *unplanned* episode
   hits.

2. **GC source.** ``install_gc_hook`` registers a `gc.callbacks` pair:
   every collection becomes one event with generation + duration — a
   gen-2 pause sitting exactly under a task-plane latency spike stops
   being a mystery.

3. **Loop-lag watchdog.** ``watch_loop(loop, name)`` schedules a
   heartbeat coroutine on the asyncio loop (it records its own
   scheduling delay whenever that exceeds 1 ms) and starts one
   monitor *thread* per process. When a loop's heartbeat goes overdue
   past ``stall_threshold_ms`` the monitor opens a **stall episode**
   — capturing an all-threads stack dump via ``sys._current_frames()``
   *while the loop is still blocked* (no py-spy dependency; this is
   what names the blocking frame) — and when the loop resumes it
   finalizes the episode: measured lag, the stack dump, and the
   surrounding ring events are written as a self-contained JSON report
   under the session log dir and kept in ``stalls()``.

4. **Merged timeline.** ``dump()`` exports this process's ring with a
   wall<->monotonic clock anchor; ``to_chrome_trace`` merges any set
   of process dumps into one Chrome-trace/Perfetto JSON, aligning
   clocks through the anchors (the raylet's ``dump_flight_record`` RPC
   fans the dump out to its workers).

Event categories the port records: ``task`` (submits, push RTT, worker
exec), ``lease`` (acquire wait / return), ``lineage``, ``node``,
``gcs``, ``slo``, ``gc`` (collector pauses), ``loop`` (heartbeat
scheduling delays), ``stall`` (finalized episodes), ``engine`` (serve
decode/prefill steps).

The port's copy of `ray_tpu/core/flight.py`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

ENV_FLAG = "RAY_TPU_FLIGHT_RECORDER"

# How overdue (vs stall_threshold_ms) a heartbeat must be before the
# monitor opens an episode, and how often the monitor checks. The check
# period bounds detection latency: a stall shorter than one check can
# slip by (the heartbeat's own lag event still records it).
_MONITOR_PERIOD_S = 0.02

# Heartbeat delays under this are normal scheduler jitter — recording
# them would wash task events out of the ring at 20 Hz per loop.
_LAG_RECORD_FLOOR_US = 1000

# Bounded forensics: episodes kept in memory / reports written per
# process (a wedged box must not fill its disk with reports).
_MAX_STALLS = 32
_MAX_REPORTS = 64


def _env_enabled() -> bool:
    v = os.environ.get(ENV_FLAG)
    if v is None:
        return True
    return v.strip().lower() in ("1", "true", "yes", "on")


# Module-level guard, read directly by hot-path call sites:
#   if flight.enabled: flight.record(...)
enabled = _env_enabled()

# Wall<->monotonic anchor for cross-process clock alignment: an event's
# wall time is t_mono - anchor_mono + anchor_wall. Captured once per
# process (both reads back to back, so the pair is self-consistent).
_anchor_wall = time.time()
_anchor_mono = time.monotonic()

_capacity = 4096
_ring: List[Any] = [None] * _capacity
_idx = 0   # total events ever recorded (mod nothing; slot = _idx % cap)

_stall_threshold_ms = 100.0
_heartbeat_s = 0.05
_report_dir: Optional[str] = None
_reports_written = 0

_meta: Dict[str, Any] = {"role": "unknown", "worker_id": None,
                         "node_id": None}

_stalls: List[Dict[str, Any]] = []
_loops: Dict[str, Dict[str, Any]] = {}
_monitor_thread: Optional[threading.Thread] = None
_lock = threading.Lock()   # cold-path state only (loops, stalls, config)


# ----------------------------------------------------------------------
# recording
# ----------------------------------------------------------------------
def record(category: str, label: str, dur_us: int = 0,
           arg: Any = None, t: Optional[float] = None) -> None:
    """Fold one event into the ring. `t` is the event START in
    time.monotonic seconds (defaults to now); `dur_us` > 0 renders as a
    duration slice in the merged trace, 0 as an instant. `arg` must be
    JSON/msgpack-scalar (str/int/float/None) — it rides RPC dumps.

    Lock-free: one counter bump + one list store. Racing threads can
    collide on a slot (one event lost) or undercount — the benign-race
    trade attribution.record documents, taken for the same reason.
    """
    global _idx
    if not enabled:
        return
    i = _idx
    _idx = i + 1
    # Slot derived from the captured list's own length (not _capacity):
    # a concurrent configure() swap can lose this event but can never
    # index out of range.
    ring = _ring
    ring[i % len(ring)] = (
        t if t is not None else time.monotonic(),
        threading.get_ident(), category, label, int(dur_us), arg)


def instant(category: str, label: str, arg: Any = None) -> None:
    record(category, label, 0, arg)


def enable() -> None:
    """Turn the recorder on for this process AND processes spawned
    after this call (children read the env flag)."""
    global enabled
    enabled = True
    os.environ[ENV_FLAG] = "1"


def disable() -> None:
    """Off for this process and subsequently spawned children. The env
    var is SET to 0 (not popped): the recorder defaults on, so absence
    means enabled."""
    global enabled
    enabled = False
    os.environ[ENV_FLAG] = "0"


def reset() -> None:
    """Clear the ring and captured episodes (tests; the ring otherwise
    never needs clearing — it overwrites itself)."""
    global _ring, _idx
    with _lock:
        _ring = [None] * _capacity
        _idx = 0
        _stalls.clear()


def configure(capacity: Optional[int] = None,
              stall_threshold_ms: Optional[float] = None,
              heartbeat_ms: Optional[float] = None,
              report_dir: Optional[str] = None) -> None:
    """Apply config (flight_events / stall_threshold_ms /
    flight_heartbeat_ms flags, called once at runtime construction).
    Resizing drops recorded events (a boot-time operation)."""
    global _ring, _idx, _capacity, _stall_threshold_ms, _heartbeat_s
    global _report_dir
    with _lock:
        if capacity is not None and capacity != _capacity:
            _capacity = max(16, int(capacity))
            _ring = [None] * _capacity
            _idx = 0
        if stall_threshold_ms is not None:
            _stall_threshold_ms = float(stall_threshold_ms)
        if heartbeat_ms is not None:
            _heartbeat_s = max(0.005, float(heartbeat_ms) / 1000.0)
        if report_dir is not None:
            _report_dir = report_dir


def set_role(role: str, worker_id: Optional[str] = None,
             node_id: Optional[str] = None) -> None:
    _meta["role"] = role
    if worker_id is not None:
        _meta["worker_id"] = worker_id
    if node_id is not None:
        _meta["node_id"] = node_id


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------
def snapshot(window_s: Optional[float] = None,
             categories: Optional[set] = None) -> List[tuple]:
    """The ring's events, oldest first, optionally filtered to the last
    `window_s` seconds and/or a category set. Reads race writers
    benignly: a concurrent burst can overwrite the oldest slots
    mid-scan, so the result is sorted by timestamp before returning."""
    i = _idx
    ring = _ring
    cap = len(ring)
    n = min(i, cap)
    cutoff = (time.monotonic() - window_s) if window_s else None
    out = []
    for k in range(i - n, i):
        ev = ring[k % cap]
        if ev is None:
            continue
        if cutoff is not None and ev[0] < cutoff:
            continue
        if categories is not None and ev[2] not in categories:
            continue
        out.append(ev)
    out.sort(key=lambda e: e[0])
    return out


def events() -> List[tuple]:
    """The ring's events, oldest first (`snapshot()` unfiltered)."""
    return snapshot()


def dropped() -> int:
    """Events that have been overwritten (ever recorded - capacity)."""
    return max(0, _idx - _capacity)


def stalls() -> List[Dict[str, Any]]:
    """Finalized stall episodes, oldest first (bounded)."""
    with _lock:
        return list(_stalls)


def dump(window_s: Optional[float] = None,
         include_events: bool = True) -> Dict[str, Any]:
    """Self-contained process record for cross-process merging: ring
    events + clock anchor + identity + captured stall episodes (the
    payload of the `dump_flight_record` RPC)."""
    return {
        "pid": os.getpid(),
        "role": _meta["role"],
        "worker_id": _meta["worker_id"],
        "node_id": _meta["node_id"],
        "anchor_wall": _anchor_wall,
        "anchor_mono": _anchor_mono,
        "enabled": enabled,
        "dropped": dropped(),
        "events": ([list(e) for e in snapshot(window_s=window_s)]
                   if include_events else []),
        "stalls": [dict(s, events=None) for s in stalls()],
    }


# ----------------------------------------------------------------------
# GC source
# ----------------------------------------------------------------------
_gc_installed = False
_gc_t0 = 0.0


def _gc_callback(phase: str, info: Dict[str, Any]) -> None:
    # GC is stop-the-world for this process: one module global is
    # enough to pair start/stop.
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.monotonic()
    elif phase == "stop":
        now = time.monotonic()
        if enabled:
            record("gc", f"gen{info.get('generation', '?')}",
                   dur_us=int((now - _gc_t0) * 1e6),
                   arg=info.get("collected", 0), t=_gc_t0)


def install_gc_hook() -> None:
    """Register the gc.callbacks pair (idempotent). The callback costs
    two clock reads per collection — nothing on the allocation path."""
    global _gc_installed
    import gc

    with _lock:
        if _gc_installed:
            return
        gc.callbacks.append(_gc_callback)
        _gc_installed = True


def uninstall_gc_hook() -> None:
    global _gc_installed
    import gc

    with _lock:
        if not _gc_installed:
            return
        try:
            gc.callbacks.remove(_gc_callback)
        except ValueError:
            pass
        _gc_installed = False


# ----------------------------------------------------------------------
# loop-lag watchdog
# ----------------------------------------------------------------------
def watch_loop(loop, name: str) -> str:
    """Start a heartbeat on `loop` and ensure the monitor thread runs.
    Returns a handle for `unwatch_loop`. Re-watching a name replaces
    the old entry (a fresh runtime after shutdown/init)."""
    entry = {
        "name": name,
        "loop": loop,
        "period": _heartbeat_s,
        "last_beat": time.monotonic(),
        "thread_ident": None,
        "stop": False,
        # episode state, owned by the monitor thread:
        "open": False,
        "stalled_since": 0.0,
        "frames": None,
    }
    with _lock:
        old = _loops.get(name)
        if old is not None:
            old["stop"] = True
        _loops[name] = entry
    _ensure_monitor()

    async def _beat() -> None:
        entry["thread_ident"] = threading.get_ident()
        while not entry["stop"] and not loop.is_closed():
            entry["last_beat"] = time.monotonic()
            try:
                import asyncio

                await asyncio.sleep(entry["period"])
            except Exception:
                return
            lag = time.monotonic() - entry["last_beat"] - entry["period"]
            lag_us = int(lag * 1e6)
            if enabled and lag_us > _LAG_RECORD_FLOOR_US:
                record("loop", f"lag.{name}", dur_us=lag_us,
                       t=entry["last_beat"] + entry["period"])

    def _start() -> None:
        import asyncio

        entry["task"] = asyncio.ensure_future(_beat())

    try:
        loop.call_soon_threadsafe(_start)
    except RuntimeError:
        # Loop already closed: leave the entry stopped so the monitor
        # skips it.
        entry["stop"] = True
    return name


def unwatch_loop(name: str) -> None:
    with _lock:
        entry = _loops.pop(name, None)
    if entry is not None:
        entry["stop"] = True


def _ensure_monitor() -> None:
    global _monitor_thread
    with _lock:
        if _monitor_thread is not None and _monitor_thread.is_alive():
            return
        _monitor_thread = threading.Thread(
            target=_monitor_loop, daemon=True, name="flight-watchdog")
        _monitor_thread.start()


def _capture_stacks(skip_ident: Optional[int] = None) -> Dict[str, Any]:
    """All-threads stack dump via sys._current_frames() — captured from
    the monitor thread WHILE the watched loop is still blocked, so the
    blocking frame itself is on its thread's stack. No py-spy, no
    subprocess: the forensic must work inside the wedged process."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        if ident == skip_ident:
            continue
        out[str(ident)] = {
            "name": names.get(ident, "?"),
            "frames": traceback.format_stack(frame),
        }
    return out


def _monitor_loop() -> None:
    my_ident = threading.get_ident()
    while True:
        time.sleep(_MONITOR_PERIOD_S)
        now = time.monotonic()
        with _lock:
            entries = list(_loops.values())
        for entry in entries:
            if entry["stop"]:
                continue
            beat = entry["last_beat"]
            overdue_ms = (now - beat - entry["period"]) * 1e3
            if not entry["open"]:
                if overdue_ms > _stall_threshold_ms:
                    # The loop is blocked RIGHT NOW: capture the stacks
                    # before it resumes — this is the whole reason the
                    # monitor is a thread and not a coroutine.
                    entry["open"] = True
                    entry["stalled_since"] = beat
                    try:
                        entry["frames"] = _capture_stacks(my_ident)
                    except Exception:
                        entry["frames"] = {}
            elif beat > entry["stalled_since"]:
                # Heartbeat moved: the loop resumed. Finalize.
                frames = entry["frames"]
                entry["open"] = False
                entry["frames"] = None
                lag_ms = (beat - entry["stalled_since"]
                          - entry["period"]) * 1e3
                try:
                    _finalize_stall(entry, lag_ms, frames)
                except Exception:
                    pass  # forensics must never hurt the process


def report_dir() -> str:
    global _report_dir
    if _report_dir is None:
        import tempfile

        _report_dir = os.environ.get("RAY_TPU_LOG_DIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_flight")
    os.makedirs(_report_dir, exist_ok=True)
    return _report_dir


def _finalize_stall(entry: Dict[str, Any], lag_ms: float,
                    frames: Optional[Dict[str, Any]]) -> None:
    global _reports_written
    t_end = time.monotonic()
    episode = {
        "ts_wall": _anchor_wall + (t_end - _anchor_mono),
        "loop": entry["name"],
        "pid": os.getpid(),
        "role": _meta["role"],
        "worker_id": _meta["worker_id"],
        "node_id": _meta["node_id"],
        "lag_ms": round(lag_ms, 1),
        "threshold_ms": _stall_threshold_ms,
        "loop_thread": str(entry.get("thread_ident")),
        "stacks": frames or {},
        # The surrounding ring events — what the process was doing in
        # the seconds leading into (and out of) the episode.
        "events": [list(e) for e in snapshot(window_s=10.0)],
        "dropped": dropped(),
        "report_path": None,
    }
    if _reports_written < _MAX_REPORTS:
        _reports_written += 1
        path = os.path.join(
            report_dir(),
            f"stall-{_meta['role']}-{os.getpid()}-"
            f"{_reports_written}.json")
        try:
            with open(path, "w") as f:
                json.dump(episode, f, indent=1, default=str)
            episode["report_path"] = path
        except OSError:
            pass
    with _lock:
        _stalls.append(episode)
        del _stalls[:-_MAX_STALLS]
    # The episode itself becomes a ring event, so a later, larger dump
    # shows stalls inline with the traffic they interrupted.
    record("stall", f"stall.{entry['name']}", dur_us=int(lag_ms * 1e3),
           arg=episode["report_path"], t=entry["stalled_since"])


# ----------------------------------------------------------------------
# merged Chrome-trace export
# ----------------------------------------------------------------------
def to_chrome_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-process dump() records into one Chrome-trace JSON
    (chrome://tracing, Perfetto). Clock alignment: each record carries
    its own wall<->monotonic anchor, so every event maps onto the
    shared wall clock regardless of per-process monotonic epochs; the
    earliest event becomes ts=0. pid/tid map to the real process/thread
    ids with `process_name` metadata naming role/worker/node."""
    events: List[Dict[str, Any]] = []
    base_wall: Optional[float] = None
    walls = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        off = rec.get("anchor_wall", 0.0) - rec.get("anchor_mono", 0.0)
        walls.extend(ev[0] + off for ev in rec.get("events", ()))
    base_wall = min(walls) if walls else 0.0
    for rec in records:
        if not isinstance(rec, dict):
            continue
        pid = rec.get("pid", 0)
        role = rec.get("role") or "proc"
        wid = rec.get("worker_id") or ""
        nid = rec.get("node_id") or ""
        pname = f"{role}" + (f" {wid[:8]}" if wid else "") + \
            f" pid={pid}" + (f" @{nid[:8]}" if nid else "")
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": pname}})
        off = rec.get("anchor_wall", 0.0) - rec.get("anchor_mono", 0.0)
        for ev in rec.get("events", ()):
            t, tid, cat, label, dur, arg = ev[:6]
            e: Dict[str, Any] = {
                "name": label, "cat": cat, "pid": pid, "tid": tid,
                "ts": round((t + off - base_wall) * 1e6, 1),
            }
            if dur and dur > 0:
                e["ph"] = "X"
                e["dur"] = dur
            else:
                e["ph"] = "i"
                e["s"] = "t"
            if arg is not None:
                e["args"] = {"arg": arg}
            events.append(e)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"tool": "ray_tpu flight recorder",
                         "processes": len(records)}}


def write_chrome_trace(records: List[Dict[str, Any]],
                       path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records), f)
    return path
