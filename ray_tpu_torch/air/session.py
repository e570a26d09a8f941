"""Per-worker training session: the `session.report` surface, the port of
`ray_tpu/air/session.py`.

Reference: `python/ray/air/session.py` + `train/_internal/session.py:109,393`
(_TrainSession with a result queue consumed by the backend executor).
The session lives in the training worker process; `report()` hands a result
to the executor and blocks until it is consumed, giving the gang natural
lockstep at report boundaries.

Step telemetry: each `report()` closes one "step" whose wall time is
split into data-wait (time blocked in the instrumented dataset-shard
iterators, `iter_torch_batches` among them), collective time (recorded by
`util/collective.py` ops through `_record_collective`), and compute (the
remainder). The
split rides the report as `telemetry` metadata for the backend executor
AND lands in worker-local `train_*_seconds` histograms, which the metrics
push sends to the raylet (reference: ray.train's per-step reporting +
metrics agent export).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None

_TELEMETRY_KINDS = ("step_time", "data_wait", "collective", "compute")


def _train_histograms() -> Dict[str, Any]:
    """Lazy per-process train_* histograms (created in the worker, so
    registration lands in the worker's pushed registry)."""
    from ray_tpu_torch.util.metrics import Histogram, get_instruments

    def build():
        bounds = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                  60.0]
        return {
            kind: Histogram(
                f"train_{kind}_seconds",
                f"Per-training-step {kind.replace('_', ' ')} (seconds)",
                boundaries=bounds, tag_keys=("trial",))
            for kind in _TELEMETRY_KINDS
        }

    return get_instruments("train.session", build)


def _record_collective(seconds: float) -> None:
    """Called by util/collective.py ops: attribute collective wall time
    to the active training step (no-op outside a train loop)."""
    s = _get_session(required=False)
    if s is not None:
        s._collective_s += seconds


class _TimedIter:
    """Iterator wrapper charging next() wall time to the session's
    data-wait bucket (reference: ray.train's instrumented dataset
    iterator feeding `data_wait` in step telemetry)."""

    def __init__(self, it: Iterator, session: "_TrainSession"):
        self._it = iter(it)
        self._session = session

    def __iter__(self) -> "_TimedIter":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self._session._data_wait_s += time.perf_counter() - t0


class _TimedShard:
    """Transparent dataset-shard proxy: any `iter_*` call returns a
    timed iterator; everything else delegates to the real shard.

    Pickling unwraps to the underlying shard (the session holds locks
    and queues): a train loop that ships its shard into a remote task
    keeps working, it just isn't timed on the other side."""

    def __init__(self, shard: Any, session: "_TrainSession"):
        self._shard = shard
        self._session = session

    def __getattr__(self, name: str):
        attr = getattr(self._shard, name)
        if name.startswith("iter_") and callable(attr):
            session = self._session

            def timed(*args, **kwargs):
                return _TimedIter(attr(*args, **kwargs), session)

            return timed
        return attr

    def __iter__(self):
        return _TimedIter(iter(self._shard), self._session)

    def __reduce__(self):
        return (_identity, (self._shard,))

    def __repr__(self) -> str:
        return f"TimedShard({self._shard!r})"


def _identity(x):
    return x


class _TrainSession:
    def __init__(self, *, world_rank: int, local_rank: int, world_size: int,
                 node_rank: int, trial_name: str = "",
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shard: Any = None,
                 profile_steps: Optional[tuple] = None,
                 profile_dir: Optional[str] = None):
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.node_rank = node_rank
        self.trial_name = trial_name
        self.loaded_checkpoint = checkpoint
        self.dataset_shard = dataset_shard
        # maxsize=1: report() blocks until the executor consumes the result
        # (reference: session result queue semantics).
        self.result_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self.continue_event = threading.Event()
        self.finished = False
        self.error: Optional[BaseException] = None
        self.final_return: Any = None
        self.stop_requested = False
        # -- step telemetry (reset at each report boundary) -------------
        self._step_t0 = time.perf_counter()
        self._data_wait_s = 0.0
        self._collective_s = 0.0
        self.last_telemetry: Optional[Dict[str, float]] = None
        # -- torch.profiler step capture (TrainConfig(profile_steps)) ---
        self._profile_steps = (tuple(profile_steps)
                               if profile_steps else None)
        self._profile_dir = profile_dir
        self._steps_completed = 0
        self._profiling = False
        self._profiler: Any = None
        self._profile_trace_dir: Optional[str] = None
        self._maybe_profile()  # profile_steps starting at step 1

    def _maybe_profile(self) -> None:
        """Start/stop a torch.profiler capture at the configured step
        boundaries (steps are 1-indexed; capture covers [a, b]
        inclusive), with CUDA activity where the worker holds a card,
        written as a Chrome trace, `trace.json`, in the trace dir. Every
        failure is swallowed: profiling must never fail a training
        step."""
        if self._profile_steps is None:
            return
        a, b = self._profile_steps[0], self._profile_steps[-1]
        next_step = self._steps_completed + 1
        try:
            if (not self._profiling and self._profile_trace_dir is None
                    and a <= next_step <= b):
                import os
                import tempfile

                import torch

                base = self._profile_dir or os.path.join(
                    tempfile.gettempdir(), "ray_tpu_torch_profile")
                trace_dir = os.path.join(
                    base, self.trial_name or "default",
                    f"rank{self.world_rank}")
                os.makedirs(trace_dir, exist_ok=True)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(
                    activities=activities)
                self._profiler.start()
                self._profiling = True
                self._profile_trace_dir = trace_dir
            elif self._profiling and self._steps_completed >= b:
                import os

                self._profiling = False
                self._profiler.stop()
                self._profiler.export_chrome_trace(
                    os.path.join(self._profile_trace_dir, "trace.json"))
                self._profiler = None
                self._publish_profile()
        except Exception:
            self._profiling = False

    def _publish_profile(self) -> None:
        """Advertise the captured trace dir in GCS KV
        (`train_profile/<trial>/<rank>`, the reference's key)."""
        import json
        import os
        import socket

        try:
            from ray_tpu_torch.core.worker import current_runtime

            rt = current_runtime()
            a, b = self._profile_steps[0], self._profile_steps[-1]
            rt.kv_put(
                f"train_profile/{self.trial_name or 'default'}/"
                f"{self.world_rank}",
                json.dumps({
                    "trial": self.trial_name or "default",
                    "rank": self.world_rank,
                    "trace_dir": self._profile_trace_dir,
                    "steps": [a, b],
                    "hostname": socket.gethostname(),
                    "pid": os.getpid(),
                }).encode())
        except Exception:
            pass  # publication is best-effort; the trace dir survives

    def _close_step(self) -> Dict[str, float]:
        step_wall = max(0.0, time.perf_counter() - self._step_t0)
        data_wait = min(self._data_wait_s, step_wall)
        collective = min(self._collective_s, step_wall - data_wait)
        telemetry = {
            "step_time_s": step_wall,
            "data_wait_s": data_wait,
            "collective_s": collective,
            "compute_s": max(0.0, step_wall - data_wait - collective),
            "world_rank": self.world_rank,
        }
        self.last_telemetry = telemetry
        try:
            hists = _train_histograms()
            tags = {"trial": self.trial_name or "default"}
            for kind in _TELEMETRY_KINDS:
                hists[kind].observe(telemetry[f"{kind}_s"], tags=tags)
        except Exception:
            pass  # telemetry must never fail a training step
        self._data_wait_s = 0.0
        self._collective_s = 0.0
        self._steps_completed += 1
        self._maybe_profile()
        return telemetry

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        telemetry = self._close_step()
        self.result_queue.put({"type": "report", "metrics": dict(metrics),
                               "checkpoint": checkpoint,
                               "telemetry": telemetry})
        self.continue_event.wait()
        self.continue_event.clear()
        # The next step starts when the executor releases this report.
        self._step_t0 = time.perf_counter()
        if self.stop_requested:
            raise _StopTraining()

    def finish(self, final: Any = None,
               error: Optional[BaseException] = None) -> None:
        # `finished` is polled from another thread: it must be the LAST
        # write, or a poller can observe finished=True with error unset and
        # report a crashed loop as a clean finish.
        self.error = error
        self.final_return = final
        self.finished = True


class _StopTraining(Exception):
    """Raised inside the user loop when the controller stops the trial
    (e.g. an early-stopping scheduler decision)."""


def _set_session(s: Optional[_TrainSession]) -> None:
    global _session
    with _session_lock:
        _session = s


def _get_session(required: bool = True) -> Optional[_TrainSession]:
    if _session is None and required:
        raise RuntimeError(
            "No training session active: session.* may only be called "
            "inside train_loop_per_worker")
    return _session


# -- public API (reference: ray.air.session / ray.train free functions) ----
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().loaded_checkpoint


def get_world_rank() -> int:
    return _get_session().world_rank


def get_local_rank() -> int:
    return _get_session().local_rank


def get_world_size() -> int:
    return _get_session().world_size


def get_node_rank() -> int:
    return _get_session().node_rank


def get_trial_name() -> str:
    return _get_session().trial_name


def get_dataset_shard(name: str = "train") -> Any:
    """The worker's dataset shard, wrapped in a timing proxy (like the
    reference's DataIterator wrapper): blocked-on-data time feeds the
    step's data_wait telemetry split. The proxy delegates every
    attribute to the real shard and unwraps on pickle, but is not an
    `isinstance` match for Dataset/DatasetPipeline — duck-type it."""
    session = _get_session()
    shard = session.dataset_shard
    if isinstance(shard, dict):
        shard = shard.get(name)
    if shard is None:
        return None
    return _TimedShard(shard, session)
