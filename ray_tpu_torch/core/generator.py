"""Streaming generator refs (`num_returns="streaming"`).

Reference equivalent: `_raylet.pyx:269` streaming generators — a task that
yields produces a stream of ObjectRefs the caller iterates without waiting for
task completion. Consumed by Serve's streaming handle path
(`DeploymentResponseGenerator`).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

_SENTINEL = object()


class ObjectRefGenerator:
    """Iterator over ObjectRefs produced by a streaming task."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    # -- producer side -------------------------------------------------
    def _push(self, ref) -> None:
        self._queue.put(ref)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        # Idempotent: a killed actor or a shut-down runtime may end a
        # stream its producer ends too; the first ending wins.
        if self._done.is_set():
            return
        self._error = error
        self._queue.put(_SENTINEL)
        self._done.set()

    # -- consumer side -------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            self._queue.put(_SENTINEL)  # keep terminal for other iterators
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def next_ready(self, timeout: Optional[float] = None):
        """Like __next__ but with a timeout; raises queue.Empty."""
        item = self._queue.get(timeout=timeout)
        if item is _SENTINEL:
            self._queue.put(_SENTINEL)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def completed(self) -> bool:
        return self._done.is_set()
