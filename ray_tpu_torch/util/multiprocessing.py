"""multiprocessing.Pool API over the port's tasks, the port of
`ray_tpu/util/multiprocessing.py`.

Reference equivalent: `python/ray/util/multiprocessing/pool.py` — the
drop-in `Pool` with apply/apply_async/map/map_async/starmap/imap/
imap_unordered, backed by tasks instead of forked processes (so it
scales past one host and through the scheduler).

The port has no cloudpickle, so the work goes by reference: one
module-level task takes the user's function as an argument, and that
function (and the initializer) must be a module-level function or a
`functools.partial` of one. A lambda or closure raises a `TypeError` that
says so before any task is submitted.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional


def _run_chunk(fn: Callable, initializer: Optional[Callable],
               initargs: tuple, items: list, star: bool) -> list:
    if initializer is not None:
        initializer(*initargs)
    if star:
        return [fn(*item) for item in items]
    return [fn(item) for item in items]


def _run_one(fn: Callable, args: tuple, kwargs: dict) -> Any:
    return fn(*args, **kwargs)


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(self._refs,
                                      num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    """`Pool(processes=N)`: N is a concurrency hint (chunk parallelism),
    not a process count — the cluster decides placement."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        import ray_tpu_torch
        from ray_tpu_torch.core.serialization import check_sendable

        if initializer is not None:
            check_sendable("Pool's initializer", initializer)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._parallelism = processes or 8
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False
        self._chunk_task = ray_tpu_torch.remote(_run_chunk)
        self._one_task = ray_tpu_torch.remote(_run_one)

    def _submit_chunks(self, what: str, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int], star: bool) -> list:
        from ray_tpu_torch.core.serialization import check_sendable

        self._check_open()
        check_sendable(f"Pool.{what}'s function", fn)
        return [self._chunk_task.remote(fn, self._initializer,
                                        self._initargs, chunk, star)
                for chunk in self._chunks(iterable, chunksize)]

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool is closed")

    # -- apply -----------------------------------------------------------
    def apply(self, fn: Callable, args: tuple = (),
              kwargs: Optional[dict] = None):
        return self.apply_async(fn, args, kwargs).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwargs: Optional[dict] = None) -> AsyncResult:
        from ray_tpu_torch.core.serialization import check_sendable

        self._check_open()
        check_sendable("Pool.apply's function", fn)
        ref = self._one_task.remote(fn, tuple(args), dict(kwargs or {}))
        return AsyncResult([ref], single=True)

    # -- map -------------------------------------------------------------
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._parallelism * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> "_MapResult":
        return _MapResult(self._submit_chunks("map", fn, iterable,
                                              chunksize, False))

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        return _MapResult(self._submit_chunks("starmap", fn, iterable,
                                              chunksize, True)).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        import ray_tpu_torch

        refs = self._submit_chunks("imap", fn, iterable, chunksize, False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        import ray_tpu_torch

        pending = self._submit_chunks("imap_unordered", fn, iterable,
                                      chunksize, False)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _MapResult(AsyncResult):
    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        return list(itertools.chain.from_iterable(chunks))
