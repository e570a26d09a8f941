"""ActorPool: fixed set of actors consuming a stream of work, the port of
`ray_tpu/util/actor_pool.py`.

Reference equivalent: `python/ray/util/actor_pool.py` — same surface
(`map`, `map_unordered`, `submit`, `get_next`, `get_next_unordered`,
`has_next`, `push`, `pop_idle`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, TypeVar

V = TypeVar("V")


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._actor_of_ref = {}
        self._ref_of_submit_idx = {}
        self._submit_counter = 0
        self._yield_counter = 0
        self._backlog: List[tuple] = []

    # -- core ----------------------------------------------------------
    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._actor_of_ref[future] = actor
            self._ref_of_submit_idx[self._submit_counter] = future
            self._submit_counter += 1
        else:
            self._backlog.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._ref_of_submit_idx)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        if self._yield_counter not in self._ref_of_submit_idx:
            # Earlier indices were consumed by get_next_unordered: the
            # "next in order" is the smallest remaining submission index.
            self._yield_counter = min(self._ref_of_submit_idx)
        future = self._ref_of_submit_idx[self._yield_counter]
        import ray_tpu_torch

        if timeout is not None:
            # Probe first: on timeout the future stays retrievable and
            # the actor stays booked (reference ActorPool semantics).
            ready, _ = ray_tpu_torch.wait([future], num_returns=1,
                                    timeout=timeout)
            if not ready:
                raise TimeoutError("get_next timed out")
        del self._ref_of_submit_idx[self._yield_counter]
        self._yield_counter += 1
        try:
            return ray_tpu_torch.get(future, timeout=timeout)
        finally:
            self._return_actor(self._actor_of_ref.pop(future))

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(
            list(self._actor_of_ref), num_returns=1,
            timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        for idx, f in list(self._ref_of_submit_idx.items()):
            if f == future:
                del self._ref_of_submit_idx[idx]
                break
        try:
            return ray_tpu_torch.get(future, timeout=timeout)
        finally:
            self._return_actor(self._actor_of_ref.pop(future))

    def _return_actor(self, actor) -> None:
        if self._backlog:
            fn, value = self._backlog.pop(0)
            future = fn(actor, value)
            self._actor_of_ref[future] = actor
            self._ref_of_submit_idx[self._submit_counter] = future
            self._submit_counter += 1
        else:
            self._idle.append(actor)

    # -- map frontends ---------------------------------------------------
    def map(self, fn: Callable[[Any, V], Any],
            values: Iterable[V]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any],
                      values: Iterable[V]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ------------------------------------------------------
    def push(self, actor) -> None:
        self._idle.append(actor)
        if self._backlog:
            self._return_actor(self._idle.pop())

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
