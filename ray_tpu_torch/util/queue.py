"""Distributed FIFO queue backed by an async actor, the port of
`ray_tpu/util/queue.py`.

Reference equivalent: `python/ray/util/queue.py` — same surface
(`put/get` with block/timeout, `put_nowait/get_nowait`, `size`, `empty`,
`full`, `qsize`, batch variants, `shutdown`). The queue's actor holds
the items it is given: a CUDA tensor lands on the actor's card, so a
queue that carries one leases a share of a GPU
(`actor_options={"num_gpus": ...}`), and the reader gets it back on its
own `cuda:0` (`core/serialization.py land_tensor`).
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for item in items:
            try:
                self._q.put_nowait(item)
                n += 1
            except asyncio.QueueFull:
                break
        return n

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def get_nowait_batch(self, max_items: int):
        out = []
        while len(out) < max_items:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, *,
                 actor_options: Optional[dict] = None):
        import ray_tpu_torch

        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        opts.setdefault("max_concurrency", 64)
        self._actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(
            maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        if not block:
            ok = ray_tpu_torch.get(self._actor.put_nowait.remote(item),
                             timeout=30)
            if not ok:
                raise Full()
            return
        ok = ray_tpu_torch.get(self._actor.put.remote(item, timeout),
                         timeout=None if timeout is None
                         else timeout + 30)
        if not ok:
            raise Full()

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._actor.put_nowait_batch.remote(list(items)), timeout=60)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote(),
                                   timeout=30)
            if not ok:
                raise Empty()
            return item
        ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout),
                               timeout=None if timeout is None
                               else timeout + 30)
        if not ok:
            raise Empty()
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._actor.get_nowait_batch.remote(max_items), timeout=60)

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    size = qsize

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.full.remote(), timeout=30)

    def shutdown(self) -> None:
        import ray_tpu_torch

        ray_tpu_torch.kill(self._actor)
