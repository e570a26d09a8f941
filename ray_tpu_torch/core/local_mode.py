"""The in-process runtime: the full task/actor/object API inside one
process, the port of `ray_tpu/core/local_mode.py`.

Tasks run on an elastic thread pool so concurrency semantics (wait, actor
ordering, async actors, streaming generators, nested get) match a cluster.
Values round-trip through serialization (`core/serialization.py`), so this
runtime catches serialization faults too.

Two things differ from the reference, both about ending:

- `kill_actor` does to the actor's calls what a process's death does:
  pending and later calls fail with `ActorDiedError`, its event loop
  (its coroutines cancelled) and its executor stop, and its instance is
  dropped. A thread the user's object started itself cannot be stopped
  from outside in one process; it lives on with whatever it holds.
- `shutdown` ends every thread the runtime started: it fails every
  unresolved object and stream (so a thread blocked in `get` wakes),
  stops every actor as `kill_actor` does, and joins the pool, each
  actor's loop thread and executor within a deadline. The interpreter
  then exits with nothing of the runtime left to join.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import os
import queue as queue_mod
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.generator import ObjectRefGenerator
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, _Counter
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    RaySystemError,
    RayTaskError,
    TaskCancelledError,
)
from ray_tpu_torch.runtime_context import (_reset_task_context,
                                           _set_task_context)

_pool_local = threading.local()

# How long shutdown waits, in all, for the runtime's threads to end.
SHUTDOWN_JOIN_S = 10.0
# How often a thread waiting on an actor's loop looks whether the actor
# died under it (a killed actor's loop never answers).
_ALIVE_POLL_S = 0.5


class _ElasticPool:
    """Task thread pool that grows when a worker blocks in `get`.

    The in-process analogue of a raylet starting extra workers when
    leased workers block on `get` of not-yet-ready objects — it prevents
    nested-task deadlock at any dependency depth.
    """

    def __init__(self, size: int, max_size: int = 1024,
                 name: str = "task"):
        self._q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._threads: List[threading.Thread] = []
        self._max = max_size
        self._shutdown = False
        self._name = name
        for _ in range(size):
            self._spawn()

    def _spawn(self) -> None:
        with self._lock:
            if len(self._threads) >= self._max or self._shutdown:
                return
            t = threading.Thread(
                target=self._loop, daemon=True,
                name=f"{self._name}-{len(self._threads) + 1}")
            self._threads.append(t)
        t.start()

    def _loop(self) -> None:
        _pool_local.pool = self
        while True:
            with self._lock:
                self._idle += 1
            item = self._q.get()
            with self._lock:
                self._idle -= 1
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fn()
                fut.set_result(None)
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

    def submit(self, fn) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, fn))
        return fut

    def notify_blocked(self) -> None:
        """Called when a pool thread is about to block; keep one spare."""
        with self._lock:
            need = self._idle == 0 and not self._shutdown
        if need:
            self._spawn()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            n = len(self._threads)
        for _ in range(n):
            self._q.put(None)

    def join(self, deadline: float) -> None:
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))


class _LocalActor:
    """One actor: its instance, an executor bounded by max_concurrency,
    and, for an async actor, an event loop on a thread of its own."""

    def __init__(self, actor_id: ActorID, cls: type, instance: Any,
                 max_concurrency: int, is_async: bool):
        self.actor_id = actor_id
        self.cls = cls
        self.instance = instance
        self.alive = True
        self.is_async = is_async
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.thread: Optional[threading.Thread] = None
        if is_async:
            self.loop = asyncio.new_event_loop()
            self.thread = threading.Thread(
                target=self._run_loop, daemon=True,
                name=f"actor-loop-{cls.__name__}")
            self.thread.start()
        # Async actors also get a bounded pool: it runs the bridging wait on
        # each coroutine so max_concurrency actually bounds in-flight calls.
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_concurrency,
            thread_name_prefix=f"actor-{cls.__name__}")
        # task_id -> (num_returns, streaming generator or None) of every
        # call not yet finished: what a kill fails.
        self.pending: Dict[TaskID, Tuple[int, Optional[ObjectRefGenerator]]] \
            = {}
        self.lock = threading.Lock()

    def _run_loop(self) -> None:
        loop = self.loop
        asyncio.set_event_loop(loop)
        try:
            loop.run_forever()
        finally:
            # asyncio.run's own clean-up: cancel what is left, close the
            # async generators and the loop's default executor.
            try:
                tasks = asyncio.all_tasks(loop)
                for t in tasks:
                    t.cancel()
                if tasks:
                    loop.run_until_complete(
                        asyncio.gather(*tasks, return_exceptions=True))
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.run_until_complete(
                    loop.shutdown_default_executor(SHUTDOWN_JOIN_S))
            finally:
                loop.close()

    def await_on_loop(self, coro):
        """Run `coro` on the actor's loop and wait for it from this
        thread; raises ActorDiedError if the actor dies meanwhile."""
        try:
            cf = asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:      # the loop is closed
            coro.close()
            raise ActorDiedError(self.actor_id)
        while True:
            try:
                return cf.result(timeout=_ALIVE_POLL_S)
            except concurrent.futures.TimeoutError:
                if not self.alive:
                    cf.cancel()
                    raise ActorDiedError(self.actor_id)
            except concurrent.futures.CancelledError:
                raise ActorDiedError(self.actor_id)

    def stop(self) -> List[Tuple[TaskID, int, Optional[ObjectRefGenerator]]]:
        """Mark dead, stop the loop and the executor (queued calls are
        cancelled), drop the instance; returns the calls that were still
        pending, for the runtime to fail."""
        with self.lock:
            self.alive = False
            pending = [(tid, n, gen) for tid, (n, gen)
                       in self.pending.items()]
            self.pending.clear()
        if self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except RuntimeError:
                pass              # already closed
        self.executor.shutdown(wait=False, cancel_futures=True)
        self.instance = None
        return pending

    def join(self, deadline: float) -> None:
        me = threading.current_thread()
        threads = list(getattr(self.executor, "_threads", ()))
        if self.thread is not None:
            threads.append(self.thread)
        for t in threads:
            if t is not me:
                t.join(max(0.0, deadline - time.monotonic()))


class LocalModeRuntime:
    """Implements the Runtime interface entirely in-process."""

    is_local_mode = True

    def __init__(self, num_cpus: Optional[int] = None,
                 namespace: Optional[str] = None, **_: Any):
        self.job_id = JobID.from_int(1)
        self.namespace = namespace or "default"
        n = num_cpus or os.cpu_count() or 4
        self._pool = _ElasticPool(max(n, 4))
        self._objects: Dict[ObjectID, concurrent.futures.Future] = {}
        # Re-entrant: a collection inside a critical section (a Future's
        # allocation) may run an ObjectRef's __del__, which releases its
        # reference under this lock on the same thread.
        self._objects_lock = threading.RLock()
        self._refcounts: Dict[ObjectID, int] = {}
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actor_meta: Dict[ActorID, Tuple[str, dict]] = {}
        self._put_counter = _Counter()
        self._task_futures: Dict[TaskID, concurrent.futures.Future] = {}
        self._task_returns: Dict[TaskID, List[ObjectID]] = {}
        self._generators: "weakref.WeakSet[ObjectRefGenerator]" = \
            weakref.WeakSet()
        self._kv: Dict[bytes, bytes] = {}
        self._placement_groups: Dict[str, dict] = {}
        self._num_cpus = n
        self._shutdown = False
        # Set once at shutdown: threads of Serve that outlive a call
        # (router pollers, the proxy's route refresh) wait on it.
        self.shutdown_event = threading.Event()

    # -- reference counting ----------------------------------------------
    # Local refcounts drive release of stored values. A count reaching zero
    # frees the bytes.
    def add_local_reference(self, object_id: ObjectID) -> None:
        with self._objects_lock:
            self._refcounts[object_id] = self._refcounts.get(object_id, 0) + 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        with self._objects_lock:
            n = self._refcounts.get(object_id, 0) - 1
            if n > 0:
                self._refcounts[object_id] = n
            else:
                self._refcounts.pop(object_id, None)
                fut = self._objects.get(object_id)
                # Only free resolved objects; in-flight task stores recreate
                # the entry (bounded by in-flight tasks, cleaned at shutdown).
                if fut is not None and fut.done():
                    del self._objects[object_id]

    def on_ref_deserialized(self, ref: ObjectRef) -> None:
        self.add_local_reference(ref.id())

    # -- objects ---------------------------------------------------------
    def _store(self, object_id: ObjectID, value: Any,
               is_error: bool = False) -> None:
        fut = self._object_future(object_id)
        if fut.done():
            return                # a kill or shutdown answered first
        try:
            so = (serialization.serialize_error(value) if is_error
                  else serialization.serialize(value))
            fut.set_result(so.to_bytes())
        except concurrent.futures.InvalidStateError:
            pass

    def _object_future(self, object_id: ObjectID) -> concurrent.futures.Future:
        with self._objects_lock:
            fut = self._objects.get(object_id)
            if fut is None:
                fut = concurrent.futures.Future()
                if self._shutdown:
                    fut.set_result(_shutdown_error_bytes())
                self._objects[object_id] = fut
            return fut

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        task_id = TaskID.for_task(self.job_id)
        object_id = ObjectID.for_put(task_id, self._put_counter.next())
        self._store(object_id, value)
        return ObjectRef(object_id, runtime=self)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, (ObjectRef, ObjectRefGenerator))
        if not single and not hasattr(refs, "__iter__"):
            raise TypeError(
                "get() expects an ObjectRef or a list of ObjectRefs, got "
                f"{type(refs).__name__}")
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        values: List[Any] = []
        for ref in ref_list:
            if isinstance(ref, ObjectRefGenerator):
                raise TypeError("Cannot get() an ObjectRefGenerator; iterate it.")
            if not isinstance(ref, ObjectRef):
                raise TypeError(
                    f"get() expects ObjectRef(s), got {type(ref).__name__}")
            fut = self._object_future(ref.id())
            if not fut.done():
                pool = getattr(_pool_local, "pool", None)
                if pool is not None:
                    pool.notify_blocked()
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                data = fut.result(timeout=remaining)
            except concurrent.futures.TimeoutError:
                raise GetTimeoutError(
                    f"Get timed out after {timeout}s waiting for {ref}")
            values.append(serialization.deserialize(data))
        return values[0] if single else values

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        refs = list(refs)
        if len(set(refs)) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            progressed = False
            for ref in list(pending):
                if self._object_future(ref.id()).done():
                    ready.append(ref)
                    pending.remove(ref)
                    progressed = True
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not progressed:
                time.sleep(0.001)
        # Contract: at most num_returns in ready.
        if len(ready) > num_returns:
            extra = ready[num_returns:]
            ready = ready[:num_returns]
            pending = extra + pending
        return ready, pending

    # -- tasks -----------------------------------------------------------
    def _resolve_args(self, args, kwargs):
        def resolve(v):
            return self.get(v) if isinstance(v, ObjectRef) else v

        return ([resolve(a) for a in args],
                {k: resolve(v) for k, v in kwargs.items()})

    def _make_return_refs(self, task_id: TaskID, n: int) -> List[ObjectRef]:
        return [ObjectRef(ObjectID.for_return(task_id, i + 1), runtime=self)
                for i in range(n)]

    def _store_returns(self, task_id: TaskID, num_returns: int, result) -> None:
        if num_returns == 0:
            return
        if num_returns == 1:
            self._store(ObjectID.for_return(task_id, 1), result)
        else:
            if not isinstance(result, (tuple, list)) or len(result) != num_returns:
                err = ValueError(
                    f"Task declared num_returns={num_returns} but returned "
                    f"{type(result).__name__} of length "
                    f"{len(result) if hasattr(result, '__len__') else 'n/a'}")
                for i in range(num_returns):
                    self._store(ObjectID.for_return(task_id, i + 1),
                                RayTaskError.from_exception("task", err),
                                is_error=True)
                return
            for i, v in enumerate(result):
                self._store(ObjectID.for_return(task_id, i + 1), v)

    def _store_error(self, task_id: TaskID, num_returns: int,
                     name: str, exc: BaseException) -> None:
        wrapped = (exc if isinstance(exc, (RayTaskError, TaskCancelledError,
                                           ActorDiedError))
                   else RayTaskError.from_exception(name, exc))
        for i in range(max(num_returns, 1)):
            self._store(ObjectID.for_return(task_id, i + 1), wrapped,
                        is_error=True)

    def _new_generator(self) -> ObjectRefGenerator:
        gen = ObjectRefGenerator()
        if self._shutdown:
            gen._finish(RaySystemError("the runtime was shut down"))
        self._generators.add(gen)
        return gen

    def _run_streaming_body(self, task_id: TaskID, name: str,
                            gen: ObjectRefGenerator, produce,
                            **ctx_kwargs) -> None:
        token = _set_task_context(task_id=task_id, **ctx_kwargs)
        try:
            idx = 0
            for item in produce():
                if gen.completed():
                    break         # killed or shut down under the stream
                idx += 1
                oid = ObjectID.for_return(task_id, idx)
                self._store(oid, item)
                gen._push(ObjectRef(oid, runtime=self))
            gen._finish()
        except BaseException as e:  # noqa: BLE001
            gen._finish(e if isinstance(e, (RayTaskError, ActorDiedError))
                        else RayTaskError.from_exception(name, e))
        finally:
            _reset_task_context(token)

    def submit_task(self, remote_function, opts, args, kwargs):
        task_id = TaskID.for_task(self.job_id)
        fn = remote_function._function
        name = remote_function._function_name

        if opts.num_returns in ("streaming", "dynamic"):
            gen = self._new_generator()

            def produce():
                rargs, rkwargs = self._resolve_args(args, kwargs)
                return fn(*rargs, **rkwargs)

            self._task_futures[task_id] = self._pool.submit(
                lambda: self._run_streaming_body(task_id, name, gen, produce))
            return gen

        num_returns = opts.num_returns

        def run():
            from ray_tpu_torch.core.task_events import task_event_buffer

            token = _set_task_context(task_id=task_id)
            buf = task_event_buffer()
            job = self.job_id.hex()
            buf.record(task_id.hex(), name, "RUNNING", job_id=job,
                       node_id="local", worker_id="local")
            ok = False
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                result = fn(*rargs, **rkwargs)
                self._store_returns(task_id, num_returns, result)
                ok = True
            except BaseException as e:  # noqa: BLE001
                self._store_error(task_id, num_returns, name, e)
            finally:
                buf.record(task_id.hex(), name,
                           "FINISHED" if ok else "FAILED", job_id=job,
                           node_id="local", worker_id="local")
                _reset_task_context(token)

        from ray_tpu_torch.core.task_events import task_event_buffer

        task_event_buffer().record(
            task_id.hex(), name, "SUBMITTED", job_id=self.job_id.hex(),
            node_id="local", worker_id="local")
        self._task_futures[task_id] = self._pool.submit(run)
        refs = self._make_return_refs(task_id, max(num_returns, 1))
        self._task_returns[task_id] = [r.id() for r in refs]
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    # -- placement groups (single node: reservation is a table entry) ----
    def create_placement_group(self, bundles, strategy="PACK", name="",
                               target_node_ids=None) -> str:
        from ray_tpu_torch.core.ids import PlacementGroupID
        from ray_tpu_torch.core.pg_scheduler import validate_pg_args

        validate_pg_args(bundles, strategy)
        pg_id = PlacementGroupID.of(self.job_id).hex()
        self._placement_groups[pg_id] = {
            "pg_id": pg_id, "bundles": [dict(b) for b in bundles],
            "strategy": strategy, "name": name, "state": "CREATED",
            "bundle_locations": [{"node_id": "local", "address": "local"}
                                 for _ in bundles],
        }
        return pg_id

    def placement_group_wait(self, pg_id, timeout=None) -> bool:
        info = self._placement_groups.get(pg_id)
        return bool(info and info["state"] == "CREATED")

    def remove_placement_group(self, pg_id) -> None:
        info = self._placement_groups.get(pg_id)
        if info is not None:
            info["state"] = "REMOVED"

    def placement_group_table(self, pg_id=None):
        table = self._placement_groups
        return table.get(pg_id) if pg_id is not None else dict(table)

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True) -> None:
        task_id = ref.id().task_id()
        fut = self._task_futures.get(task_id)
        if fut is not None and fut.cancel():
            # Resolve every sibling return ref, not just the one passed in.
            for oid in self._task_returns.get(task_id, [ref.id()]):
                self._store(oid, TaskCancelledError(task_id), is_error=True)

    # -- actors ----------------------------------------------------------
    def create_actor(self, actor_class, opts, args, kwargs):
        from ray_tpu_torch.core.actor import ActorHandle

        if self._shutdown:
            raise RaySystemError("the runtime was shut down")
        actor_id = ActorID.of(self.job_id)
        cls = actor_class._cls
        key = None
        if opts.name:
            key = (self.namespace if opts.namespace is None else opts.namespace,
                   opts.name)
            if key in self._named_actors:
                raise ValueError(
                    f"Actor with name '{opts.name}' already exists in "
                    f"namespace '{key[0]}'")

        meta = actor_class.method_meta()
        is_async = any(m.get("is_async") for m in meta.values())
        max_concurrency = opts.max_concurrency or (100 if is_async else 1)

        # The constructor runs in the caller's thread, as the reference's
        # local mode does: creation returns once __init__ has.
        rargs, rkwargs = self._resolve_args(args, kwargs)
        instance = cls(*rargs, **rkwargs)
        actor = _LocalActor(actor_id, cls, instance, max_concurrency, is_async)
        self._actors[actor_id] = actor
        self._actor_meta[actor_id] = (cls.__name__, meta)
        if key is not None:
            # Register only after __init__ succeeded so a failing constructor
            # doesn't leak the name.
            self._named_actors[key] = actor_id
        return ActorHandle(actor_id, cls.__name__, meta, runtime=self)

    def _fail_call(self, task_id: TaskID, num_returns: int,
                   gen: Optional[ObjectRefGenerator],
                   err: BaseException) -> None:
        if gen is not None:
            gen._finish(err)
        else:
            for i in range(max(num_returns, 1)):
                self._store(ObjectID.for_return(task_id, i + 1), err,
                            is_error=True)

    def submit_actor_task(self, handle, method_name, opts, args, kwargs):
        actor = self._actors.get(handle._ray_actor_id)
        task_id = TaskID.for_actor_task(handle._ray_actor_id)
        num_returns = opts.num_returns
        streaming = num_returns in ("streaming", "dynamic")
        gen = self._new_generator() if streaming else None
        refs = ([] if streaming
                else self._make_return_refs(task_id, max(num_returns, 1)))

        def result():
            if streaming:
                return gen
            if num_returns == 0:
                return None
            return refs[0] if num_returns == 1 else refs

        if actor is None or not actor.alive:
            self._fail_call(task_id, num_returns, gen,
                            ActorDiedError(handle._ray_actor_id))
            return result()

        name = f"{actor.cls.__name__}.{method_name}"

        def call_method():
            """Invoke the method; bridge coroutines / async gens to the
            actor's event loop. Context is set inside the coroutine (each
            asyncio task gets its own contextvars copy)."""
            instance = actor.instance
            if not actor.alive or instance is None:
                raise ActorDiedError(actor.actor_id)
            rargs, rkwargs = self._resolve_args(args, kwargs)
            if method_name == "__ray_call__":
                fn, rargs = rargs[0], rargs[1:]
                out = fn(instance, *rargs, **rkwargs)
            else:
                out = getattr(instance, method_name)(*rargs, **rkwargs)
            if inspect.iscoroutine(out):
                coro = out

                async def with_ctx():
                    token = _set_task_context(
                        task_id=task_id, actor_id=actor.actor_id,
                        actor_handle=handle)
                    try:
                        return await coro
                    finally:
                        _reset_task_context(token)

                return actor.await_on_loop(with_ctx())
            if inspect.isasyncgen(out):
                return _sync_iter_async_gen(out, actor)
            return out

        if streaming:
            def run():
                try:
                    self._run_streaming_body(
                        task_id, name, gen, call_method,
                        actor_id=actor.actor_id, actor_handle=handle)
                finally:
                    with actor.lock:
                        actor.pending.pop(task_id, None)
        else:
            def run():
                token = _set_task_context(task_id=task_id,
                                          actor_id=actor.actor_id,
                                          actor_handle=handle)
                try:
                    self._store_returns(task_id, num_returns, call_method())
                except BaseException as e:  # noqa: BLE001
                    self._store_error(task_id, num_returns, name, e)
                finally:
                    _reset_task_context(token)
                    with actor.lock:
                        actor.pending.pop(task_id, None)

        with actor.lock:
            submitted = actor.alive
            if submitted:
                actor.pending[task_id] = (num_returns, gen)
                try:
                    actor.executor.submit(run)
                except RuntimeError:   # the executor was shut down
                    actor.pending.pop(task_id, None)
                    submitted = False
        if not submitted:
            self._fail_call(task_id, num_returns, gen,
                            ActorDiedError(handle._ray_actor_id))
        return result()

    def _stop_actor(self, actor: _LocalActor,
                    err: BaseException) -> None:
        for task_id, num_returns, gen in actor.stop():
            self._fail_call(task_id, num_returns, gen, err)

    def kill_actor(self, handle, no_restart: bool = True) -> None:
        actor_id = handle._ray_actor_id
        actor = self._actors.pop(actor_id, None)
        for key, aid in list(self._named_actors.items()):
            if aid == actor_id:
                del self._named_actors[key]
        if actor is None:
            return
        self._stop_actor(actor, ActorDiedError(
            actor_id, "The actor was killed by kill()."))
        actor.join(time.monotonic() + SHUTDOWN_JOIN_S)

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.core.actor import ActorHandle

        key = (namespace or self.namespace, name)
        actor_id = self._named_actors.get(key)
        if actor_id is None:
            raise ValueError(f"Failed to look up actor with name '{name}'")
        class_name, meta = self._actor_meta[actor_id]
        return ActorHandle(actor_id, class_name, meta, runtime=self)

    # -- cluster introspection -------------------------------------------
    def nodes(self) -> List[dict]:
        return [{
            "NodeID": "local",
            "Alive": True,
            "Resources": self.cluster_resources(),
            "NodeManagerHostname": os.uname().nodename,
            "IsHeadNode": True,
        }]

    def cluster_resources(self) -> Dict[str, float]:
        import torch

        res = {"CPU": float(self._num_cpus), "memory": 1e9,
               "object_store_memory": 1e9}
        gpus = torch.cuda.device_count()
        if gpus:
            res["GPU"] = float(gpus)
        return res

    def available_resources(self) -> Dict[str, float]:
        return self.cluster_resources()

    def task_events(self, job_id: Optional[str] = None):
        from ray_tpu_torch.core.task_events import task_event_buffer

        return task_event_buffer().snapshot(job_id)

    def timeline(self, filename: Optional[str] = None):
        """Chrome-trace export of the in-process task events."""
        from ray_tpu_torch.core.task_events import (events_to_chrome_trace,
                                                    write_trace)

        trace = events_to_chrome_trace(
            self.task_events(self.job_id.hex()))
        return write_trace(trace, filename)

    # -- internal kv -------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        if not overwrite and key in self._kv:
            return False
        self._kv[key] = value
        return True

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def kv_del(self, key: bytes) -> None:
        self._kv.pop(key, None)

    def kv_keys(self, prefix: bytes) -> List[bytes]:
        return [k for k in self._kv if k.startswith(prefix)]

    def shutdown(self) -> None:
        """End every thread of the runtime: fail what is unresolved, stop
        every actor, then join the pool and the actors' threads."""
        if self._shutdown:
            return
        self._shutdown = True
        self.shutdown_event.set()
        actors = list(self._actors.values())
        self._actors.clear()
        self._named_actors.clear()
        err = RaySystemError("the runtime was shut down")
        for actor in actors:
            self._stop_actor(actor, err)
        with self._objects_lock:
            futs = list(self._objects.values())
        blob = _shutdown_error_bytes()
        for fut in futs:
            if not fut.done():
                try:
                    fut.set_result(blob)
                except concurrent.futures.InvalidStateError:
                    pass
        for gen in list(self._generators):
            gen._finish(err)
        self._pool.shutdown()
        deadline = time.monotonic() + SHUTDOWN_JOIN_S
        for actor in actors:
            actor.join(deadline)
        self._pool.join(deadline)
        self._objects.clear()
        self._refcounts.clear()
        self._task_futures.clear()
        self._task_returns.clear()


def _shutdown_error_bytes() -> bytes:
    return serialization.serialize_error(
        RaySystemError("the runtime was shut down")).to_bytes()


def _sync_iter_async_gen(agen, actor: _LocalActor):
    """Drain an async generator from a sync thread via the actor's loop."""
    while True:
        try:
            yield actor.await_on_loop(agen.__anext__())
        except StopAsyncIteration:
            return
