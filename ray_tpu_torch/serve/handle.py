"""DeploymentHandle: the Python-native way to call a deployment.

Reference equivalent: `python/ray/serve/handle.py` (DeploymentHandle /
DeploymentResponse), ported from `ray_tpu/serve/handle.py`.
`handle.remote(...)` routes through the power-of-two router and returns a
DeploymentResponse whose `result()` blocks; `.options(method_name=...)`
targets a specific method. Handles pickle cleanly (actor args, closures)
and rebuild their router lazily. Values are read through the runtime that
made their refs, never a new one.

A request that reaches a draining replica is sent again to a live one, as
the reference does; so is one that reaches a replica killed under it (the
in-process runtime fails a dead actor's pending calls, as a process's
death would, and the controller kills a replica only after draining it).
A stream is sent again only before its first item.
"""

from __future__ import annotations

import time
from typing import Any, Optional


def _retryable(e: BaseException) -> bool:
    """A drain or a replica death, raised as is or as a task error's
    cause (a stream's error is not unwrapped)."""
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.serve.exceptions import ReplicaDrainingError

    kinds = (ReplicaDrainingError, ActorDiedError)
    return isinstance(e, kinds) or isinstance(getattr(e, "cause", None),
                                              kinds)


def _get(ref, timeout: Optional[float] = None) -> Any:
    """`get` on the runtime that made `ref`."""
    rt = ref._runtime
    if rt is None:
        from ray_tpu_torch.core.worker import current_runtime

        rt = current_runtime()
    return rt.get(ref, timeout=timeout)


class DeploymentResponse:
    def __init__(self, handle: "DeploymentHandle", replica_id: str, ref):
        self._handle = handle
        self._replica_id = replica_id
        self._ref = ref
        self._done = False

    def __await__(self):
        """Awaitable inside async deployments (reference:
        DeploymentResponse.__await__ — the composition data path). Runs
        the same drain-retry protocol as result(), without blocking the
        replica's event loop."""
        return self._async_result().__await__()

    async def _async_result(self) -> Any:
        import asyncio

        while True:
            try:
                value = await asyncio.wrap_future(self._ref.future())
                self._complete()
                return value
            except BaseException as e:
                self._complete()
                if not _retryable(e):
                    raise
                self._handle._router.invalidate()
                new = self._handle.remote_method(
                    self._handle._method_name, self._args, self._kwargs)
                self._replica_id = new._replica_id
                self._ref = new._ref
                self._done = False

    def result(self, timeout_s: Optional[float] = None) -> Any:
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            try:
                value = _get(self._ref, timeout=timeout_s)
                self._complete()
                return value
            except BaseException as e:
                # Application errors and timeouts still finish the
                # request from the router's perspective — without this
                # the inflight count leaks and power-of-two steers away
                # from the replica forever.
                self._complete()
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if not _retryable(e) or (remaining is not None
                                         and remaining <= 0):
                    raise
                # The replica started draining (or died) between routing
                # and execution: retry on a live one (reference: router
                # retries RayActorError/drain).
                self._handle._router.invalidate()
                new = self._handle.remote_method(
                    self._handle._method_name, self._args, self._kwargs)
                self._replica_id = new._replica_id
                self._ref = new._ref
                # The retry is a fresh assignment with its own inflight
                # count — arm completion again for the new replica.
                self._done = False

    def _complete(self) -> None:
        if not self._done:
            self._done = True
            self._handle._router.complete(self._replica_id)

    @property
    def object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming counterpart of DeploymentResponse (reference:
    serve.handle DeploymentResponseGenerator): wraps the replica's
    ObjectRefGenerator; iterating yields VALUES as the replica produces
    them — synchronously (`for item in gen`) or asynchronously
    (`async for item in gen`). The router's in-flight count completes
    when the stream exhausts, errors, or is closed."""

    def __init__(self, handle: "DeploymentHandle", replica_id: str, gen,
                 method_name: str = "__call__", args=(), kwargs=None):
        self._handle = handle
        self._replica_id = replica_id
        self._gen = gen
        self._done = False
        self._started = False
        self._method_name = method_name
        self._args, self._kwargs = args, kwargs or {}

    def _complete(self) -> None:
        if not self._done:
            self._done = True
            self._handle._router.complete(self._replica_id)

    def completed(self) -> bool:
        """True once the replica finished producing (the underlying
        generator task is done)."""
        return self._gen.completed()

    def _resend(self) -> None:
        """Assign the request again (nothing of it was yielded yet)."""
        self._complete()
        self._handle._router.invalidate()
        new = self._handle.remote_method(self._method_name, self._args,
                                         self._kwargs)
        self._replica_id, self._gen = new._replica_id, new._gen
        self._done = False

    def _next_value(self, it, end):
        """The next item's value, or `end`; a drain or death before the
        first item re-sends the request."""
        while True:
            try:
                ref = next(it, end)
                return ref if ref is end else _get(ref, timeout=60)
            except BaseException as e:
                if self._started or not _retryable(e):
                    raise
                self._resend()
                it = self._it = iter(self._gen)

    def __iter__(self):
        end = object()
        self._it = iter(self._gen)
        try:
            while True:
                value = self._next_value(self._it, end)
                if value is end:
                    return
                self._started = True
                yield value
        finally:
            self._complete()

    async def __aiter__(self):
        import asyncio

        end = object()   # StopIteration cannot cross a Future boundary
        self._it = iter(self._gen)
        try:
            while True:
                value = await asyncio.to_thread(
                    lambda: self._next_value(self._it, end))
                if value is end:
                    return
                self._started = True
                yield value
        finally:
            self._complete()

    @property
    def object_ref_generator(self):
        return self._gen


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller_handle,
                 method_name: str = "__call__",
                 multiplexed_model_id: str = "",
                 stream: bool = False,
                 session_id: str = ""):
        self.deployment_name = deployment_name
        self._controller = controller_handle
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        self._session_id = session_id
        # Shared one-slot holder: every options() variant of this handle
        # uses the SAME Router (and its poller thread + model-affinity
        # cache) — a per-request options() call must never mint routers.
        self.__router_slot: list = [None]

    @property
    def _router(self):
        if self.__router_slot[0] is None:
            from ray_tpu_torch.serve._private.router import Router

            self.__router_slot[0] = Router(self._controller,
                                           self.deployment_name)
        return self.__router_slot[0]

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                session_id: Optional[str] = None) -> "DeploymentHandle":
        """Per-request options (reference: handle.options): method_name
        routes to a named method; multiplexed_model_id tags the request
        for model-multiplexed replicas and makes the router prefer the
        replica that served that model last (the multiplex hooks on the
        replica come with the gRPC ingress slice);
        stream=True makes `.remote()` return a
        DeploymentResponseGenerator that yields items as the replica's
        generator produces them (token streaming); session_id pins a
        conversation to one replica (sticky sessions: its KV-cache
        history lives there — re-routing costs a full re-prefill)."""
        dup = DeploymentHandle(
            self.deployment_name, self._controller,
            method_name=(self._method_name if method_name is None
                         else method_name),
            multiplexed_model_id=(
                self._multiplexed_model_id
                if multiplexed_model_id is None else multiplexed_model_id),
            stream=self._stream if stream is None else stream,
            session_id=(self._session_id if session_id is None
                        else session_id))
        dup._DeploymentHandle__router_slot = self.__router_slot
        return dup

    def remote(self, *args, **kwargs):
        return self.remote_method(self._method_name, args, kwargs)

    def remote_method(self, method_name: str, args, kwargs):
        if self._stream:
            replica_id, gen = self._router.assign(
                method_name, args, kwargs,
                model_id=self._multiplexed_model_id or None,
                session_id=self._session_id or None,
                streaming=True)
            return DeploymentResponseGenerator(self, replica_id, gen,
                                               method_name, args, kwargs)
        replica_id, ref = self._router.assign(
            method_name, args, kwargs,
            model_id=self._multiplexed_model_id or None,
            session_id=self._session_id or None)
        resp = DeploymentResponse(self, replica_id, ref)
        resp._args, resp._kwargs = args, kwargs
        return resp

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self._controller,
                 self._method_name, self._multiplexed_model_id,
                 self._stream, self._session_id))
