"""Serve replica actor: wraps one instance of the user's deployment class.

Reference equivalent: `python/ray/serve/_private/replica.py` — tracks
ongoing requests (the router's and autoscaler's signal), runs sync user
code off the event loop, and drains gracefully before shutdown so rolling
updates drop nothing. Ported from `ray_tpu/serve/_private/replica.py`
without the model-multiplex hooks, which come with the gRPC ingress.
"""

from __future__ import annotations

import asyncio
import contextlib
import inspect
import time
from typing import Any, Dict, Optional, Tuple


def _resolve_handle_markers(value):
    """Swap composition markers (serve._HandleMarker) for live
    DeploymentHandles (reference: the replica-side handle injection of
    the deployment graph). Uses the same _map_tree walker as the
    deploy-side substitution."""
    from ray_tpu_torch.serve import _HandleMarker, _map_tree
    from ray_tpu_torch.serve.handle import DeploymentHandle

    controller = None  # one GCS lookup per resolution pass, not per marker

    def leaf(v):
        nonlocal controller
        if isinstance(v, _HandleMarker):
            if controller is None:
                from ray_tpu_torch.core.worker import get_actor
                from ray_tpu_torch.serve._private.controller import (
                    CONTROLLER_NAME)

                controller = get_actor(CONTROLLER_NAME)
            return DeploymentHandle(v.deployment_name, controller)
        return v

    return _map_tree(value, leaf)


class Replica:
    def __init__(self, cls_factory, init_args: Tuple, init_kwargs: Dict,
                 deployment_name: str, replica_id: str,
                 version: Optional[str]):
        init_args = _resolve_handle_markers(tuple(init_args))
        init_kwargs = _resolve_handle_markers(dict(init_kwargs))
        self._instance = cls_factory(*init_args, **init_kwargs)
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self.version = version
        self._ongoing = 0
        self._total = 0
        self._draining = False
        self._started_at = time.time()

    def _metric_tags(self) -> Dict[str, str]:
        return {"deployment": self.deployment_name,
                "replica": self.replica_id}

    # -- data plane ----------------------------------------------------
    @contextlib.contextmanager
    def _request_scope(self, method_name: str,
                       metadata: Optional[Dict],
                       streaming: bool = False):
        """Shared per-request bookkeeping for BOTH data-plane entry
        points: drain gate, ongoing/total counters, replica metrics, and
        the `serve.replica` span (explicit parent: async methods run on
        the actor's loop, outside the router's span context, so the
        proxy/router trace rides the request metadata)."""
        if self._draining:
            from ray_tpu_torch.serve.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(
                f"replica {self.replica_id} is draining")
        from ray_tpu_torch.serve._private.metrics import replica_metrics
        from ray_tpu_torch.util.tracing import span

        self._ongoing += 1
        self._total += 1
        try:
            metrics = replica_metrics()
            metrics["ongoing"].set(self._ongoing,
                                   tags=self._metric_tags())
        except Exception:
            metrics = None
        status = "ok"
        t0 = time.perf_counter()
        attributes = {"deployment": self.deployment_name,
                      "replica": self.replica_id,
                      "method": method_name,
                      "component": "replica"}
        if streaming:
            attributes["streaming"] = "1"
        try:
            with span("serve.replica",
                      parent=(metadata or {}).get("traceparent"),
                      attributes=attributes):
                yield
        except BaseException:
            status = "error"
            raise
        finally:
            self._ongoing -= 1
            if metrics is not None:
                try:
                    metrics["processed"].inc(
                        1, tags={**self._metric_tags(), "status": status})
                    metrics["latency"].observe(
                        time.perf_counter() - t0,
                        tags=self._metric_tags())
                    metrics["ongoing"].set(self._ongoing,
                                           tags=self._metric_tags())
                except Exception:
                    pass

    def _resolve_method(self, method_name: str):
        return (self._resolve_call() if method_name == "__call__"
                else getattr(self._instance, method_name))

    async def handle_request(self, method_name: str, args: Tuple,
                             kwargs: Dict,
                             metadata: Optional[Dict] = None) -> Any:
        with self._request_scope(method_name, metadata):
            method = self._resolve_method(method_name)
            if inspect.iscoroutinefunction(method):
                return await method(*args, **kwargs)
            # Sync user code must not block the replica's event loop.
            return await asyncio.to_thread(method, *args, **kwargs)

    def handle_request_streaming(self, method_name: str, args: Tuple,
                                 kwargs: Dict,
                                 metadata: Optional[Dict] = None):
        """Streaming data plane: a SYNC generator the runtime executes
        as a streaming actor task (`num_returns="streaming"`) — each
        yielded item becomes one ObjectRef pushed to the caller while
        generation continues, so time-to-first-token decouples from
        completion. User methods may be sync generators, async
        generators (pumped on a private loop — the executor thread that
        runs this has no ambient loop), or coroutines/callables whose
        return streams element-wise when iterable (str/bytes/dict count
        as ONE item)."""
        with self._request_scope(method_name, metadata, streaming=True):
            method = self._resolve_method(method_name)
            out = method(*args, **kwargs)
            yield from self._iterate_result(out)

    @staticmethod
    def _iterate_result(out):
        """Flatten any user return shape into a sync item stream."""
        import asyncio as _asyncio

        if inspect.iscoroutine(out):
            out = _asyncio.run(out)
        if inspect.isasyncgen(out):
            # Pump the async generator on a private loop owned by this
            # (executor) thread; each item crosses back synchronously.
            loop = _asyncio.new_event_loop()
            try:
                while True:
                    try:
                        yield loop.run_until_complete(out.__anext__())
                    except StopAsyncIteration:
                        break
            finally:
                loop.run_until_complete(out.aclose())
                loop.close()
        elif inspect.isgenerator(out) or (
                not isinstance(out, (str, bytes, dict))
                and hasattr(out, "__iter__")):
            yield from out
        else:
            yield out

    def _resolve_call(self):
        call = getattr(self._instance, "__call__", None)
        if call is None:
            raise TypeError(
                f"deployment {self.deployment_name} is not callable; "
                "define __call__ or route to a named method")
        return call

    def cgraph_call(self, value: Any, method_name: str = "__call__") -> Any:
        """Compiled-graph op: invoke the user callable synchronously on
        the replica's persistent loop thread (`serve.cgraph` compiles
        deployment chains into `cgraph` pipelines — no router, no
        per-request actor task). Coroutine deployments run to completion
        here: the loop thread has no ambient event loop."""
        method = (self._resolve_call() if method_name == "__call__"
                  else getattr(self._instance, method_name))
        self._total += 1
        out = method(value)
        if inspect.iscoroutine(out):
            return asyncio.run(out)
        return out

    # -- control plane -------------------------------------------------
    def queue_len(self) -> int:
        return self._ongoing

    def metrics(self) -> Dict[str, Any]:
        return {"replica_id": self.replica_id, "ongoing": self._ongoing,
                "total": self._total, "version": self.version,
                "draining": self._draining}

    def check_health(self) -> bool:
        probe = getattr(self._instance, "check_health", None)
        if probe is not None:
            probe()
        return True

    async def prepare_for_shutdown(self, timeout_s: float = 20.0) -> bool:
        """Stop accepting new requests, wait for in-flight to finish
        (reference: replica graceful_shutdown loop)."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while self._ongoing > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return self._ongoing == 0

    def reconfigure(self, user_config: Any) -> bool:
        hook = getattr(self._instance, "reconfigure", None)
        if hook is not None:
            hook(user_config)
        return True
