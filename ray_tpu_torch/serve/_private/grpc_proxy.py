"""gRPC ingress: the non-HTTP data plane, the port of
`ray_tpu/serve/_private/grpc_proxy.py`.

Reference equivalent: the gRPC proxy of
`python/ray/serve/_private/proxy.py` (gRPCProxy) + `serve.start(
grpc_options=...)`. No protoc codegen: a generic method handler serves

    /ray_tpu.serve.ServeAPIService/Call

with msgpack-framed request metadata and pickled payloads. Request
metadata also rides gRPC metadata headers (`application`, `method_name`,
`multiplexed_model_id`) so non-Python clients can route without
understanding the body encoding. The bytes on the wire are the
reference's: msgpack comes from the port's own codec (`core/codec.py`),
so the reference's `GrpcServeClient` talks to this ingress and this
module's client to the reference's.

SECURITY / TRUST BOUNDARY: the default `payload` field is **unpickled
server-side**, and unpickling attacker-controlled bytes is arbitrary code
execution. The ingress carries the trust model of every other port of
the runtime (raylet RPC, GCS, object transfer): it MUST only be reachable
from a trusted network. It binds 127.0.0.1 by default; if you expose it
wider, put authentication in front of it. Non-Python clients (which
cannot produce pickle anyway) use the `msgpack_payload` field —
msgpack-native `[args, kwargs]` — and an ingress started with
`allow_pickle=False` (`serve.start_grpc_ingress(allow_pickle=False)`)
rejects pickled payloads instead of loading them and answers in
msgpack-native form only.

Request body : msgpack {app?, deployment?, method?, model_id?,
               payload: pickled (args, kwargs)            # trusted nets
               | msgpack_payload: [args, kwargs]}         # codec-safe
Response body: msgpack {ok: bool, payload?: pickled result
                        | msgpack_payload?: result, error?: str}
(the response mirrors the request's payload encoding)

`grpc` (the grpcio package) is imported only where the ingress starts or
a client connects; without it both raise `ImportError` naming grpcio.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import sys
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core import codec

logger = logging.getLogger(__name__)

SERVICE = "ray_tpu.serve.ServeAPIService"


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC ingress needs the grpcio package (import grpc "
            f"failed: {e}); it is not installed on this machine") from e
    return grpc


class GrpcIngress:
    """Serves deployment calls over gRPC (grpc.aio, generic handler) on a
    thread and event loop of its own."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 allow_pickle: bool = True):
        self._host, self._port = host, port
        # allow_pickle=False: msgpack-native payloads only — the ingress
        # never unpickles client bytes (see module docstring).
        self._allow_pickle = allow_pickle
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._handles: Dict[str, Any] = {}
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self._known_lock = threading.Lock()

    @property
    def port(self) -> int:
        return self._port

    def allows_pickle(self) -> bool:
        """Control-plane probe: lets start_grpc_ingress refuse to hand a
        pickle-enabled ingress to a caller that asked for the msgpack-only
        guarantee."""
        return self._allow_pickle

    # -- lifecycle ------------------------------------------------------
    def start(self) -> int:
        """Boot the aio server on a dedicated thread; returns the bound
        port. Idempotent — a second call returns the running port."""
        if self._started.is_set():
            return self._port
        _import_grpc()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-grpc-ingress")
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("gRPC ingress failed to start")
        if self._error is not None:
            raise RuntimeError(
                f"gRPC ingress failed to start: {self._error!r}")
        return self._port

    def _run(self) -> None:
        try:
            asyncio.run(self._serve())
        except BaseException as e:  # noqa: BLE001
            self._error = e
            self._started.set()

    async def _serve(self) -> None:
        grpc = _import_grpc()

        self._loop = asyncio.get_running_loop()
        handler = grpc.method_handlers_generic_handler(
            SERVICE,
            {"Call": grpc.unary_unary_rpc_method_handler(
                self._call,
                request_deserializer=None,     # raw bytes in/out
                response_serializer=None)})
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((handler,))
        self._port = self._server.add_insecure_port(
            f"{self._host}:{self._port}")
        await self._server.start()
        self._started.set()
        await self._server.wait_for_termination()

    def stop(self) -> None:
        """Stop the server (2 s grace) and join its thread."""
        if self._loop is not None and self._server is not None:
            async def _stop():
                await self._server.stop(grace=2.0)

            try:
                asyncio.run_coroutine_threadsafe(
                    _stop(), self._loop).result(timeout=10)
            except Exception:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- data plane -----------------------------------------------------
    _known: frozenset = frozenset()
    _known_at: float = 0.0

    def _known_deployment(self, name: str) -> bool:
        """Validate a CLIENT-SUPPLIED deployment name against the
        controller's table before it becomes a metric tag or a cached
        handle — arbitrary names per request must not mint unbounded
        metric series / handle-cache entries. Misses re-check the
        controller at most once per second: a just-deployed app is
        routable within ~1s while a bogus-name flood still costs one
        controller call per second, not per request. BLOCKING — callers
        on an event loop wrap it in asyncio.to_thread."""
        import time

        if name in self._known:
            return True
        # Single-flight + stamp-before-call: concurrent misses and
        # FAILED lookups must also be throttled, or an unknown-name
        # flood during a controller outage turns into one blocked
        # 10s controller call per request.
        with self._known_lock:
            if name in self._known:
                return True
            now = time.monotonic()
            if now - self._known_at < 1.0:
                return False
            self._known_at = now
            try:
                from ray_tpu_torch.core.worker import get, get_actor
                from ray_tpu_torch.serve._private.controller import (
                    CONTROLLER_NAME)

                controller = get_actor(CONTROLLER_NAME)
                status = get(controller.status.remote(), timeout=10)
                self._known = frozenset(status)
            except Exception:
                return False
            return name in self._known

    def _handle_for(self, deployment: str):
        handle = self._handles.get(deployment)
        if handle is None:
            from ray_tpu_torch import serve

            handle = serve.get_deployment_handle(deployment)
            self._handles[deployment] = handle
        return handle

    async def _call(self, request: bytes, context) -> bytes:
        import time

        from ray_tpu_torch.serve._private.metrics import proxy_metrics
        from ray_tpu_torch.util.tracing import span

        try:
            metrics = proxy_metrics()
        except Exception:
            metrics = None
        deployment = ""
        route_tag = "unmatched"
        status = "ok"
        msgpack_mode = False
        t0 = time.perf_counter()
        try:
            meta = {k: v for k, v in (context.invocation_metadata() or ())}
            req = codec.unpackb(request) if request else {}
            deployment = (req.get("app") or req.get("deployment")
                          or meta.get("application"))
            if not deployment:
                raise ValueError(
                    "no target: set 'app' in the request body or the "
                    "'application' metadata key")
            # to_thread: the cache-refresh path blocks on the controller
            # (up to 10s); it must not stall the ingress event loop.
            if not await asyncio.to_thread(self._known_deployment,
                                           deployment):
                raise ValueError(
                    f"unknown application {deployment!r}")
            route_tag = f"/{deployment}"
            method = (req.get("method") or meta.get("method_name")
                      or "__call__")
            model_id = (req.get("model_id")
                        or meta.get("multiplexed_model_id") or "")
            if req.get("msgpack_payload") is not None:
                # Codec-safe path: no pickle touches client bytes, and
                # the response answers in kind.
                msgpack_mode = True
                args, kwargs = req["msgpack_payload"]
                args = tuple(args)
                kwargs = dict(kwargs or {})
            elif req.get("payload") is not None:
                if not self._allow_pickle:
                    raise ValueError(
                        "this ingress runs with allow_pickle=False: "
                        "send msgpack_payload=[args, kwargs] instead of "
                        "a pickled payload")
                args, kwargs = pickle.loads(req["payload"])
            else:
                args, kwargs = (), {}
            handle = self._handle_for(deployment)
            if model_id:
                handle = handle.options(multiplexed_model_id=model_id)
            if method != "__call__":
                handle = handle.options(method_name=method)
            # One trace id across proxy -> router -> replica: the router
            # span nests under this one through the contextvar, which
            # to_thread copies into the worker thread.
            with span("serve.proxy",
                      parent=meta.get("traceparent"),
                      attributes={"ingress": "grpc",
                                  "deployment": deployment,
                                  "method": method,
                                  "component": "proxy"}):
                # Routing and the wait block a worker thread, not this
                # loop (nor a replica's).
                result = await asyncio.to_thread(
                    lambda: handle.remote(*args, **kwargs).result(60.0))
            if msgpack_mode or not self._allow_pickle:
                return codec.packb({"ok": True,
                                    "msgpack_payload": _coerce(result)})
            return codec.packb({"ok": True, "payload": pickle.dumps(result)})
        except Exception as e:  # noqa: BLE001
            status = "error"
            logger.debug("grpc ingress call failed", exc_info=True)
            return codec.packb(
                {"ok": False, "error": f"{type(e).__name__}: {e}"})
        finally:
            if metrics is not None:
                try:
                    # route_tag is "unmatched" until the deployment name
                    # validated against the controller table: arbitrary
                    # client strings must not become metric series.
                    metrics["requests"].inc(1, tags={
                        "ingress": "grpc", "route": route_tag,
                        "status": status})
                    metrics["latency"].observe(
                        time.perf_counter() - t0,
                        tags={"ingress": "grpc", "route": route_tag})
                except Exception:
                    pass


def _msgpack_default(obj):
    """The reference's msgpack `default` hook: numpy scalars to Python
    scalars, numpy arrays to lists; here torch tensors too (a 0-d one
    to its scalar)."""
    import numpy as np

    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    torch = sys.modules.get("torch")     # no tensor exists without it
    if torch is not None and isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    raise TypeError(
        f"result of type {type(obj).__name__} is not msgpack-"
        "serializable; use the pickle payload mode for arbitrary "
        "Python results")


_NATIVE = (type(None), bool, int, float, str, bytes, bytearray, memoryview)


def _coerce(obj):
    """`obj` with every value msgpack packs only through `default` (numpy
    and torch values, in lists, tuples and dicts, keys too) replaced by
    what `_msgpack_default` gives, so that `codec.packb` writes the bytes
    of `msgpack.packb(obj, default=_msgpack_default)`."""
    if isinstance(obj, _NATIVE):
        return obj
    if isinstance(obj, (list, tuple)):
        return [_coerce(v) for v in obj]
    if isinstance(obj, dict):
        return {_coerce(k): _coerce(v) for k, v in obj.items()}
    return _coerce(_msgpack_default(obj))


class GrpcServeClient:
    """Minimal client for the ingress (reference: the generated
    RayServeAPIServiceStub, hand-rolled over a generic channel).

    `payload_format="msgpack"` sends args/kwargs msgpack-native — what a
    non-Python client would produce — and is the only format an
    `allow_pickle=False` ingress accepts."""

    def __init__(self, address: str, payload_format: str = "pickle"):
        grpc = _import_grpc()

        if payload_format not in ("pickle", "msgpack"):
            raise ValueError(
                f"payload_format must be 'pickle' or 'msgpack', got "
                f"{payload_format!r}")
        self._payload_format = payload_format
        self._channel = grpc.insecure_channel(address)
        self._call = self._channel.unary_unary(
            f"/{SERVICE}/Call",
            request_serializer=None, response_deserializer=None)

    @staticmethod
    def request_body(app: str, args: tuple, kwargs: dict, *,
                     method: str = "__call__", model_id: str = "",
                     payload_format: str = "pickle") -> bytes:
        """The request's bytes, as `call` sends them."""
        body: Dict[str, Any] = {
            "app": app, "method": method, "model_id": model_id}
        if payload_format == "msgpack":
            body["msgpack_payload"] = [list(args), kwargs]
        else:
            body["payload"] = pickle.dumps((args, kwargs))
        return codec.packb(body)

    def call(self, app: str, *args, method: str = "__call__",
             model_id: str = "", timeout: float = 60.0, **kwargs) -> Any:
        req = self.request_body(app, args, kwargs, method=method,
                                model_id=model_id,
                                payload_format=self._payload_format)
        raw = self._call(req, timeout=timeout)
        resp = codec.unpackb(raw)
        if not resp.get("ok"):
            from ray_tpu_torch.serve.exceptions import RayServeException

            raise RayServeException(resp.get("error", "ingress error"))
        if "msgpack_payload" in resp:
            return resp["msgpack_payload"]
        return pickle.loads(resp["payload"])

    def close(self) -> None:
        self._channel.close()
