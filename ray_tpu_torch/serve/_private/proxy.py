"""HTTP proxy actor: the ingress edge, ported from
`ray_tpu/serve/_private/proxy.py`.

Reference equivalent: `python/ray/serve/_private/proxy.py:1082` (there:
uvicorn/ASGI). Here: an asyncio HTTP/1.1 server living on the proxy
actor's event loop. Requests route by longest matching route prefix to a
DeploymentHandle; responses are JSON (dict/list returns), raw bytes, or
text. The proxy refreshes its route table from the controller
periodically, so `serve.run` of a new app is picked up without restarts.

Two additions for LLM-style serving:

- **admission control / load shedding** (`_AdmissionGate`): a token
  bucket (429) plus an in-flight cap (503) evaluated BEFORE any work is
  dispatched, so under 2x overload excess requests bounce in
  microseconds instead of stacking an unbounded queue behind the
  replicas — served-request p99 stays bounded. Sheds are counted in
  `serve_engine_shed_requests` by status.
- **streaming responses**: a request carrying `Accept:
  text/event-stream` (or `?stream=1`) routes through the streaming
  handle path and writes chunked transfer encoding, one chunk per
  yielded item — time-to-first-byte decouples from generation length.

`stop()` closes the listener, the route long-poll and the pump pool;
`serve.shutdown()` calls it before it kills the proxy, so no thread of
the proxy outlives Serve.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse


_STREAM_END = object()


def _overload_retry_after(e: BaseException) -> Optional[float]:
    """Seconds a shed client should back off, when `e` is (or wraps) an
    engine overload. Matched by type name, not import: the error may
    have crossed a worker boundary and been reconstructed. Walks the
    cause/context chain plus `RayTaskError.cause` (the remote original
    rides that attribute, and `as_instanceof_cause()` mangles the
    wrapper's own class name — hence the MRO scan)."""
    seen = set()
    stack: list = [e]
    matched = False
    while stack:
        err = stack.pop()
        if err is None or id(err) in seen:
            continue
        seen.add(id(err))
        if any(c.__name__ == "EngineOverloadedError"
               for c in type(err).__mro__):
            matched = True
            # The dual-inheritance wrapper is-a overload but carries the
            # class-default None; the concrete value rides the chained
            # original — keep walking before settling for the fallback.
            ra = getattr(err, "retry_after_s", None)
            try:
                if ra:
                    return float(ra)
            except (TypeError, ValueError):
                pass
        stack.extend([err.__cause__, err.__context__,
                      getattr(err, "cause", None)])
    return 1.0 if matched else None


class _AdmissionGate:
    """Pre-queue overload gate: in-flight cap first (503 — the system
    is saturated; retry against another ingress), then a token bucket
    (429 — the client is over its rate)."""

    def __init__(self, max_inflight: Optional[int] = None,
                 rate: Optional[float] = None, burst: int = 16):
        self.configure(max_inflight, rate, burst)
        self.shed_503 = 0
        self.shed_429 = 0

    def configure(self, max_inflight: Optional[int],
                  rate: Optional[float], burst: int = 16) -> None:
        self.max_inflight = max_inflight
        self.rate = rate
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._last = time.monotonic()

    def check(self, inflight: int) -> Optional[str]:
        """None = admit; otherwise the shed status ("503" | "429")."""
        if self.max_inflight is not None \
                and inflight >= self.max_inflight:
            self.shed_503 += 1
            return "503"
        if self.rate is not None:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last)
                               * self.rate)
            self._last = now
            if self._tokens < 1.0:
                self.shed_429 += 1
                return "429"
            self._tokens -= 1.0
        return None


class HTTPProxy:
    def __init__(self, controller_handle, host: str = "127.0.0.1",
                 port: int = 8000, http_options=None):
        self._controller = controller_handle
        self.host = host
        self.port = port
        self._server = None
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}
        self._route_task = None
        self._inflight = 0
        opts = http_options
        self._gate = _AdmissionGate(
            getattr(opts, "max_inflight_requests", None),
            getattr(opts, "admission_rate_limit", None),
            getattr(opts, "admission_burst", 16) or 16)
        # Dedicated pump pool for streaming responses: each active SSE
        # stream parks a thread in next() between tokens, and the
        # loop's DEFAULT executor is tiny (cpus+4) and shared with the
        # non-streaming dispatch path — a handful of slow streams must
        # not stall the whole ingress.
        import concurrent.futures

        self._stream_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="sse-pump")

    # -- admission control --------------------------------------------
    def configure_admission(self, max_inflight: Optional[int] = None,
                            rate: Optional[float] = None,
                            burst: int = 16) -> bool:
        """Reconfigure the shedding gate at runtime (tests, operators)."""
        self._gate.configure(max_inflight, rate, burst)
        return True

    def admission_stats(self) -> Dict[str, Any]:
        return {"inflight": self._inflight,
                "shed_503": self._gate.shed_503,
                "shed_429": self._gate.shed_429,
                "max_inflight": self._gate.max_inflight,
                "rate": self._gate.rate}

    def _count_shed(self, status: str, metrics) -> None:
        try:
            from ray_tpu_torch.serve._private.metrics import engine_metrics

            engine_metrics()["shed"].inc(1, tags={"status": status})
        except Exception:
            pass
        if metrics is not None:
            try:
                metrics["requests"].inc(1, tags={
                    "ingress": "http", "route": "shed",
                    "status": f"shed_{status}"})
            except Exception:
                pass

    async def start(self) -> int:
        """Bind and serve; returns the bound port (0 → ephemeral)."""
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._route_task = asyncio.get_running_loop().create_task(
            self._refresh_routes_loop())
        return self.port

    _routes_version = -1

    async def _refresh_routes_loop(self) -> None:
        """Long-poll the controller for route-table pushes (reference:
        long_poll.py LongPollClient); on controller outage keep serving
        the cached table and retry. Ends when the controller dies (the
        in-process runtime never restarts it)."""
        from ray_tpu_torch.exceptions import RayActorError

        while True:
            try:
                out = await asyncio.to_thread(self._listen_blocking)
                snap = (out or {}).get("__routes__")
                if snap:
                    self._routes = snap["routes"]
                    self._routes_version = snap["version"]
            except RayActorError:
                return
            except Exception:
                await asyncio.sleep(1.0)  # controller unreachable

    def _listen_blocking(self) -> Dict[str, Any]:
        return self._controller._actor_runtime().get(
            self._controller.listen_for_change.remote(
                {"__routes__": self._routes_version}, timeout_s=10.0),
            timeout=20)

    def _get_routes_blocking(self) -> Dict[str, str]:
        return self._controller._actor_runtime().get(
            self._controller.get_routes.remote(), timeout=10)

    def _match_route(self, path: str) -> Optional[str]:
        best = None
        for prefix, deployment in self._routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm + "/") or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, deployment)
        return best[1] if best else None

    def _handle_for(self, deployment: str):
        handle = self._handles.get(deployment)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(deployment, self._controller)
            self._handles[deployment] = handle
        return handle

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                out = await self._dispatch(request, writer)
                if out is None:
                    continue  # streaming path wrote its own response
                # (status, body, ctype) or, with extra response headers
                # (e.g. Retry-After on an overload 503), a 4th dict of
                # header-name -> value bytes.
                status, body, ctype = out[0], out[1], out[2]
                extra = b""
                if len(out) > 3 and out[3]:
                    for k, v in out[3].items():
                        extra += k + b": " + v + b"\r\n"
                writer.write(
                    b"HTTP/1.1 " + status + b"\r\n"
                    b"Content-Type: " + ctype + b"\r\n"
                    b"Content-Length: " + str(len(body)).encode()
                    + b"\r\n" + extra
                    + b"Connection: keep-alive\r\n\r\n" + body)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader) -> Optional[dict]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _ = line.decode().split(" ", 2)
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        length = int(headers.get("content-length", 0) or 0)
        if length:
            body = await reader.readexactly(length)
        parsed = urlparse(target)
        return {"method": method.upper(), "path": parsed.path,
                "query": {k: v[0] for k, v in
                          parse_qs(parsed.query).items()},
                "headers": headers, "body": body}

    @staticmethod
    def _wants_stream(request: dict) -> bool:
        accept = request["headers"].get("accept", "")
        return ("text/event-stream" in accept
                or request["query"].get("stream") in ("1", "true"))

    async def _dispatch(self, request: dict, writer=None):
        from ray_tpu_torch.serve._private.metrics import proxy_metrics
        from ray_tpu_torch.util.tracing import span

        deployment = self._match_route(request["path"])
        if deployment is None:
            # Route miss: the periodic refresh may simply not have seen a
            # just-deployed app yet — force one refresh before 404ing.
            try:
                self._routes = await asyncio.to_thread(
                    self._get_routes_blocking)
            except Exception:
                pass
            deployment = self._match_route(request["path"])
        try:
            metrics = proxy_metrics()
        except Exception:
            metrics = None

        # Tag with the BOUNDED matched deployment, never the raw path:
        # unique URLs (bot scans, per-user suffixes) must not mint a new
        # metric series each (the tag-cardinality rule every Prometheus
        # deployment learns the hard way).
        route_tag = f"/{deployment}" if deployment else "unmatched"

        def _count(status: str) -> None:
            if metrics is not None:
                try:
                    metrics["requests"].inc(1, tags={
                        "ingress": "http", "route": route_tag,
                        "status": status})
                except Exception:
                    pass

        if deployment is None:
            _count("not_found")
            return b"404 Not Found", b"no route", b"text/plain"

        # Overload gate BEFORE any work is dispatched or queued: the
        # whole point of shedding at the edge is that an over-capacity
        # request costs microseconds, not a queue slot.
        shed = self._gate.check(self._inflight)
        if shed is not None:
            self._count_shed(shed, metrics)
            if shed == "429":
                return (b"429 Too Many Requests",
                        b"rate limited; retry later", b"text/plain")
            return (b"503 Service Unavailable",
                    b"overloaded; retry later", b"text/plain")

        handle = self._handle_for(deployment)
        if writer is not None and self._wants_stream(request):
            return await self._dispatch_streaming(
                request, writer, deployment, handle, metrics,
                route_tag)
        t0 = time.perf_counter()
        self._inflight += 1
        try:
            # The ingress span honors an inbound W3C `traceparent` header
            # (external tracer continuity); the router/replica spans nest
            # under it via the ambient context — asyncio.to_thread copies
            # contextvars into the worker thread.
            with span("serve.proxy",
                      parent=request["headers"].get("traceparent"),
                      attributes={"ingress": "http",
                                  "route": request["path"],
                                  "deployment": deployment,
                                  "method": request["method"],
                                  "component": "proxy"}):
                # Routing + result are blocking; keep the proxy loop free.
                value = await asyncio.to_thread(
                    self._call_blocking, handle, request)
        except Exception as e:  # noqa: BLE001
            retry = _overload_retry_after(e)
            if retry is not None:
                # The replica's engine shed the request (waiting queue
                # full). Unlike a 500, this is backpressure: surface the
                # engine's drain-rate-derived hint as Retry-After so
                # well-behaved clients pace themselves instead of
                # hammering a saturated fleet.
                _count("overloaded")
                secs = max(1, int(retry + 0.999))
                return (b"503 Service Unavailable",
                        f"engine overloaded; retry after "
                        f"{retry:.2f}s".encode(),
                        b"text/plain",
                        {b"Retry-After": str(secs).encode()})
            _count("error")
            return (b"500 Internal Server Error",
                    f"{type(e).__name__}: {e}".encode(), b"text/plain")
        finally:
            self._inflight -= 1
            if metrics is not None:
                try:
                    metrics["latency"].observe(
                        time.perf_counter() - t0,
                        tags={"ingress": "http", "route": route_tag})
                except Exception:
                    pass
        _count("ok")
        if isinstance(value, (dict, list)):
            return (b"200 OK", json.dumps(value).encode(),
                    b"application/json")
        if isinstance(value, bytes):
            return b"200 OK", value, b"application/octet-stream"
        return b"200 OK", str(value).encode(), b"text/plain"

    async def _dispatch_streaming(self, request: dict, writer,
                                  deployment: str, handle, metrics,
                                  route_tag: str) -> None:
        """Chunked-transfer streaming: one HTTP chunk per item the
        replica's generator yields, flushed immediately — the client
        sees the first token while generation continues. SSE-framed
        (`data: <json>\\n\\n`) under text/event-stream. Returns None:
        the response is fully written here."""
        from ray_tpu_torch.util.tracing import span

        t0 = time.perf_counter()
        self._inflight += 1
        status = "ok"
        headers_sent = False
        try:
            with span("serve.proxy",
                      parent=request["headers"].get("traceparent"),
                      attributes={"ingress": "http",
                                  "route": request["path"],
                                  "deployment": deployment,
                                  "method": request["method"],
                                  "component": "proxy",
                                  "streaming": "1"}):
                loop = asyncio.get_running_loop()
                payload, method_name = self._request_payload(request)
                # Routing blocks (table refresh RPCs): keep the proxy
                # loop free, same as the non-streaming path.
                gen = await loop.run_in_executor(
                    self._stream_pool,
                    lambda: handle.options(
                        stream=True,
                        method_name=method_name or "__call__",
                    ).remote(payload))
                writer.write(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/event-stream\r\n"
                    b"Cache-Control: no-cache\r\n"
                    b"Transfer-Encoding: chunked\r\n"
                    b"Connection: keep-alive\r\n\r\n")
                headers_sent = True
                await writer.drain()
                it = iter(gen)
                while True:
                    # StopIteration cannot cross a Future boundary
                    # (asyncio converts it to a RuntimeError mid-loop);
                    # a sentinel can.
                    item = await loop.run_in_executor(
                        self._stream_pool, next, it, _STREAM_END)
                    if item is _STREAM_END:
                        break
                    chunk = (b"data: " + json.dumps(
                        item, default=str).encode() + b"\n\n")
                    writer.write(hex(len(chunk))[2:].encode()
                                 + b"\r\n" + chunk + b"\r\n")
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        except Exception as e:  # noqa: BLE001
            status = "error"
            try:
                if not headers_sent:
                    # Nothing on the wire yet: a plain error response.
                    body = f"{type(e).__name__}: {e}".encode()
                    writer.write(
                        b"HTTP/1.1 500 Internal Server Error\r\n"
                        b"Content-Type: text/plain\r\n"
                        b"Content-Length: "
                        + str(len(body)).encode() + b"\r\n"
                        b"Connection: keep-alive\r\n\r\n" + body)
                else:
                    # Mid-stream failures can't change the status line;
                    # surface as a terminal SSE event + end-of-chunks so
                    # clients see a clean close, not a hung connection.
                    chunk = (b"event: error\ndata: "
                             + f"{type(e).__name__}: {e}".encode()
                             + b"\n\n")
                    writer.write(hex(len(chunk))[2:].encode() + b"\r\n"
                                 + chunk + b"\r\n0\r\n\r\n")
                await writer.drain()
            except Exception:
                pass
        finally:
            self._inflight -= 1
            if metrics is not None:
                try:
                    metrics["requests"].inc(1, tags={
                        "ingress": "http", "route": route_tag,
                        "status": status})
                    metrics["latency"].observe(
                        time.perf_counter() - t0,
                        tags={"ingress": "http", "route": route_tag})
                except Exception:
                    pass
        return None

    @staticmethod
    def _request_payload(request: dict):
        """Extract (payload, method_name) — shared by the blocking and
        streaming paths. JSON bodies become the payload; a `method`
        query arg targets a named deployment method."""
        body = request["body"]
        payload: Any = request
        ctype = request["headers"].get("content-type", "")
        query = {k: v for k, v in request["query"].items()
                 if k not in ("stream", "method")}  # proxy-level params
        if body and "application/json" in ctype:
            payload = json.loads(body)
        elif not body and query:
            payload = query
        return payload, request["query"].get("method")

    def _call_blocking(self, handle, request: dict):
        payload, method_name = self._request_payload(request)
        if method_name:
            handle = handle.options(method_name=method_name)
        return handle.remote(payload).result(timeout_s=60)

    async def ready(self) -> int:
        return self.port

    async def stop(self) -> bool:
        """Close the listener and the route long-poll, and end the pump
        pool's threads."""
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._route_task is not None:
            self._route_task.cancel()
            self._route_task = None
        # Joined off the loop, within a bound: a pump still parked in a
        # stream's next() ends when that stream does.
        try:
            await asyncio.wait_for(asyncio.to_thread(
                self._stream_pool.shutdown, True, cancel_futures=True), 5.0)
        except asyncio.TimeoutError:
            pass
        return True

    def check_health(self) -> bool:
        return True
