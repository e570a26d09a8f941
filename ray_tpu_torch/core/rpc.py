"""Async RPC layer: length-prefixed msgpack frames over TCP, the port of
`ray_tpu/core/rpc.py`. The frames are msgpack's bytes, written and read
by `core/codec.py` (the port carries no msgpack package).

Reference equivalent: `src/ray/rpc/` (gRPC server/client wrappers,
`grpc_server.h`, `client_call.h`). The design keeps the same shape — named
services with handler methods, retryable clients, server push for pubsub —
on an asyncio transport chosen for zero codegen and low per-call overhead.

Frame: [u32 little-endian length][msgpack body]
Body (request):  {"i": req_id, "m": method, "a": args_dict}
Body (response): {"i": req_id, "ok": bool, "r": result | "e": error_str}
Body (push):     {"push": channel, "d": data}   (server -> client only)

Blob frames (bulk data plane, e.g. array-channel pushes): embedding a
multi-megabyte payload in the msgpack body costs one full copy at pack
time and another at unpack. A call made with `_blob=` instead ships the
payload OUT OF BAND, after the body, in the same frame:

    [u32 (BLOB_BIT | total)][u32 body_len][body][raw blob bytes]

The body carries `_bk`, the argument name the blob binds to; read_frame
reads the blob into one dedicated buffer and attaches it to the decoded
args untouched, so the receiver can build zero-copy views (np.frombuffer,
dlpack) directly over the wire buffer. BLOB_BIT is bit 31 of the length
word (MAX_FRAME < 2^29 keeps it unambiguous).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import struct
import sys
import threading
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core import attribution
from ray_tpu_torch.core.codec import packb, unpackb

logger = logging.getLogger(__name__)


def _faults_enabled() -> bool:
    """True only when core/faults.py is loaded AND armed — the hot path
    pays a dict lookup, never an import, when fault injection is off."""
    faults = sys.modules.get("ray_tpu_torch.core.faults")
    return faults is not None and faults.enabled

_LEN = struct.Struct("<I")
MAX_FRAME = 512 * 1024 * 1024
BLOB_BIT = 0x8000_0000


def pack(obj: Any) -> bytes:
    body = packb(obj)
    return _LEN.pack(len(body)) + body


def pack_blob_frames(obj: Any, blob_key: str, chunks) -> list:
    """A request frame whose bulk payload rides out of band: returns a
    chunk list for the transport (never joined — a join IS the copy this
    path exists to skip). `obj["a"][blob_key]` must be absent; the reader
    re-attaches the blob under that name."""
    body = packb(dict(obj, _bk=blob_key))
    blob_len = sum(len(c) for c in chunks)
    total = _LEN.size + len(body) + blob_len
    if total > MAX_FRAME:
        raise ConnectionError(f"frame too large: {total}")
    return [_LEN.pack(BLOB_BIT | total) + _LEN.pack(len(body)) + body,
            *chunks]


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length & BLOB_BIT:
        length &= ~BLOB_BIT
        if length > MAX_FRAME:
            raise ConnectionError(f"frame too large: {length}")
        (body_len,) = _LEN.unpack(await reader.readexactly(_LEN.size))
        if body_len > length - _LEN.size:
            # body_len is wire-supplied: bound it by the (already capped)
            # total, or a corrupt peer could demand a multi-GiB read.
            raise ConnectionError(
                f"blob frame body_len {body_len} exceeds frame {length}")
        body = await reader.readexactly(body_len)
        # The blob lands in ONE dedicated buffer and is handed to the
        # handler as-is: np.frombuffer/memoryview over it is zero-copy.
        blob = await reader.readexactly(length - _LEN.size - body_len)
        msg = unpackb(body)
        bk = msg.pop("_bk", None)
        if bk is not None:
            msg.setdefault("a", {})[bk] = blob
        return msg
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return unpackb(body)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class _BatchedWriter:
    """Coalesces frames queued within one event-loop tick into a single
    transport write — without taxing lone frames.

    On virtualized hosts a socket send costs 0.1-1 ms of syscall time, so
    per-frame writes dominate the task hot loop (measured: ~0.8 ms/write
    on the dev box, 1 write per push_task). The first frame of a loop tick
    is written immediately (a sequential request/reply exchange never waits
    for the next tick — deferring every frame cost ~0.2 ms of round-trip
    p50); frames that follow within the same tick buffer and go out in one
    coalesced send at tick end. Ordering holds because every sender runs on
    the loop thread and the buffer drains before newer immediate writes."""

    __slots__ = ("_writer", "_loop", "_buf", "_scheduled", "_hot",
                 "on_write_error")

    # Above this much unflushed transport buffer, senders pause on drain
    # (backpressure for bulk transfers sharing the connection).
    DRAIN_THRESHOLD = 4 * 1024 * 1024

    def __init__(self, writer: asyncio.StreamWriter,
                 loop: asyncio.AbstractEventLoop):
        self._writer = writer
        self._loop = loop
        self._buf: list = []
        self._scheduled = False
        self._hot = False          # a write already happened this tick
        self.on_write_error = None

    def send(self, frame: bytes) -> None:
        if not self._hot and not self._buf:
            # First frame this tick: write now, mark the tick hot so a
            # burst that follows coalesces instead of paying one syscall
            # per frame.
            self._hot = True
            self._loop.call_soon(self._cool)
            self._write(frame)
            return
        self._buf.append(frame)
        if not self._scheduled:
            self._scheduled = True
            self._loop.call_soon(self.flush)

    def send_frames(self, chunks: list) -> None:
        """Write one logical frame given as a chunk list (blob frames).

        Bypasses coalescing — the payload is bulk by construction — but
        drains any buffered frames first so ordering holds. Each chunk is
        written separately: the transport keeps a reference, so a
        multi-megabyte array buffer is never joined into a fresh bytes
        object on the way out."""
        self.flush()
        for c in chunks:
            self._write(c)
        self._hot = True
        self._loop.call_soon(self._cool)

    def _cool(self) -> None:
        self._hot = False

    def flush(self) -> None:
        self._scheduled = False
        if not self._buf:
            return
        data = self._buf[0] if len(self._buf) == 1 else b"".join(self._buf)
        self._buf.clear()
        self._write(data)

    def _write(self, data: bytes) -> None:
        if attribution.enabled:
            import time as _time

            t0 = _time.perf_counter()
            try:
                self._write_inner(data)
            finally:
                attribution.record("rpc.frame_write",
                                   _time.perf_counter() - t0)
            return
        self._write_inner(data)

    def _write_inner(self, data: bytes) -> None:
        try:
            if (self._writer.transport is not None
                    and self._writer.transport.is_closing()):
                raise ConnectionResetError("transport closing")
            self._writer.write(data)
        except Exception:
            cb = self.on_write_error
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass

    async def drain_if_needed(self) -> None:
        transport = self._writer.transport
        if (transport is not None and not transport.is_closing()
                and transport.get_write_buffer_size() > self.DRAIN_THRESHOLD):
            try:
                await self._writer.drain()
            except Exception:
                pass


class RpcServer:
    """Serves handler methods named `handle_<method>`; handlers are
    `async def handle_x(self_conn, **args) -> result`."""

    def __init__(self, handlers: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self._handlers = handlers
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Dict[int, "ServerConnection"] = {}
        self._next_conn_id = 0

    @property
    def port(self) -> int:
        return self._port

    @property
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connect, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._next_conn_id += 1
        conn = ServerConnection(self._next_conn_id, reader, writer,
                                self._handlers)
        self._conns[conn.conn_id] = conn
        try:
            await conn.serve()
        finally:
            self._conns.pop(conn.conn_id, None)
            on_disc = getattr(self._handlers, "on_client_disconnect", None)
            if on_disc is not None:
                try:
                    await on_disc(conn)
                except Exception:
                    logger.exception("disconnect handler failed")

    async def stop(self) -> None:
        # Close live connections BEFORE waiting on the listener: since
        # 3.12 `Server.wait_closed()` also waits for connection handlers,
        # so a handler blocked in read_frame would hang the stop forever.
        # The wait stays bounded as a backstop (gh-120866 class hangs).
        for conn in list(self._conns.values()):
            conn.close()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except (asyncio.TimeoutError, TimeoutError):
                pass


class ServerConnection:
    """One client connection on the server side; supports push()."""

    def __init__(self, conn_id: int, reader, writer, handlers):
        self.conn_id = conn_id
        self._reader = reader
        self._writer = writer
        self._handlers = handlers
        self._batch = _BatchedWriter(writer, asyncio.get_running_loop())
        self.metadata: Dict[str, Any] = {}  # handler-attached state
        self.closed = False

        def _mark_closed():
            self.closed = True

        self._batch.on_write_error = _mark_closed

    async def serve(self) -> None:
        try:
            while True:
                msg = await read_frame(self._reader)
                asyncio.ensure_future(self._dispatch(msg))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.closed = True

    async def _dispatch(self, msg: Dict[str, Any]) -> None:
        req_id, method = msg.get("i"), msg.get("m")
        if method == "__schema__":
            # Built-in schema handshake (core/wire.py): reply with our
            # digest; the CLIENT decides compatibility so old servers
            # never have to know new messages. A client that also SENDS
            # its digest lets this side verify symmetry and unlock the
            # fast-path decode (wire.from_wire_fast) for the connection:
            # both encoders proven identical means per-field validation
            # on every message buys nothing.
            from ray_tpu_torch.core.wire import (SchemaMismatchError,
                                           check_digest, schema_digest)

            peer = (msg.get("a") or {}).get("digest")
            if peer:
                try:
                    check_digest(peer)
                    self.metadata["wire_fast"] = True
                except SchemaMismatchError:
                    # The client will see the same mismatch from our
                    # digest and fail its connect; until then every
                    # decode on this conn stays validated.
                    self.metadata["wire_fast"] = False
            await self._reply(req_id, ok=True, result=schema_digest())
            return
        handler = getattr(self._handlers, f"handle_{method}", None)
        if handler is None:
            await self._reply(req_id, ok=False,
                              error=f"no such method: {method}")
            return
        gate = getattr(self._handlers, "check_dispatch", None)
        if gate is not None:
            # Handler-level admission gate (e.g. a GCS follower replica
            # redirecting mutations to the leader). Raising here surfaces
            # as the same typed error string a handler exception would,
            # so clients need no new wire machinery to see it.
            try:
                gate(method)
            except Exception as e:  # noqa: BLE001
                await self._reply(req_id, ok=False,
                                  error=f"{type(e).__name__}: {e}")
                return
        if _faults_enabled():
            # Deterministic fault injection (core/faults.py): a drop rule
            # swallows the request here — the client sees a timeout /
            # ConnectionLost exactly as if the frame died on the wire; a
            # duplicate rule dispatches the handler a second time with
            # its reply discarded (at-least-once delivery). The
            # duplicate runs CONCURRENTLY, as real redelivery would — an
            # inline await of a handler that parks (e.g. a queued lease)
            # would stall the genuine dispatch behind it.
            from ray_tpu_torch.core import faults

            try:
                duplicate = await faults.on_server_dispatch(method)
            except faults.FaultInjected:
                return

            if duplicate:
                async def _dup():
                    try:
                        await handler(self, **(msg.get("a") or {}))
                    except Exception:
                        logger.debug("duplicated handler %s failed",
                                     method, exc_info=True)

                asyncio.ensure_future(_dup())
        try:
            result = await handler(self, **(msg.get("a") or {}))
            await self._reply(req_id, ok=True, result=result)
        except Exception as e:  # noqa: BLE001
            logger.debug("handler %s failed", method, exc_info=True)
            await self._reply(req_id, ok=False,
                              error=f"{type(e).__name__}: {e}")

    async def _reply(self, req_id, ok: bool, result=None, error=None):
        if req_id is None or self.closed:
            return
        body = {"i": req_id, "ok": ok}
        if ok:
            body["r"] = result
        else:
            body["e"] = error
        await self._send(body)

    async def push(self, channel: str, data: Any) -> None:
        await self._send({"push": channel, "d": data})

    async def _send(self, body) -> None:
        if self.closed:
            return
        try:
            self._batch.send(pack(body))
            await self._batch.drain_if_needed()
        except (ConnectionError, OSError):
            self.closed = True

    def close(self) -> None:
        self.closed = True
        try:
            self._batch.flush()
        except Exception:
            pass
        try:
            self._writer.close()
        except Exception:
            pass


class RpcClient:
    """Async client with request-response and push-subscription support."""

    def __init__(self, address: str, handshake: bool = True):
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._batch: Optional[_BatchedWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._push_handlers: Dict[str, Callable[[Any], Any]] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._handshake = handshake
        self.connected = False

    @property
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    async def connect(self, timeout: float = 10.0,
                      retry_interval: float = 0.1) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        last_err: Optional[Exception] = None
        while loop.time() < deadline:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self._host, self._port)
                self._batch = _BatchedWriter(self._writer, loop)
                self._reader_task = asyncio.ensure_future(self._read_loop())
                self.connected = True
                if self._handshake:
                    # Version handshake: reject an incompatible peer NOW
                    # with a typed error instead of corrupting a protocol
                    # exchange later (core/wire.py evolution rules).
                    from ray_tpu_torch.core.wire import (SchemaMismatchError,
                                                   check_digest,
                                                   schema_digest)

                    try:
                        # Send our digest too: a server that verifies it
                        # unlocks the post-handshake fast-path decode
                        # for this connection (see ServerConnection).
                        digest = await self.call(
                            "__schema__", digest=schema_digest(),
                            timeout=max(5.0, timeout))
                    except ConnectionLost:
                        raise          # peer died mid-handshake
                    except (asyncio.TimeoutError, TimeoutError):
                        await self.close()
                        raise ConnectionLost(
                            f"{self.address}: schema handshake timed out")
                    except RpcError:
                        # Pre-handshake server ("no such method"): treat
                        # as schema-less rather than unreachable.
                        digest = None
                    try:
                        check_digest(digest or {})
                    except SchemaMismatchError:
                        await self.close()  # don't leak a half-open client
                        raise
                return
            except OSError as e:
                last_err = e
                await asyncio.sleep(retry_interval)
        raise ConnectionLost(
            f"could not connect to {self.address}: {last_err}")

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await read_frame(self._reader)
                if "push" in msg:
                    handler = self._push_handlers.get(msg["push"])
                    if handler is not None:
                        try:
                            res = handler(msg.get("d"))
                            if asyncio.iscoroutine(res):
                                asyncio.ensure_future(res)
                        except Exception:
                            logger.exception("push handler failed")
                    continue
                fut = self._pending.pop(msg.get("i"), None)
                if fut is not None and not fut.done():
                    if msg.get("ok"):
                        fut.set_result(msg.get("r"))
                    else:
                        fut.set_exception(RpcError(msg.get("e")))
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.connected = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(str(e)))
            self._pending.clear()

    def on_push(self, channel: str, handler: Callable[[Any], Any]) -> None:
        self._push_handlers[channel] = handler

    async def call(self, method: str, timeout: Optional[float] = 60.0,
                   _blob: Optional[list] = None, _blob_key: str = "data",
                   **args: Any) -> Any:
        """One request/response round trip. `_blob` (a list of buffer
        chunks) ships out of band after the msgpack body and re-attaches
        at the receiver as args[_blob_key] — the bulk data plane path
        (see module docstring)."""
        if not self.connected:
            raise ConnectionLost(f"not connected to {self.address}")
        if _faults_enabled():
            # Client-side injection point (core/faults.py): drops raise
            # ConnectionLost, delays sleep before the frame is written.
            from ray_tpu_torch.core import faults

            await faults.on_client_call(self.address, method)
        self._next_id += 1
        req_id = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        body = {"i": req_id, "m": method, "a": args}
        if _blob is None:
            self._batch.send(pack(body))
        else:
            self._batch.send_frames(
                pack_blob_frames(body, _blob_key, _blob))
        await self._batch.drain_if_needed()
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def notify(self, method: str, **args: Any) -> None:
        """Fire-and-forget (no response expected)."""
        if not self.connected:
            raise ConnectionLost(f"not connected to {self.address}")
        self._batch.send(pack({"i": None, "m": method, "a": args}))
        await self._batch.drain_if_needed()

    async def close(self) -> None:
        self.connected = False
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._batch is not None:
            self._batch.flush()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread — the process's RPC
    engine (analogue of the reference's io_service threads)."""

    def __init__(self, name: str = "rpc-loop"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro: Awaitable, timeout: Optional[float] = None) -> Any:
        """Run a coroutine on the loop from a sync thread, blocking.

        On timeout the in-flight coroutine is cancelled so it does not keep
        running orphaned on the loop."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise

    def spawn(self, coro: Awaitable) -> None:
        asyncio.run_coroutine_threadsafe(coro, self.loop)

    def call_soon(self, fn: Callable[[], Any]) -> None:
        """Schedule a plain callable on the loop from any thread."""
        self.loop.call_soon_threadsafe(fn)

    def stop(self, drain_timeout: float = 2.0) -> None:
        """Cancel every task still pending on the loop and let it unwind
        before stopping — otherwise asyncio logs "Task was destroyed but it
        is pending" for each orphaned background coroutine (lease fetches,
        idle-linger timers) on interpreter exit."""

        async def _drain():
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            fut = asyncio.run_coroutine_threadsafe(_drain(), self.loop)
            fut.result(drain_timeout)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        # Closed once stopped: a stream writer or a finalizer that runs
        # later must not queue callbacks (and the context of whatever
        # code ran the collector) on a loop nothing will run again.
        if threading.current_thread() is not self._thread:
            self._thread.join(drain_timeout)
            if not self.loop.is_running():
                self.loop.close()
