"""Typed, bounded, reusable channels for compiled graphs, the port of
`ray_tpu/cgraph/channel.py`.

Reference equivalent: `python/ray/experimental/channel/` — the
pre-allocated slots Ray's accelerated DAG ("Compiled Graphs") threads
between persistent actor loops so a compiled execution never touches the
task plane. Three flavors here, mirroring the reference's
IntraProcessChannel / shared-memory Channel / accelerator channel split:

- co-located reader+writer (local mode, or a process reading its own
  channel): a plain in-process slot buffer — values pass by reference,
  zero serialization;
- cross-process: the READER hosts the slot buffer and the writer pushes
  frames directly over the worker RPC plane (`cgraph_push`), using the
  `core.serialization` fast path and a reused frame buffer — no object
  store entry, no GCS round-trip, no raylet; the push reply doubles as
  the backpressure signal (a full slot delays the ACK, stalling the
  writer);
- `ArrayChannel`: same transport, but values are tensors (torch, or
  numpy arrays) — co-located handoff passes a CUDA tensor by reference,
  untouched on its card; cross-process handoff copies a card tensor to
  the host once the producer's stream is done with it and frames its
  raw bytes with torch's dtype name (`core/serialization.py`'s ``T``
  frame; bfloat16 survives), and the reader re-lands a frame that came
  from a card on its own card (`util.device_arrays.to_torch`: `cuda:0`
  inside its lease, one pinned host->card copy) or raises where it has
  none: nothing lands silently on the host. A frame from a CPU tensor
  or a numpy array lands as it was written. Remote pushes ride the RPC
  layer's blob frames (rpc.py `_blob`): the buffer goes to the
  transport as a view and arrives as one dedicated buffer — no msgpack
  re-embedding copy on either side;
- `DeviceChannel` (`.with_channel("device")`): when writer and reader
  both hold ranks in a shared `util.collective` group, the tensor moves
  writer->reader via collective p2p send/recv (gloo on the host, NCCL
  card to card) — only a tiny dtype/shape header rides the RPC push
  path (preserving FIFO seq semantics); the payload never transits the
  RPC data plane at all. Endpoints without group ranks (two leased
  workers on one card: NCCL takes one member a card) fall back to the
  ArrayChannel push transport transparently.

A channel is a fixed slot queue reused for every execution (capacity
bounds in-flight executions per edge), unlike task returns which
allocate a fresh object per call.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization


class ChannelClosed(Exception):
    """Raised by read/write on a torn-down channel."""


class ChannelTimeout(Exception):
    """Raised when a bounded read/write does not complete in time."""


class _WireBlob:
    """A deposited-but-not-yet-decoded frame (decode happens on the
    reader's thread, never on the RPC event loop)."""

    __slots__ = ("blob",)

    def __init__(self, blob: bytes):
        self.blob = blob


_registry: Dict[str, "Channel"] = {}
_registry_lock = threading.Lock()


def get_or_create(cls, channel_id: str, capacity: int,
                  reader_addr: Optional[str],
                  ordered: bool = True) -> "Channel":
    """Process-local channel registry: the same id always resolves to the
    same buffer, so pickling a channel into an actor (or a push arriving
    before the loop install) connects to one shared slot queue."""
    with _registry_lock:
        ch = _registry.get(channel_id)
        if ch is None:
            if len(_registry) > 4096:
                # Closed tombstones accumulate one per torn-down edge;
                # sweep them before the table can grow unbounded.
                for cid in [c for c, v in _registry.items() if v._closed]:
                    del _registry[cid]
            ch = cls.__new__(cls)
            ch._init(channel_id, capacity, reader_addr, ordered)
            _registry[channel_id] = ch
        return ch


def unregister(channel_id: str) -> None:
    with _registry_lock:
        _registry.pop(channel_id, None)


_KINDS: Dict[str, type] = {}

# Frames at or below this size are embedded in the msgpack push body
# (coalescable); larger payloads ship out of band as blob frames.
_INLINE_PUSH_MAX = 64 * 1024


def deposit_remote(kind: str, channel_id: str, capacity: int, blob: bytes,
                   seq: int, timeout: float = 600.0,
                   ordered: bool = True) -> bool:
    """Blocking entry point for the worker RPC handler (`cgraph_push`)."""
    cls = _KINDS.get(kind, Channel)
    ch = get_or_create(cls, channel_id, capacity, None, ordered)
    ch._deposit_blob(blob, seq, timeout=timeout)
    return True


def deposit_nowait(kind: str, channel_id: str, capacity: int, blob: bytes,
                   seq: int, ordered: bool = True) -> bool:
    """Non-blocking fast path; False -> caller falls back to
    `deposit_remote` on an executor thread."""
    cls = _KINDS.get(kind, Channel)
    ch = get_or_create(cls, channel_id, capacity, None, ordered)
    return ch.try_deposit_nowait(blob, seq)


class Channel:
    """One bounded FIFO slot queue; single writer process, single reader
    process (the reader hosts the buffer)."""

    kind = "obj"

    def __init__(self, capacity: int = 8,
                 reader_addr: Optional[str] = None,
                 channel_id: Optional[str] = None,
                 ordered: bool = True):
        self._init(channel_id or secrets.token_hex(8), capacity,
                   reader_addr, ordered)
        with _registry_lock:
            _registry.setdefault(self.id, self)

    def _init(self, channel_id: str, capacity: int,
              reader_addr: Optional[str], ordered: bool = True) -> None:
        self.id = channel_id
        self.capacity = max(1, int(capacity))
        self.reader_addr = reader_addr
        # ordered=False: multi-writer channel (e.g. the per-graph error
        # channel, written by EVERY actor loop) — per-writer seqs are
        # meaningless there, frames are admitted on arrival.
        self._ordered = ordered
        self._buf: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        # Writer-side: monotone frame seq (RPC handler concurrency must
        # not reorder a FIFO edge); reader-side: next seq to admit.
        self._wseq = 0
        self._rseq = 0
        # In-flight push ACK futures: pushes are PIPELINED — a write
        # fires the frame and returns; the ACK (which the reader delays
        # while its slot is full) is awaited only when `capacity` pushes
        # are outstanding. Backpressure with no per-write round-trip.
        self._acks: deque = deque()
        # Device-transport route cache (DeviceChannel): resolved lazily
        # on first remote write; transient failures retry up to
        # _ROUTE_RETRY_BUDGET before the edge settles on push.
        self._route = None
        self._route_resolved = False
        self._route_attempts = 0
        # Writers that keep owning the value after write() (the driver's
        # input edges) must not have a live view of it shipped through
        # the pipelined async push — the compiler sets this and the
        # array codec snapshots the buffer instead.
        self._snapshot_writes = False

    def __reduce__(self):
        return (get_or_create,
                (type(self), self.id, self.capacity, self.reader_addr,
                 self._ordered))

    # -- codec ----------------------------------------------------------
    def _encode_chunks(self, value: Any) -> list:
        """The frame as a chunk list for the transport. One serialize
        copy into a fresh buffer; the RPC blob framing ships the chunks
        out of band, so there is no bytes() snapshot and no msgpack
        re-embedding copy (the round-6 path paid both)."""
        buf = bytearray()
        serialization.serialize_fast_into(value, buf)
        return [buf]

    def _decode(self, blob, timeout: Optional[float] = None) -> Any:
        return serialization.deserialize_fast(blob, full=True)

    # -- local side ------------------------------------------------------
    def _is_local_writer(self) -> bool:
        if self.reader_addr is None:
            return True
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime(or_none=True)
        return getattr(rt, "address", None) == self.reader_addr

    def _write_local(self, item: Any, timeout: Optional[float]) -> None:
        with self._cond:
            if not self._wait_for_space(timeout):
                raise ChannelTimeout(f"channel {self.id} full")
            self._buf.append(item)
            self._cond.notify_all()

    def _wait_for_space(self, timeout: Optional[float]) -> bool:
        # Caller holds self._cond.
        def have_space():
            return self._closed or len(self._buf) < self.capacity
        ok = self._cond.wait_for(have_space, timeout=timeout)
        if self._closed:
            raise ChannelClosed(self.id)
        return ok

    def _deposit_blob(self, blob: bytes, seq: int,
                      timeout: Optional[float] = None) -> None:
        """Reader-process deposit of a pushed frame, admitted in writer
        seq order (concurrent RPC dispatch must not reorder the FIFO)."""
        with self._cond:
            def my_turn():
                return self._closed or (
                    (not self._ordered or self._rseq == seq)
                    and len(self._buf) < self.capacity)
            if not self._cond.wait_for(my_turn, timeout=timeout):
                raise ChannelTimeout(
                    f"channel {self.id} deposit seq={seq} timed out")
            if self._closed:
                raise ChannelClosed(self.id)
            self._rseq = seq + 1
            self._buf.append(_WireBlob(blob))
            self._cond.notify_all()

    def try_deposit_nowait(self, blob: bytes, seq: int) -> bool:
        """Lock-try deposit for the RPC handler's fast path: done inline
        on the event loop when the slot is free and the frame is next in
        order — the common case — skipping an executor round-trip. False
        means the caller must take the blocking path off-loop."""
        if not self._cond.acquire(blocking=False):
            return False
        try:
            if self._closed:
                raise ChannelClosed(self.id)
            if ((self._ordered and self._rseq != seq)
                    or len(self._buf) >= self.capacity):
                return False
            self._rseq = seq + 1
            self._buf.append(_WireBlob(blob))
            self._cond.notify_all()
            return True
        finally:
            self._cond.release()

    # -- public API ------------------------------------------------------
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise ChannelClosed(self.id)
        if self._is_local_writer():
            self._write_local(value, timeout)
            return
        self._push_chunks(self._encode_chunks(value), timeout)

    def _push_chunks(self, chunks: list,
                     timeout: Optional[float]) -> None:
        """Fire one seq-stamped frame at the reader (pipelined)."""
        seq = self._wseq
        self._wseq += 1
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime()
        import asyncio
        # Reap ACKs that already landed; block only when `capacity`
        # pushes are un-ACKed (the reader is behind: backpressure).
        while self._acks and self._acks[0].done():
            self._reap(self._acks.popleft())
        while len(self._acks) >= self.capacity:
            fut = self._acks.popleft()
            try:
                fut.result(timeout)
            except ChannelClosed:
                raise
            except Exception as e:  # noqa: BLE001
                self._raise_push_failure(e)
        self._acks.append(asyncio.run_coroutine_threadsafe(
            self._push_remote(rt, chunks, seq, timeout), rt._loop.loop))

    def _reap(self, fut) -> None:
        try:
            fut.result(0)
        except ChannelClosed:
            raise
        except Exception as e:  # noqa: BLE001
            self._raise_push_failure(e)

    def _raise_push_failure(self, e: Exception) -> None:
        if "ChannelClosed" in str(e):
            raise ChannelClosed(self.id) from e
        raise e

    def pending_error(self) -> Optional[Exception]:
        """A failed pipelined push, if one has surfaced (writer side)."""
        while self._acks and self._acks[0].done():
            fut = self._acks.popleft()
            try:
                self._reap(fut)
            except Exception as e:  # noqa: BLE001
                return e
        return None

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait out every pipelined push ACK (writer side)."""
        while self._acks:
            fut = self._acks.popleft()
            try:
                fut.result(timeout)
            except ChannelClosed:
                raise
            except Exception as e:  # noqa: BLE001
                self._raise_push_failure(e)

    async def _push_remote(self, rt, chunks: list, seq: int,
                           timeout: Optional[float]) -> None:
        client = await rt._worker_client(self.reader_addr)
        total = sum(len(c) for c in chunks)
        if total <= _INLINE_PUSH_MAX:
            # Small frames ride the ordinary msgpack body so the batched
            # writer keeps coalescing a burst of pushes into one syscall
            # — blob framing forces a flush per frame, which costs more
            # than the one small copy it avoids (round-7 guard: the
            # 3-actor-chain rate halved when every push took the blob
            # path).
            await client.call(
                "cgraph_push", kind=self.kind, channel=self.id,
                capacity=self.capacity, seq=seq, ordered=self._ordered,
                timeout=timeout,
                data=bytes(chunks[0]) if len(chunks) == 1
                else b"".join(chunks))
            return
        await client.call("cgraph_push", kind=self.kind, channel=self.id,
                          capacity=self.capacity, _blob=chunks, seq=seq,
                          ordered=self._ordered, timeout=timeout)

    def read(self, timeout: Optional[float] = None) -> Any:
        """Blocking read (reader process only)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._buf or self._closed, timeout=timeout):
                raise ChannelTimeout(f"channel {self.id} read timed out")
            if not self._buf:
                raise ChannelClosed(self.id)
            item = self._buf.popleft()
            self._cond.notify_all()
        if isinstance(item, _WireBlob):
            # Decode may itself block (DeviceChannel waits on a p2p
            # recv): pass the caller's remaining budget along so a
            # bounded read stays bounded end to end.
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            return self._decode(item.blob, remaining)
        return item

    def try_read(self) -> Any:
        """Non-blocking read; raises ChannelTimeout when empty."""
        return self.read(timeout=0)

    def close(self) -> None:
        """Close and KEEP the registry entry as a tombstone: a push still
        in flight at teardown must find a closed channel (and fail back
        to its writer) — not silently recreate an orphan buffer."""
        with self._cond:
            self._closed = True
            self._buf.clear()
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def __repr__(self):
        return (f"{type(self).__name__}({self.id}, cap={self.capacity}, "
                f"reader={self.reader_addr or 'local'})")


class ArrayChannel(Channel):
    """Channel for tensors: co-located handoff passes the tensor by
    reference (a CUDA tensor stays on its card, zero copies);
    cross-process handoff ships the host bytes as an out-of-band blob
    chunk (a ``T`` frame for a torch tensor, ``A`` for a numpy array)
    and the reader lands a card tensor's bytes on its own card. Non-tensor
    payloads (dicts, strings, errors) pass through the ordinary codec
    untouched."""

    kind = "array"

    def _encode_chunks(self, value: Any) -> list:
        import numpy as np
        if serialization._is_tensor(value):
            # A card tensor is copied to the host here (a snapshot by
            # nature); a CPU tensor's buffer goes as a VIEW unless the
            # writer keeps owning it (see below).
            if self._snapshot_writes and not value.is_cuda:
                value = value.clone()
            return serialization.pack_array_chunks(value)
        if (type(value) is np.ndarray and value.dtype.kind not in "OV"
                and value.flags.c_contiguous):
            # The array buffer goes to the transport as a VIEW — zero
            # writer-side copies. Contract: the producer hands the value
            # off and must not mutate it afterwards (compiled-graph ops
            # return a fresh array per iteration, which is exactly that).
            # Edges written by the DRIVER carry user-owned arrays with
            # no such contract: the compiler marks those channels
            # `_snapshot_writes` and the frame is built over a private
            # copy instead.
            if self._snapshot_writes:
                value = value.copy()
            return serialization.pack_array_chunks(value)
        return super()._encode_chunks(value)

    def _decode(self, blob, timeout: Optional[float] = None) -> Any:
        if not isinstance(blob, (bytes, bytearray, memoryview)):
            # Already a decoded value (e.g. a tensor deposited by the
            # device transport): never round-trip it through host bytes
            # again.
            return blob
        # A ``T`` frame from a card lands on this process's card inside
        # the decode, and raises where there is none.
        return super()._decode(blob, timeout)


# Deadline for a device-transport p2p wait whose peer may have died
# (gloo has no liveness signal of its own — see DeviceChannel).
_P2P_TIMEOUT_S = 600.0


class DeviceChannel(ArrayChannel):
    """Array channel whose data plane is collective p2p: when both
    endpoints hold ranks in a shared `util.collective` group, only a
    dtype/shape header rides the RPC push path (keeping FIFO seq
    semantics and backpressure); the tensor itself moves writer->reader
    via `collective.send`/`recv` over the group's fabric (gloo ring
    today; ICI once the group is device-backed). Reader-side recv runs
    on the consumer thread in `_decode` — in arrival order, so p2p
    matching stays FIFO per edge (each channel uses its own tag).
    Either endpoint lacking a group rank falls back to the ArrayChannel
    push transport for that value."""

    kind = "device"

    def _tag(self) -> int:
        # Stable per-edge tag so several device channels between the
        # same rank pair never cross-match.
        import zlib
        return zlib.crc32(self.id.encode()) & 0x3FFFFFFF

    _ROUTE_RETRY_BUDGET = 3

    def _route_retry(self) -> None:
        """Count a transient route-resolution failure (either endpoint
        mid-startup, RPC hiccup): retried on later writes until the
        budget runs out, so one early race does not silently downgrade
        the edge to the push transport for the channel's lifetime — but
        an endpoint that truly never joins a group settles on push."""
        self._route_attempts += 1
        if self._route_attempts >= self._ROUTE_RETRY_BUDGET:
            self._route_resolved = True

    def _ensure_route(self):
        """(group_name, my_rank, reader_rank) or None. A DEFINITIVE
        answer (both endpoints reached, no shared group after the retry
        budget) is cached forever; transient failures retry via
        `_route_retry`."""
        if self._route_resolved:
            return self._route
        self._route = None
        try:
            from ray_tpu_torch.util import collective
            if self.reader_addr is None:
                self._route_resolved = True   # definitive: no reader
                return None
            mine = collective.local_ranks()
            if not mine:
                # This side may not have run init_collective_group yet.
                self._route_retry()
                return None
            from ray_tpu_torch.core.worker import current_runtime
            rt = current_runtime()

            async def _ask():
                client = await rt._worker_client(self.reader_addr)
                return await client.call("collective_ranks", timeout=10.0)

            theirs = rt._loop.run(_ask(), timeout=15) or {}
            for group, rank in mine.items():
                dst = theirs.get(group)
                if isinstance(dst, int) and dst != rank:
                    self._route = (group, rank, dst)
                    self._route_resolved = True
                    break
            else:
                # The reader answered but shares no group YET — maybe a
                # race with its own init_collective_group.
                self._route_retry()
        except Exception:
            self._route_retry()
        return self._route

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise ChannelClosed(self.id)
        if self._is_local_writer():
            self._write_local(value, timeout)
            return
        route = self._ensure_route()
        if (route is None or not _is_array_like(value)
                or _is_error(value)):
            super().write(value, timeout)
            return
        import numpy as np

        from ray_tpu_torch.core.codec import packb
        group, src, dst = route
        if serialization._is_tensor(value):
            arr = value.detach()
            # The reader allocates by torch's dtype name, and lands on its
            # card a tensor that left one.
            head = {"tt": serialization.dtype_name(arr),
                    "c": int(arr.is_cuda)}
        else:
            arr = np.ascontiguousarray(np.asarray(value))
            if arr.dtype.kind in "OV":
                # Extension/object dtypes: no torch/gloo wire form and
                # dtype.str round-trips to raw void — ride the push
                # transport (which pickles them correctly).
                super().write(value, timeout)
                return
            head = {"d": arr.dtype.str}
        header = b"D" + packb(
            dict(head, s=[int(n) for n in arr.shape], src=src, g=group,
                 t=self._tag()))
        # Header first (seq-ordered push: slot admission + backpressure),
        # then the payload over the collective fabric. The send wait is
        # BOUNDED: a reader that dies between admitting the header and
        # posting its recv must surface an error here, not park this
        # loop thread in gloo forever.
        self._push_chunks([header], timeout)
        from ray_tpu_torch.util import collective
        collective.send(arr, dst, group_name=group, tag=self._tag(),
                        timeout=timeout or _P2P_TIMEOUT_S)
        from ray_tpu_torch.core import attribution
        if attribution.enabled:
            attribution.count("chan.device_send")

    def _decode(self, blob, timeout: Optional[float] = None) -> Any:
        if isinstance(blob, (bytes, bytearray, memoryview)):
            view = memoryview(blob)
            if view[:1] == b"D":
                from ray_tpu_torch.core.codec import unpackb
                head = unpackb(bytes(view[1:]))
                from ray_tpu_torch.util import collective
                # The header has been consumed from the slot queue, so
                # this recv MUST complete (or fail the edge): bailing
                # out early — e.g. with the few-ms budget of a polling
                # read — would drop the frame while the writer's send
                # stays in flight, and the next recv on this tag would
                # FIFO-match the stale tensor (silent data desync). The
                # caller's read timeout bounds waiting for an item to
                # ARRIVE; delivery of an admitted frame is bounded only
                # by the p2p deadline, and a writer dead mid-transfer
                # fails the edge loudly rather than desyncing it.
                try:
                    out = collective.recv(
                        _recv_buffer(head), head["src"],
                        group_name=head["g"], tag=head.get("t", 0),
                        timeout=_P2P_TIMEOUT_S)
                except TimeoutError as e:
                    self._closed = True
                    raise ChannelClosed(
                        f"{self.id}: device-transport writer never "
                        f"delivered an admitted frame: {e}") from e
                if head.get("c") and not out.is_cuda:
                    # From a card over a host (gloo) group: land it on
                    # this process's card, or raise without one.
                    from ray_tpu_torch.util.device_arrays import to_torch
                    return to_torch(out)
                return out
        return super()._decode(blob)


def _recv_buffer(head: dict):
    """What `collective.recv` fills for a device-transport header: a numpy
    array for a numpy payload; for a tensor, a tensor on the group's card
    (NCCL) or on the host (gloo)."""
    import numpy as np
    if "tt" not in head:
        return np.empty(head["s"], np.dtype(head["d"]))
    import torch

    from ray_tpu_torch.util import collective
    device = collective._require(head["g"]).device or "cpu"
    return torch.empty(head["s"], dtype=getattr(torch, head["tt"]),
                       device=device)


def _is_error(value: Any) -> bool:
    from ray_tpu_torch.cgraph.compiler import _ExecError
    return isinstance(value, _ExecError)


def _is_array_like(value: Any) -> bool:
    """True only for actual tensors (torch tensors, numpy arrays):
    coercing a dict or str through np.asarray would mangle it into an
    object ndarray."""
    import numpy as np
    return isinstance(value, np.ndarray) or serialization._is_tensor(value)


_KINDS["obj"] = Channel
_KINDS["array"] = ArrayChannel
_KINDS["device"] = DeviceChannel
