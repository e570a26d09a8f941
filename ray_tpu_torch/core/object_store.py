"""Per-node shared-memory object store (plasma equivalent), the port of
`ray_tpu/core/object_store.py` without its native store, hosted inside
the raylet process like the reference hosts plasma in-process
(`src/ray/object_manager/plasma/store_runner.h`).

Design: one POSIX shm segment per object (`multiprocessing.shared_memory`),
named from the object id — workers on the node attach by name for zero-copy
reads; only control messages (create/seal/get/delete) cross the RPC socket,
the data plane is mmap. Node-to-node transfer (reference:
`object_manager/` push/pull) fetches the payload over the raylet RPC channel
and re-seals it locally. Capacity is enforced with LRU eviction of
unreferenced sealed objects (reference: `eviction_policy.h`).
"""

from __future__ import annotations

import logging
import mmap
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Set, Tuple

try:
    import _posixshmem   # CPython's shm_open binding (Linux/macOS)
except ImportError:      # pragma: no cover - non-POSIX fallback
    _posixshmem = None

logger = logging.getLogger(__name__)

SHM_PREFIX = "rtt_"


class _RawShm:
    """Minimal attach to an existing POSIX shm segment: shm_open + mmap,
    with NO resource_tracker registration.

    `multiprocessing.shared_memory.SharedMemory` registers every attach
    with the tracker daemon and our `_untrack` then unregisters it — two
    tracker-pipe writes that cost ~0.5 ms each on virtualized kernels
    and dominated the get-10MB p50 (round-7 copy audit). The raylet owns
    segment lifetime, so a worker attach must be bookkeeping-free."""

    __slots__ = ("name", "buf", "_mmap")

    def __init__(self, name: str):
        fd = _posixshmem.shm_open("/" + name, os.O_RDWR, mode=0)
        try:
            size = os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.name = name
        self.buf = memoryview(self._mmap)

    def close(self) -> None:
        if self.buf is not None:
            self.buf.release()   # BufferError while views are alive
            self.buf = None
        self._mmap.close()       # BufferError while derived views live


def attach_segment(name: str):
    """Attach `name` for reading/writing with the cheapest available
    mechanism (raw shm_open on POSIX; SharedMemory elsewhere)."""
    if _posixshmem is not None:
        return _RawShm(name)
    shm = shared_memory.SharedMemory(name=name)
    _untrack(shm)
    return shm


def shm_name_for(object_id_hex: str, prefix: str = SHM_PREFIX) -> str:
    """shm names are limited (~31 chars portable past the prefix). An
    ObjectID is TaskID(48 hex) + index(8 hex) — sibling returns/puts of
    one task differ ONLY in the trailing index, so the name must keep the
    tail."""
    if len(object_id_hex) <= 25:
        return prefix + object_id_hex
    return prefix + object_id_hex[:17] + object_id_hex[-8:]


@dataclass
class _Entry:
    size: int
    shm: shared_memory.SharedMemory
    sealed: bool = False
    created_at: float = field(default_factory=time.time)
    # pins: worker ids currently using the buffer (get in flight)
    pins: Set[str] = field(default_factory=set)


class LocalObjectStore:
    """The in-raylet store state machine (no I/O here; the raylet wires it
    to RPC handlers)."""

    def __init__(self, capacity_bytes: int, prefix: str = SHM_PREFIX):
        self.capacity = capacity_bytes
        self._prefix = prefix
        self.used = 0
        self._objects: "OrderedDict[str, _Entry]" = OrderedDict()
        # Segments unlinked while a read_view still aliased the mapping:
        # retried on later deletes so their __del__ never squawks.
        self._deferred_close: List[Any] = []

    # -- create/seal (reference: plasma store.cc ProcessCreateRequests) --
    def create(self, oid: str, size: int) -> str:
        if oid in self._objects:
            entry = self._objects[oid]
            if entry.sealed:
                raise FileExistsError(f"object {oid[:8]} already sealed")
            return entry.shm.name
        if size > self.capacity:
            raise MemoryError(
                f"object of {size} bytes exceeds store capacity "
                f"{self.capacity}")
        self._ensure_space(size)
        name = shm_name_for(oid, self._prefix)
        try:
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=max(size, 1))
        except FileExistsError:
            # Stale segment from a dead process: reclaim it.
            stale = shared_memory.SharedMemory(name=name)
            stale.close()
            stale.unlink()
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=max(size, 1))
        self._objects[oid] = _Entry(size=size, shm=shm)
        self.used += size
        return shm.name

    def seal(self, oid: str) -> None:
        entry = self._objects.get(oid)
        if entry is None:
            raise KeyError(f"cannot seal unknown object {oid[:8]}")
        entry.sealed = True
        self._objects.move_to_end(oid)

    def put_bytes(self, oid: str, data: bytes) -> None:
        """Create+write+seal in one step (used by the pull path)."""
        if self.contains(oid):
            return
        self.create(oid, len(data))
        entry = self._objects[oid]
        entry.shm.buf[: len(data)] = data
        self.seal(oid)

    def create_from(self, oid: str, chunks) -> None:
        """Buffer-protocol put: create+write+seal from a chunk list (any
        bytes-like, including memoryviews over array buffers) with no
        intermediate join — each chunk is copied exactly once, into the
        segment."""
        if self.contains(oid):
            return
        size = sum(len(c) for c in chunks)
        self.create(oid, size)
        entry = self._objects[oid]
        off = 0
        for c in chunks:
            n = len(c)
            entry.shm.buf[off:off + n] = c
            off += n
        self.seal(oid)

    # -- read ------------------------------------------------------------
    def contains(self, oid: str) -> bool:
        entry = self._objects.get(oid)
        return entry is not None and entry.sealed

    def info(self, oid: str) -> Optional[Tuple[str, int]]:
        entry = self._objects.get(oid)
        if entry is None or not entry.sealed:
            return None
        self._objects.move_to_end(oid)  # LRU touch
        return entry.shm.name, entry.size

    def size_of(self, oid: str) -> Optional[int]:
        """Sealed-object size for metadata queries (no LRU touch)."""
        entry = self._objects.get(oid)
        if entry is None or not entry.sealed:
            return None
        return entry.size

    def read_bytes(self, oid: str) -> bytes:
        entry = self._objects.get(oid)
        if entry is None or not entry.sealed:
            raise KeyError(f"object {oid[:8]} not present/sealed")
        return bytes(entry.shm.buf[: entry.size])

    def read_view(self, oid: str) -> memoryview:
        """Zero-copy view over a sealed object's segment.

        Lifetime contract: the view aliases the live mapping. `delete`
        (explicit or via eviction) unlinks the segment but the mapping —
        and therefore an already-taken view — stays readable until the
        last view dies (frozen-mapping guarantee); a read_view AFTER the
        delete raises KeyError."""
        entry = self._objects.get(oid)
        if entry is None or not entry.sealed:
            raise KeyError(f"object {oid[:8]} not present/sealed")
        self._objects.move_to_end(oid)  # LRU touch
        return entry.shm.buf[: entry.size]

    def read_range(self, oid: str, offset: int, length: int) -> bytes:
        """One transfer chunk (reference: object_manager chunked reads,
        object_manager.h default 1 MiB chunks)."""
        entry = self._objects.get(oid)
        if entry is None or not entry.sealed:
            raise KeyError(f"object {oid[:8]} not present/sealed")
        end = min(offset + length, entry.size)
        return bytes(entry.shm.buf[offset:end])

    def write_range(self, oid: str, offset: int, data: bytes) -> None:
        """Fill part of a created-but-unsealed entry (chunked pull)."""
        entry = self._objects.get(oid)
        if entry is None:
            raise KeyError(f"object {oid[:8]} was not created")
        if entry.sealed:
            return  # concurrent pull already completed it
        entry.shm.buf[offset:offset + len(data)] = data

    def pin(self, oid: str, worker_id: str) -> None:
        entry = self._objects.get(oid)
        if entry is not None:
            entry.pins.add(worker_id)

    def unpin(self, oid: str, worker_id: str) -> None:
        entry = self._objects.get(oid)
        if entry is not None:
            entry.pins.discard(worker_id)

    def object_inventory(self) -> list:
        """Resident-object inventory (reference: `ray memory` /
        object_store_stats)."""
        return [{"object_id": oid, "size": e.size, "sealed": e.sealed,
                 "created_at": e.created_at, "num_pins": len(e.pins)}
                for oid, e in self._objects.items()]

    # -- delete/evict ----------------------------------------------------
    def delete(self, oid: str) -> bool:
        entry = self._objects.pop(oid, None)
        if entry is None:
            return False
        self.used -= entry.size
        try:
            entry.shm.unlink()
        except FileNotFoundError:
            pass
        try:
            entry.shm.close()
        except BufferError:
            # A read_view is still alive: the unlinked mapping stays
            # valid for that view (frozen-mapping guarantee); park the
            # handle and retry once the view's holder drops it.
            self._deferred_close.append(entry.shm)
        except FileNotFoundError:
            pass
        if self._deferred_close:
            parked, self._deferred_close = self._deferred_close, []
            for shm in parked:
                try:
                    shm.close()
                except BufferError:
                    self._deferred_close.append(shm)
                except Exception:
                    pass
        return True

    def _ensure_space(self, size: int) -> None:
        if self.used + size <= self.capacity:
            return
        # LRU-evict sealed, unpinned objects (reference: eviction_policy.h).
        for oid in list(self._objects):
            if self.used + size <= self.capacity:
                break
            entry = self._objects[oid]
            if entry.sealed and not entry.pins:
                logger.debug("evicting %s (%d bytes)", oid[:8], entry.size)
                self.delete(oid)
        if self.used + size > self.capacity:
            from ray_tpu_torch.exceptions import ObjectStoreFullError
            raise ObjectStoreFullError(
                f"store full: need {size}, used {self.used}/{self.capacity} "
                "and nothing evictable")

    def stats(self) -> Dict[str, float]:
        return {
            "capacity": self.capacity,
            "used": self.used,
            "num_objects": len(self._objects),
        }

    def shutdown(self) -> None:
        for oid in list(self._objects):
            self.delete(oid)


def make_store(capacity_bytes: int, *, node_id: str = ""):
    """The node's store: the Python shm store, outright (the native C++
    store of the reference waits for a later slice of the port). Its
    segment names carry the port's prefix and the node id, so the
    reference's cluster and the port's can run side by side."""
    from ray_tpu_torch.core.config import ray_config

    if ray_config().native_object_store:
        raise NotImplementedError(
            "native_object_store: the native shm store (ray_tpu/native/"
            "store.cc) comes with a later slice of the port")
    tag = (node_id or str(os.getpid()))[:8]
    return LocalObjectStore(capacity_bytes, prefix=f"{SHM_PREFIX}{tag}_")


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """The raylet owns segment lifetime; detach this process's
    resource_tracker registration so it neither warns nor double-unlinks
    at interpreter exit."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


def _pwritev_chunks(fd: int, chunks) -> None:
    """Scatter-gather write of a chunk list at offset 0 of `fd`."""
    iov = [memoryview(c) for c in chunks if len(c)]
    off = 0
    while iov:
        # Kernel iovec limit: feed at most IOV_MAX (1024) chunks
        # per call; the partial-write loop naturally resumes.
        n = os.pwritev(fd, iov[:1024], off)
        if n <= 0:
            raise OSError("pwritev returned %d" % n)
        off += n
        # Drop fully-written chunks; split a partial one.
        while iov and n >= len(iov[0]):
            n -= len(iov[0])
            iov.pop(0)
        if iov and n:
            iov[0] = iov[0][n:]


class WorkerStoreClient:
    """Worker-side zero-copy access to the node store: control via raylet
    RPC (done by the caller), data via direct shm attach (reference:
    plasma/client.h). Attaches use raw shm_open+mmap (`attach_segment`),
    never `SharedMemory` — the latter's resource-tracker registration
    costs two tracker-pipe writes (~1 ms total on virtualized kernels)
    per attach/release cycle, which dominated get-10MB before round 7."""

    def __init__(self):
        self._attached: Dict[str, Any] = {}

    def write(self, shm_name: str, payload_writer) -> None:
        shm = attach_segment(shm_name)
        try:
            payload_writer(shm.buf)
        finally:
            shm.close()

    def write_chunks(self, shm_name: str, chunks) -> None:
        """Write the object image via pwritev on the tmpfs file.

        Writing through a fresh shared mapping pays a write fault per
        page (~1 ms/MB on this kernel class, even for pre-faulted
        pages); pwritev copies in the kernel with no user page-table
        faults — ~memcpy speed into a pool-prefaulted segment. One
        syscall, scatter-gather over the serialized chunks."""
        try:
            fd = os.open(f"/dev/shm/{shm_name}", os.O_RDWR)
        except OSError:
            # Non-tmpfs shm layout: fall back to the mmap path.
            self.write(shm_name, lambda buf: _copy_chunks_into(buf, chunks))
            return
        try:
            _pwritev_chunks(fd, chunks)
        finally:
            os.close(fd)

    def read(self, shm_name: str, size: int) -> memoryview:
        """Attach and return a zero-copy view. The segment stays attached
        until `release` (the view must not outlive it)."""
        shm = self._attached.get(shm_name)
        if shm is None:
            shm = attach_segment(shm_name)
            self._attached[shm_name] = shm
        return shm.buf[:size]

    def try_attach(self, shm_name: str) -> bool:
        """Attach `shm_name` if it still exists; False when the store
        unlinked it (evicted/spilled). Used by the node-local read
        bypass: attaching is the liveness check — the store never reuses
        a segment name for another object and an existing mapping stays
        valid after eviction (store.cc frozen-mapping guarantee), so
        success here means a later `read` returns the right bytes."""
        if shm_name in self._attached:
            return True
        try:
            shm = attach_segment(shm_name)
        except (FileNotFoundError, OSError, ValueError):
            return False
        self._attached[shm_name] = shm
        return True

    # Mappings whose buffers were still referenced by deserialized
    # zero-copy arrays at release time: parked here and retried on later
    # releases, so a streaming consumer's mappings unmap one step behind
    # consumption instead of accumulating for process lifetime.
    _deferred: list = []

    def _try_close(self, shm) -> None:
        try:
            shm.close()
        except BufferError:
            self._deferred.append(shm)

    def _sweep_deferred(self) -> None:
        parked, self._deferred = self._deferred, []
        for shm in parked:
            self._try_close(shm)

    def release(self, shm_name: str) -> None:
        shm = self._attached.pop(shm_name, None)
        if shm is not None:
            self._try_close(shm)
        self._sweep_deferred()

    def close(self) -> None:
        for shm in self._attached.values():
            self._try_close(shm)
        self._attached.clear()


def _copy_chunks_into(buf, chunks) -> None:
    off = 0
    for c in chunks:
        n = len(c)
        buf[off:off + n] = c
        off += n
