"""Binary identifiers for every entity in the system.

Mirrors the reference's ID scheme (`src/ray/common/id.h`,
`src/ray/design_docs/id_specification.md`): fixed-width random/derived binary
IDs with cheap hashing and hex round-tripping. Sizes follow the reference:
JobID 4 bytes, ActorID 16, TaskID 24, ObjectID 28 (TaskID + 4-byte put/return
index), NodeID/WorkerID/PlacementGroupID 28/28/18.
"""

from __future__ import annotations

import os
import random
import struct
import threading

_NIL = b"\xff"

# ID randomness comes from a process-local PRNG seeded once from the OS
# (reference: id.h fills from an xorshift generator seeded per process,
# not /dev/urandom per ID). IDs need uniqueness, not unpredictability,
# and os.urandom is a syscall — measured 20-25 us on virtualized hosts,
# paid once per submitted task before this. Fork safety: a forked child
# reseeds so parent and child never draw the same stream.
_rand = random.Random(os.urandom(16))
_rand_lock = threading.Lock()

if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _rand.seed(os.urandom(16)))


def random_bytes(n: int) -> bytes:
    with _rand_lock:
        return _rand.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    SIZE = 28
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        self._hash = hash(binary)

    @classmethod
    def from_random(cls):
        return cls(random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == _NIL * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class UniqueID(BaseID):
    SIZE = 28


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def to_int(self) -> int:
        return struct.unpack(">I", self._binary)[0]


class NodeID(BaseID):
    SIZE = 28


class WorkerID(BaseID):
    SIZE = 28


class ActorID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(random_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[-JobID.SIZE:])


class TaskID(BaseID):
    SIZE = 24

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        return cls(random_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(random_bytes(cls.SIZE - ActorID.SIZE) + actor_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[-JobID.SIZE:])


class ObjectID(BaseID):
    """TaskID (24 bytes) + big-endian uint32 index.

    Index 0 is reserved for `put` objects (the reference reserves index
    semantics similarly); return values use indices 1..n like the reference's
    return-object numbering.
    """

    SIZE = 28

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", 0x80000000 | put_index))

    @classmethod
    def for_return(cls, task_id: TaskID, return_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", return_index))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[: TaskID.SIZE])

    def index(self) -> int:
        return struct.unpack(">I", self._binary[TaskID.SIZE:])[0]


class PlacementGroupID(BaseID):
    SIZE = 18

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(random_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())


class _Counter:
    """Thread-safe monotonically increasing counter (per-worker put/task indices)."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


__all__ = [
    "BaseID",
    "UniqueID",
    "JobID",
    "NodeID",
    "WorkerID",
    "ActorID",
    "TaskID",
    "ObjectID",
    "PlacementGroupID",
]
