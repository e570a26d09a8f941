"""Value serialization, the port of `ray_tpu/core/serialization.py`: the
full object path that the in-process runtime runs on every return
(`serialize` / `deserialize` / `serialize_error`) and the fast wire codec
that prefix shipping uses (`serialize_fast` / `deserialize_fast`).

The full path writes `[u32 metadata_len][metadata][payload][buffers...]`.
The metadata is the msgpack encoding of ``{"nbuf", "buf_lens",
"payload_len", "err"[, "nd"]}``; the payload is `pickle` protocol 5 with
buffers of 4 KiB or more carried out of band (the reference uses
cloudpickle, which the card machine does not have). A plain C-contiguous
ndarray takes the array-native form and never pickles: the metadata
carries ``"nd": {"d": dtype.str, "s": shape}``, the payload is empty, and
the one buffer is the array; `deserialize` returns a read-only view over
it. Those bytes equal the reference's for the same array.

A fast frame is a 1-byte tag and a payload:

- ``N`` — None;
- ``B`` — bytes, raw;
- ``S`` — str, UTF-8;
- ``A`` — a plain C-contiguous ndarray: a u32 (little-endian) header
  length, the header, then the raw buffer. The header is the msgpack
  encoding of ``{"d": dtype.str, "s": list(shape)}``.

Any other value raises `TypeError` on the fast path: there is no pickle
fallback there, and a frame with another tag raises `ValueError`.

The port carries no msgpack: this module writes and reads the subset it
needs (nil, bool, ints, str, arrays, maps) itself, each at msgpack's
narrowest width, so either side decodes the other's bytes.
"""

from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["SerializedObject", "serialize", "serialize_error", "deserialize",
           "serialize_fast", "deserialize_fast"]

_HEADER = struct.Struct("<I")


def _pack_str(s: str) -> bytes:
    b = s.encode()
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    if n < 1 << 8:
        return b"\xd9" + bytes([n]) + b
    if n < 1 << 16:
        return b"\xda" + struct.pack(">H", n) + b
    return b"\xdb" + struct.pack(">I", n) + b


def _pack_uint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"negative shape entry {v}")
    if v < 1 << 7:
        return bytes([v])
    if v < 1 << 8:
        return b"\xcc" + bytes([v])
    if v < 1 << 16:
        return b"\xcd" + struct.pack(">H", v)
    if v < 1 << 32:
        return b"\xce" + struct.pack(">I", v)
    return b"\xcf" + struct.pack(">Q", v)


def _pack_array_len(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 1 << 16:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _pack_int(v: int) -> bytes:
    if v >= 0:
        return _pack_uint(v)
    if v >= -32:
        return struct.pack(">b", v)
    for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                      (0xD3, ">q")):
        try:
            return bytes([code]) + struct.pack(fmt, v)
        except struct.error:
            continue
    raise OverflowError(f"{v} does not fit msgpack's int64")


def _pack_map_len(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _pack(value: Any) -> bytes:
    """msgpack's bytes for the subset the metadata uses."""
    if value is None:
        return b"\xc0"
    if value is True:
        return b"\xc3"
    if value is False:
        return b"\xc2"
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, str):
        return _pack_str(value)
    if isinstance(value, (list, tuple)):
        return _pack_array_len(len(value)) + b"".join(map(_pack, value))
    if isinstance(value, dict):
        return _pack_map_len(len(value)) + b"".join(
            _pack(k) + _pack(v) for k, v in value.items())
    raise TypeError(f"no msgpack form here for {type(value).__name__}")


def _array_header(dtype: str, shape) -> bytes:
    """msgpack's bytes for {"d": dtype, "s": [shape...]}."""
    return (b"\x82" + _pack_str("d") + _pack_str(dtype) + _pack_str("s")
            + _pack_array_len(len(shape))
            + b"".join(_pack_uint(int(n)) for n in shape))


class _Reader:
    """Reads the msgpack subset `_pack` writes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated array header")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint_of(self, fmt: str) -> int:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def value(self) -> Any:
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return {self.value(): self.value() for _ in range(b & 0x0F)}
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._uint_of(fixed[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._take(self._uint_of(strs[b])).decode()
        arrays = {0xDC: ">H", 0xDD: ">I"}
        if b in arrays:
            return [self.value() for _ in range(self._uint_of(arrays[b]))]
        maps = {0xDE: ">H", 0xDF: ">I"}
        if b in maps:
            return {self.value(): self.value()
                    for _ in range(self._uint_of(maps[b]))}
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} in a header")


def serialize_fast(value: Any) -> bytes:
    """One frame for None, bytes, str or a plain C-contiguous ndarray;
    anything else raises TypeError (never pickles)."""
    t = type(value)
    if value is None:
        return b"N"
    if t is bytes:
        return b"B" + value
    if t is str:
        return b"S" + value.encode()
    if (t is np.ndarray and value.dtype.kind not in "OV"
            and value.flags.c_contiguous):
        head = _array_header(value.dtype.str, value.shape)
        # One copy of the buffer, straight into the frame (a view of an
        # empty array cannot be cast to bytes).
        body = memoryview(value).cast("B") if value.size else b""
        return b"".join((b"A", _HEADER.pack(len(head)), head, body))
    raise TypeError(f"no fast wire form for {t.__name__} (the port's codec "
                    f"never pickles)")


def _decode_header(head: bytes) -> Tuple[np.dtype, List[int]]:
    meta = _Reader(head).value()
    if not isinstance(meta, dict) or set(meta) != {"d", "s"}:
        raise ValueError(f"bad array header {meta!r}")
    return np.dtype(meta["d"]), list(meta["s"])


def deserialize_fast(blob) -> Any:
    view = memoryview(blob)
    tag = view[:1].tobytes()
    body = view[1:]
    if tag == b"N":
        return None
    if tag == b"B":
        return bytes(body)
    if tag == b"S":
        return bytes(body).decode()
    if tag == b"A":
        (head_len,) = _HEADER.unpack_from(body, 0)
        start = _HEADER.size + head_len
        dtype, shape = _decode_header(bytes(body[_HEADER.size:start]))
        arr = np.frombuffer(body[start:], dtype=dtype)
        return arr.reshape(shape)
    raise ValueError(f"bad fast-serialization tag {tag!r}")


# ---------------------------------------------------------------------------
# The full object path (every return of the in-process runtime).
# ---------------------------------------------------------------------------
@dataclass
class SerializedObject:
    """A serialized value: an inline payload plus zero-copy buffer chunks."""

    payload: bytes
    buffers: List[memoryview]
    is_error: bool = False
    nd: Optional[dict] = None   # array-native: {"d": dtype_str, "s": shape}

    def _metadata(self) -> bytes:
        meta = {"nbuf": len(self.buffers),
                "buf_lens": [b.nbytes for b in self.buffers],
                "payload_len": len(self.payload), "err": self.is_error}
        if self.nd is not None:
            meta["nd"] = self.nd
        return _pack(meta)

    def to_bytes(self) -> bytes:
        meta = self._metadata()
        return b"".join([_HEADER.pack(len(meta)), meta, self.payload,
                         *self.buffers])


def is_plain_ndarray(value: Any) -> bool:
    """Exactly np.ndarray (a subclass may carry state pickle must
    capture), C-contiguous, with a fixed-size non-object dtype."""
    return (type(value) is np.ndarray and value.dtype.kind not in "OV"
            and value.flags.c_contiguous)


def serialize_array(value: np.ndarray) -> SerializedObject:
    """Array-native form: a dtype/shape header plus the raw buffer, no
    pickler on either side."""
    return SerializedObject(
        payload=b"",
        buffers=[memoryview(value).cast("B")] if value.size else [],
        nd={"d": value.dtype.str, "s": list(value.shape)})


def serialize(value: Any) -> SerializedObject:
    """Serialize `value`; contiguous buffers of 4 KiB or more go out of
    band."""
    if is_plain_ndarray(value):
        return serialize_array(value)
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(pb: pickle.PickleBuffer) -> bool:
        raw = pb.raw()
        if raw.nbytes >= 4096 and raw.contiguous:
            buffers.append(pb)
            return False  # out of band
        return True

    payload = pickle.dumps(value, protocol=5, buffer_callback=buffer_callback)
    return SerializedObject(payload=payload,
                            buffers=[pb.raw() for pb in buffers])


def serialize_error(exc: BaseException) -> SerializedObject:
    try:
        so = serialize(exc)
    except Exception:
        from ray_tpu_torch.exceptions import RaySystemError

        so = serialize(RaySystemError(f"Unserializable exception: {exc!r}"))
    so.is_error = True
    return so


def deserialize(data) -> Any:
    """Deserialize from a bytes-like; an error object raises (a
    RayTaskError as an instance of its cause's type)."""
    view = memoryview(data)
    (meta_len,) = _HEADER.unpack_from(view, 0)
    off = _HEADER.size
    meta = _Reader(bytes(view[off:off + meta_len])).value()
    off += meta_len
    nd = meta.get("nd")
    if nd is not None:
        blen = meta["buf_lens"][0] if meta["buf_lens"] else 0
        arr = np.frombuffer(view[off:off + blen], dtype=np.dtype(nd["d"]))
        arr = arr.reshape(nd["s"])
        # A view of the stored bytes: writing through it would change the
        # object for every other reader.
        if arr.flags.writeable:
            arr.flags.writeable = False
        return arr
    payload = view[off:off + meta["payload_len"]]
    off += meta["payload_len"]
    buffers = []
    for blen in meta["buf_lens"]:
        buffers.append(view[off:off + blen])
        off += blen

    value = pickle.loads(payload, buffers=buffers)
    if meta.get("err"):
        from ray_tpu_torch.exceptions import RayTaskError

        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        raise value
    return value
