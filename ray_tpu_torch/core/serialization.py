"""The fast wire codec, the part of `ray_tpu/core/serialization.py` that
prefix shipping uses (`serialize_fast` / `deserialize_fast`).

A frame is a 1-byte tag and a payload:

- ``N`` — None;
- ``B`` — bytes, raw;
- ``S`` — str, UTF-8;
- ``A`` — a plain C-contiguous ndarray: a u32 (little-endian) header
  length, the header, then the raw buffer. The header is the msgpack
  encoding of ``{"d": dtype.str, "s": list(shape)}``, which this module
  writes and reads itself (the port carries no msgpack): a fixmap of two
  entries, each key a fixstr, the dtype string a str, the shape an array
  of unsigned ints, each at msgpack's narrowest width. The bytes equal the
  reference's for the same array, so either side decodes the other's
  frames.

Any other value raises `TypeError`: there is no pickle fallback, and a
frame with another tag raises `ValueError`. `deserialize_fast` returns an
array as a read-only view over the frame.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

__all__ = ["serialize_fast", "deserialize_fast"]

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


def _array_header(dtype: str, shape) -> bytes:
    """msgpack's bytes for {"d": dtype, "s": [shape...]}."""
    return (b"\x82" + _pack_str("d") + _pack_str(dtype) + _pack_str("s")
            + _pack_array_len(len(shape))
            + b"".join(_pack_uint(int(n)) for n in shape))


class _Reader:
    """Reads the msgpack subset `_array_header` writes."""

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
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return {self.value(): self.value() for _ in range(b & 0x0F)}
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if b in fixed:
            return self._uint_of(fixed[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._take(self._uint_of(strs[b])).decode()
        arrays = {0xDC: ">H", 0xDD: ">I"}
        if b in arrays:
            return [self.value() for _ in range(self._uint_of(arrays[b]))]
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} in an array "
                         f"header")


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
