"""msgpack's wire format, written and read in plain Python.

The RPC frames (`core/rpc.py`), the object metadata and the fast frames'
array header (`core/serialization.py`) are msgpack. The port carries no
msgpack package, so this module is its codec: `packb(obj)` gives the
bytes of `msgpack.packb(obj, use_bin_type=True)` and `unpackb(data)`
reads them back as `msgpack.unpackb(data, raw=False)` does, for None,
bool, int (to 64 bits), float (as float64), str, bytes-likes (bin),
lists and tuples (arrays; read back as lists) and dicts (maps). Every
length and int takes msgpack's narrowest form. Any other type raises
`TypeError`, as msgpack does without a `default` hook.
"""

from __future__ import annotations

import struct
from typing import Any, List

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


def _int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B(v))
        elif v < 0x100:
            out.append(b"\xcc" + _B(v))
        elif v < 0x10000:
            out.append(b"\xcd" + _H(v))
        elif v < 0x100000000:
            out.append(b"\xce" + _I(v))
        elif v < 0x10000000000000000:
            out.append(b"\xcf" + _Q(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_b(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _b(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q(v))
    else:
        raise OverflowError("Integer value out of range")


def _str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        out.append(_B(0xA0 | n))
    elif n < 0x100:
        out.append(b"\xd9" + _B(n))
    elif n < 0x10000:
        out.append(b"\xda" + _H(n))
    else:
        out.append(b"\xdb" + _I(n))
    out.append(b)


def _bin(b, out: List[bytes]) -> None:
    n = len(b) if not isinstance(b, memoryview) else b.nbytes
    if n < 0x100:
        out.append(b"\xc4" + _B(n))
    elif n < 0x10000:
        out.append(b"\xc5" + _H(n))
    else:
        out.append(b"\xc6" + _I(n))
    out.append(bytes(b) if not isinstance(b, bytes) else b)


def _len(n: int, fix: int, c16: bytes, c32: bytes, out: List[bytes]) -> None:
    if n < 16:
        out.append(_B(fix | n))
    elif n < 0x10000:
        out.append(c16 + _H(n))
    else:
        out.append(c32 + _I(n))


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if t is str:
        _str(obj, out)
    elif t is int:
        _int(obj, out)
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is dict or isinstance(obj, dict):
        _len(len(obj), 0x80, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list or t is tuple or isinstance(obj, (list, tuple)):
        _len(len(obj), 0x90, b"\xdc", b"\xdd", out)
        for v in obj:
            _pack(v, out)
    elif t is float or isinstance(obj, float):
        out.append(b"\xcb" + _d(obj))
    elif t is bytes or isinstance(obj, (bytes, bytearray, memoryview)):
        _bin(obj, out)
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, str):
        _str(str(obj), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack's bytes for `obj` (as `msgpack.packb(obj,
    use_bin_type=True)` writes them)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
          0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
          0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
          0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
          0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q")}
_U8, _U16, _U32 = _FIXED[0xCC], _FIXED[0xCD], _FIXED[0xCE]
_LENS = {0xC4: _U8, 0xC5: _U16, 0xC6: _U32, 0xD9: _U8, 0xDA: _U16,
         0xDB: _U32, 0xDC: _U16, 0xDD: _U32, 0xDE: _U16, 0xDF: _U32}


def _unpack(data: bytes, pos: int):
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b >= 0xA0 and b < 0xC0:
        end = pos + (b & 0x1F)
        return data[pos:end].decode("utf-8"), end
    if b < 0x90:
        out = {}
        for _ in range(b & 0x0F):
            k, pos = _unpack(data, pos)
            out[k], pos = _unpack(data, pos)
        return out, pos
    if b < 0xA0:
        lst = []
        for _ in range(b & 0x0F):
            v, pos = _unpack(data, pos)
            lst.append(v)
        return lst, pos
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    s = _FIXED.get(b)
    if s is not None:
        return s.unpack_from(data, pos)[0], pos + s.size
    s = _LENS.get(b)
    if s is None:
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")
    (n,) = s.unpack_from(data, pos)
    pos += s.size
    if b <= 0xC6:
        if pos + n > len(data):
            raise ValueError("truncated msgpack data")
        return data[pos:pos + n], pos + n
    if b <= 0xDB:
        return data[pos:pos + n].decode("utf-8"), pos + n
    if b <= 0xDD:
        lst = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            lst.append(v)
        return lst, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        out[k], pos = _unpack(data, pos)
    return out, pos


def unpackb(data) -> Any:
    """The value of one msgpack object (as `msgpack.unpackb(data,
    raw=False)` reads it); trailing bytes raise `ValueError`."""
    data = bytes(data)
    try:
        value, pos = _unpack(data, 0)
    except (IndexError, struct.error) as e:
        raise ValueError("truncated msgpack data") from e
    if pos != len(data):
        raise ValueError("extra data after the msgpack object")
    return value
