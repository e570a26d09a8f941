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

`serialize_fast` writes only those four and raises `TypeError` for any
other value (prefix shipping never pickles). Compiled-graph channels
write the reference's full form with `serialize_fast_into`, into a buffer
they reuse, and read it with `deserialize_fast(blob, full=True)`; it adds

- ``M`` — a bool, int or float, msgpack-encoded;
- ``T`` — a torch tensor (the port's own tag): like ``A``, with the header
  ``{"t": torch dtype name, "s": shape, "c": 1 if it lay on a card}``, so
  that bfloat16, which numpy lacks, survives. A tensor from a card is
  copied to the host once its stream is done with it, and the reader
  lands it on its own card (`util.device_arrays.to_torch`: `cuda:0`
  inside its lease), or raises where it has none; a CPU tensor lands as
  a CPU tensor;
- ``P`` — anything else, through the full object path below.

Without `full`, a frame with any tag but the first four raises
`ValueError`.

A CUDA tensor inside any pickled value (a task's return, a ``P`` frame)
travels the same way: its bytes out of band, landed on the reader's card.

The port carries no msgpack: `core/codec.py` writes and reads msgpack's
bytes, so either side decodes the other's. Nor cloudpickle: a function or
class inside a value pickles by reference (`core/function_manager.py`),
and a lambda or closure raises a `TypeError` that names it.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import types
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.codec import packb, unpackb

__all__ = ["SerializedObject", "serialize", "serialize_error", "deserialize",
           "serialize_fast", "serialize_fast_into", "pack_array_chunks",
           "deserialize_fast", "check_sendable"]

_HEADER = struct.Struct("<I")


def _array_header(dtype: str, shape) -> bytes:
    """msgpack's bytes for {"d": dtype, "s": [shape...]}."""
    return packb({"d": dtype, "s": [int(n) for n in shape]})


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
    meta = unpackb(head)
    if not isinstance(meta, dict) or set(meta) != {"d", "s"}:
        raise ValueError(f"bad array header {meta!r}")
    return np.dtype(meta["d"]), list(meta["s"])


def serialize_fast_into(value: Any, buf: bytearray) -> None:
    """Append the full fast form of `value` to `buf` (reused across calls
    by channel writers): N, B, S, M, A or T where the value allows, else
    P."""
    t = type(value)
    if value is None:
        buf += b"N"
    elif t is bytes:
        buf += b"B"
        buf += value
    elif t is str:
        buf += b"S"
        buf += value.encode()
    elif t in (bool, int, float):
        try:
            buf += b"M" + packb(value)
        except OverflowError:   # an int past 64 bits
            buf += b"P"
            serialize(value).write_into(buf)
    elif is_plain_ndarray(value) or _is_tensor(value):
        for chunk in pack_array_chunks(value):
            buf += chunk
    else:
        buf += b"P"
        serialize(value).write_into(buf)


def _is_tensor(value: Any) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and type(value) is torch.Tensor


def _tensor_host_bytes(t) -> Tuple[Any, bool]:
    """(a contiguous CPU tensor of `t`'s values, whether `t` lay on a
    card). A card tensor is copied on its current stream, which the copy
    waits out, so the producer's work on it has finished."""
    t = t.detach()
    on_card = t.device.type == "cuda"
    if on_card:
        t = t.to("cpu")
    return t.contiguous(), on_card


def dtype_name(t) -> str:
    """A tensor's dtype as torch names it ("float32", "bfloat16")."""
    return str(t.dtype).rpartition(".")[2]


def _byte_view(t) -> memoryview:
    """The bytes of a contiguous CPU tensor, as a view."""
    import torch

    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def pack_array_chunks(value) -> list:
    """The ``A`` frame of a plain C-contiguous ndarray, or the ``T`` frame
    of a torch tensor, as a chunk list ``[tag + u32 head_len + head, raw
    buffer]`` for a transport that sends the chunks as they are. The
    buffer chunk views the array (or the CPU tensor; a card tensor's is
    its host copy): a caller that cannot keep the array unchanged until
    the transport has sent it copies it first."""
    if _is_tensor(value):
        host, on_card = _tensor_host_bytes(value)
        head = packb({"t": dtype_name(host),
                      "s": [int(n) for n in host.shape],
                      "c": int(on_card)})
        chunks = [b"T" + _HEADER.pack(len(head)) + head]
        if host.numel():
            chunks.append(_byte_view(host))
        return chunks
    head = _array_header(value.dtype.str, value.shape)
    chunks = [b"A" + _HEADER.pack(len(head)) + head]
    if value.size:   # a view of an empty array cannot be cast to bytes
        chunks.append(memoryview(value).cast("B"))
    return chunks


def land_tensor(dtype_name: str, shape, data, on_card: bool):
    """A tensor from its raw bytes: on this process's card (`cuda:0`
    inside its lease) where it came from one, which raises without a
    card; else a CPU tensor that owns its memory."""
    import warnings

    import torch

    dtype = getattr(torch, dtype_name)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"bad tensor dtype {dtype_name!r}")
    n = 1
    for d in shape:
        n *= int(d)
    if n == 0:
        host = torch.empty(shape, dtype=dtype)
    else:
        with warnings.catch_warnings():
            # The wire buffer may be read-only: the tensor made over it
            # is only read, to copy it.
            warnings.simplefilter("ignore", UserWarning)
            host = torch.frombuffer(data, dtype=dtype, count=n).reshape(
                shape)
    if on_card:
        from ray_tpu_torch.util.device_arrays import to_torch

        return to_torch(host)
    return host.clone()


def deserialize_fast(blob, *, full: bool = False) -> Any:
    """Read one fast frame. With `full`, also the M, T and P frames of
    `serialize_fast_into`."""
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
    if full:
        if tag == b"M":
            return unpackb(bytes(body))
        if tag == b"T":
            (head_len,) = _HEADER.unpack_from(body, 0)
            start = _HEADER.size + head_len
            head = unpackb(bytes(body[_HEADER.size:start]))
            return land_tensor(head["t"], head["s"], body[start:],
                               bool(head["c"]))
        if tag == b"P":
            return deserialize(body)
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

    def total_size(self) -> int:
        return (_HEADER.size + len(self._metadata()) + len(self.payload)
                + sum(b.nbytes for b in self.buffers))

    def _metadata(self) -> bytes:
        meta = {"nbuf": len(self.buffers),
                "buf_lens": [b.nbytes for b in self.buffers],
                "payload_len": len(self.payload), "err": self.is_error}
        if self.nd is not None:
            meta["nd"] = self.nd
        return packb(meta)

    def to_bytes(self) -> bytes:
        return b"".join(self.chunks())

    def write_into(self, buf) -> None:
        """Append the wire format to `buf`."""
        for chunk in self.chunks():
            buf += chunk

    def chunks(self) -> List:
        """The wire format as a chunk list (for scatter-gather writes)."""
        meta = self._metadata()
        return [_HEADER.pack(len(meta)) + meta, self.payload, *self.buffers]


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


class _Pickler(pickle.Pickler):
    """Protocol 5; functions and classes by reference (see
    `function_manager.reduce_by_reference`)."""

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)):
            from ray_tpu_torch.core.function_manager import (
                reduce_by_reference)

            return reduce_by_reference(obj)
        if (type(obj).__name__ == "Tensor" and _is_tensor(obj)
                and obj.is_cuda and not obj.requires_grad):
            # torch's own pickling would record the writer's device index
            # and go through torch.save; this sends the bytes (out of
            # band where the caller takes buffers) and lands them on the
            # reader's card. A tensor that requires grad keeps torch's
            # own, which carries (or refuses) its autograd state.
            host, _ = _tensor_host_bytes(obj)
            data = (pickle.PickleBuffer(_byte_view(host)) if host.numel()
                    else b"")
            return land_tensor, (dtype_name(host), tuple(host.shape), data,
                                 True)
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    """Maps `__main__` onto the driver's main file where a worker loaded
    it (`function_manager.load_main`)."""

    def find_class(self, module, name):
        if module == "__main__":
            from ray_tpu_torch.core.function_manager import MAIN_ALIAS

            if MAIN_ALIAS in sys.modules:
                module = MAIN_ALIAS
        return super().find_class(module, name)


def check_sendable(what: str, value: Any) -> None:
    """Raises, before any worker starts, the `TypeError` that sending
    `value` to one would raise: `what` names the argument, and the message
    says the rule (a module-level function or class, or a
    `functools.partial` of one)."""
    try:
        dumps(value)
    except TypeError as e:
        raise TypeError(
            f"{what} cannot be sent to a worker: the port sends functions "
            f"and classes by reference, so pass a module-level function or "
            f"class, or a functools.partial of one ({e})") from None


def dumps(value: Any, buffer_callback=None) -> bytes:
    """Pickle `value` as the object path does."""
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
    return f.getvalue()


def loads(data, buffers=None) -> Any:
    return _Unpickler(io.BytesIO(data), buffers=buffers).load()


def serialize(value: Any, *,
              ref_serializer: Optional[Callable[[Any], None]] = None
              ) -> SerializedObject:
    """Serialize `value`; contiguous buffers of 4 KiB or more go out of
    band. `ref_serializer` sees every ObjectRef inside the value (the
    owner's borrowing protocol)."""
    if is_plain_ndarray(value):
        return serialize_array(value)
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(pb: pickle.PickleBuffer) -> bool:
        raw = pb.raw()
        if raw.nbytes >= 4096 and raw.contiguous:
            buffers.append(pb)
            return False  # out of band
        return True

    from ray_tpu_torch.core.object_ref import _serialization_context

    with _serialization_context(ref_serializer):
        payload = dumps(value, buffer_callback=buffer_callback)
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


def deserialize(data, *,
                ref_deserializer: Optional[Callable[[Any], None]] = None,
                raise_errors: bool = True) -> Any:
    """Deserialize from a bytes-like; an error object raises (a
    RayTaskError as an instance of its cause's type) unless
    `raise_errors` is false."""
    view = memoryview(data)
    (meta_len,) = _HEADER.unpack_from(view, 0)
    off = _HEADER.size
    meta = unpackb(view[off:off + meta_len])
    off += meta_len
    nd = meta.get("nd")
    if nd is not None:
        from ray_tpu_torch.core import attribution

        if attribution.enabled:
            attribution.count("get.nd_view")
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

    from ray_tpu_torch.core.object_ref import _serialization_context

    with _serialization_context(ref_deserializer):
        value = loads(payload, buffers=buffers)
    if meta.get("err") and raise_errors:
        from ray_tpu_torch.exceptions import RayTaskError

        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        raise value
    return value
