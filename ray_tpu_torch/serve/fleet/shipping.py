"""Cross-replica prefix shipping: sealed KV blocks as array-native
wire frames (the port of `ray_tpu/serve/fleet/shipping.py`).

A prefix cached anywhere should be cached everywhere. When the fleet
router routes a request to a replica whose cached match is shorter than
some other replica's (miss-with-remote-hit), the holder *exports* its
matched block chain (`engine.export_prefix` — chunk token ids + block
contents) and the receiver *adopts* it (`engine.import_prefix` —
install into its own `KVCacheManager`, reference-semantics insert into
its `PrefixIndex`), so the hot system prompt prefills once per fleet
instead of once per replica.

Framing rides the fast wire form (`core.serialization.serialize_fast` /
`deserialize_fast`, byte for byte the reference's): every frame is an
array-native "A" blob — chunk ids as one int64 `[n, block_size]` array,
each block's KV as its own contiguous float frame — decoded back as
numpy views over the frame. NO pickling anywhere on this path. The
in-process fleet round-trips every ship through the same codec, so the
wire contract is exercised on every ship.

On a card the block goes device to host to device: the holder's
`read_block` copies it out of its card pool (under the cache lock, so a
concurrent write on the holder's engine thread cannot tear it), and the
receiver's `install_block` copies the decoded frame into its own pool.
A receiver that runs out of blocks adopts the head it could install
(`import_prefix` returns the tokens covered); nothing falls back to a
host-side KV path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ray_tpu_torch.core.serialization import deserialize_fast, serialize_fast

__all__ = ["encode_prefix_frames", "decode_prefix_frames", "ship_prefix"]


def encode_prefix_frames(chunks: Sequence[Sequence[int]],
                         kv_blocks: Sequence[np.ndarray]) -> List[bytes]:
    """[chunk-ids frame, kv frame, kv frame, ...] — all array-native
    ("A"-tagged) blobs; empty chain encodes to an empty list."""
    if not chunks:
        return []
    frames = [serialize_fast(np.asarray(chunks, np.int64))]
    for kv in kv_blocks:
        frames.append(serialize_fast(
            np.ascontiguousarray(np.asarray(kv))))
    return frames


def decode_prefix_frames(frames: Sequence[bytes]
                         ) -> Tuple[List[Tuple[int, ...]],
                                    List[np.ndarray]]:
    if not frames:
        return [], []
    ids = deserialize_fast(frames[0])
    chunks = [tuple(int(t) for t in row) for row in ids]
    kvs = [deserialize_fast(f) for f in frames[1:]]
    if len(kvs) != len(chunks):
        raise ValueError(
            f"prefix frame mismatch: {len(chunks)} chunks, "
            f"{len(kvs)} kv blocks")
    return chunks, kvs


def ship_prefix(src_engine, dst_engine,
                tokens: Sequence[int]) -> int:
    """Export `tokens`' cached chain from `src_engine` and adopt it on
    `dst_engine`; returns tokens now covered on the receiver (0 when
    the source holds nothing or the receiver had no capacity). The
    chain round-trips through the wire frames even in-process, so the
    never-pickled contract holds on every ship."""
    chunks, kvs = src_engine.export_prefix(tokens)
    if not chunks:
        return 0
    frames = encode_prefix_frames(chunks, kvs)
    chunks2, kvs2 = decode_prefix_frames(frames)
    return dst_engine.import_prefix(chunks2, kvs2)
