"""Blocks: the unit of data movement, the port of `ray_tpu/data/block.py`.

Reference equivalent: `python/ray/data/block.py` + `_internal/arrow_block.py`.
A block is a dict of numpy column arrays on the host (the layout
`iter_torch_batches` hands to `torch.from_numpy` without conversion), not an
Arrow table. Arrow and pandas appear only at the IO edges (parquet/csv
readers), and only where they are installed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def block_from_rows(rows: List[Dict[str, Any]]) -> Block:
    if not rows:
        return {}
    cols = rows[0].keys()
    return {c: np.asarray([r[c] for r in rows]) for c in cols}


def block_to_rows(block: Block) -> List[Dict[str, Any]]:
    if not block:
        return []
    n = block_num_rows(block)
    cols = list(block)
    return [{c: block[c][i] for c in cols} for i in range(n)]


def block_num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def block_slice(block: Block, start: int, end: int) -> Block:
    return {c: v[start:end] for c, v in block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    cols = blocks[0].keys()
    return {c: np.concatenate([b[c] for b in blocks]) for c in cols}


def rebatch(block_iter: Iterator[Block], batch_size: Optional[int]
            ) -> Iterator[Block]:
    """Re-chunk a stream of blocks into exactly-`batch_size` batches
    (last one may be short). batch_size=None passes blocks through."""
    if batch_size is None:
        yield from (b for b in block_iter if block_num_rows(b))
        return
    carry: List[Block] = []
    carried = 0
    for block in block_iter:
        n = block_num_rows(block)
        if n == 0:
            continue
        offset = 0
        while offset < n:
            take = min(batch_size - carried, n - offset)
            carry.append(block_slice(block, offset, offset + take))
            carried += take
            offset += take
            if carried == batch_size:
                yield concat_blocks(carry)
                carry, carried = [], 0
    if carry:
        yield concat_blocks(carry)
