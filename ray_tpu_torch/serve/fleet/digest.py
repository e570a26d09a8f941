"""Prompt-side chain hashing and replica digest matching (a copy of
`ray_tpu/serve/fleet/digest.py`).

The fleet router never sees token ids from other replicas — each
replica's engine publishes a *digest*: the set of chained path hashes of
every node in its radix prefix index (`PrefixIndex.digest()`). Because
the hashes chain (node hash folds the parent's hash in —
`prefix_index.chunk_chain_hash`), membership of a prompt's i-th block
hash implies the whole i-block prefix is resident on that replica, so
"longest cached prefix" reduces to one set-membership scan from the
longest candidate down. Collisions are possible (64-bit) and harmless:
a digest is a routing *hint* — the engine's own radix match at admission
is the ground truth, and a false hit merely costs one cold prefill on a
suboptimal replica.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ray_tpu_torch.serve.engine.prefix_index import chunk_chain_hash

__all__ = ["prompt_chain_hashes", "ReplicaDigest"]


def prompt_chain_hashes(tokens: Sequence[int],
                        block_size: int) -> List[int]:
    """The chained hash of every FULL block prefix of `tokens` —
    hashes[i] identifies the (i+1)-block prefix. Sub-block remainders
    are not hashed: sealed blocks are the shipping/sharing unit."""
    toks = [int(t) for t in tokens]
    out: List[int] = []
    h = 0
    for i in range(len(toks) // block_size):
        h = chunk_chain_hash(h, toks[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


class ReplicaDigest:
    """One replica's published prefix summary, stamped at publish time
    so the router can reason about staleness."""

    __slots__ = ("hashes", "nodes", "stamp")

    def __init__(self, hashes, nodes: int = 0,
                 stamp: Optional[float] = None):
        self.hashes = frozenset(hashes)
        self.nodes = int(nodes)
        self.stamp = time.monotonic() if stamp is None else stamp

    @classmethod
    def from_engine(cls, engine) -> "ReplicaDigest":
        d = engine.prefix_digest()
        if d is None:
            return cls((), 0)
        return cls(d["hashes"], d["nodes"])

    def match_blocks(self, hashes: Sequence[int]) -> int:
        """Longest cached prefix of a prompt whose chain hashes are
        `hashes`, in BLOCKS. Scans longest-first: chaining makes the
        first hit the answer."""
        for i in range(len(hashes) - 1, -1, -1):
            if hashes[i] in self.hashes:
                return i + 1
        return 0

    def age_s(self) -> float:
        return time.monotonic() - self.stamp
