"""Radix prefix index: prompt -> longest cached KV prefix (a copy of
`ray_tpu/serve/engine/prefix_index.py`; it touches the cache only through
`KVCacheManager`'s accounting calls).

Reference: Zheng et al., "SGLang: Efficient Execution of Structured
Language Model Programs" (RadixAttention) and the vLLM prefix-caching
lineage — a radix tree over token-id chunks at **block granularity**
maps an incoming prompt to the longest prefix whose KV blocks are
already resident, so a fleet-wide system prompt is prefilled once and
every later conversation adopts its blocks by reference.

Each tree node is exactly one sealed (full) KV block: `chunk` is the
`block_size`-token id tuple the block holds, `block` its physical index
in the `KVCacheManager`. The index holds ONE reference on every block
it indexes (`cache.retain` on insert, `cache.release` on evict), so an
indexed prefix outlives the sequence that prefilled it — retirement and
preemption free only private tails.

- `match(tokens)` walks full chunks from the root, then checks the last
  matched node's children for a block whose leading tokens complete the
  prompt's sub-block remainder (the *partial-tail* hit: a prompt that is
  a mid-block proper prefix of an indexed sequence adopts that block
  shared and COW-faults on its first write into it). Mid-prompt
  divergence is NOT partially adopted — a diverging sequence would
  immediately copy the block, paying a COW for a handful of saved
  prefill tokens.
- `insert(tokens, table)` is called as prefill seals full blocks; only
  newly created nodes retain their block (re-inserting an adopted path
  is a LRU touch, and duplicate content prefilled by a raced sequence
  keeps the first-indexed block).
- `evict(n)` frees up to n blocks by removing cold **leaf** nodes whose
  block has no holder but the index (refcount 1), oldest-use first;
  cascades upward as parents become leaves. This is the reclaimer the
  cache calls under block pressure, so admissions evict cold prefixes
  instead of being rejected.

Single-writer discipline: match/insert/evict run on the engine loop
thread; the lock only guards concurrent `stats()` readers.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_ROOT_CHAIN = 0


def chunk_chain_hash(parent: int, chunk: Sequence[int]) -> int:
    """Stable 64-bit hash of a radix path extended by one sealed block's
    token chunk. Chained (each node's hash folds its parent's in), so a
    single hash identifies the whole prefix path — digest membership of
    hash #i implies blocks [0, i] are all resident. blake2b, not
    `hash()`: digests cross replica/process boundaries and Python's
    builtin hash is salted per interpreter."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent.to_bytes(8, "little"))
    h.update(struct.pack(f"<{len(chunk)}q", *[int(t) for t in chunk]))
    return int.from_bytes(h.digest(), "little")


class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "last_use",
                 "chain")

    def __init__(self, chunk: Optional[Tuple[int, ...]],
                 block: Optional[int], parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0
        # Chained path hash (chunk_chain_hash of the root->here chunk
        # sequence) — what replica digests are made of.
        self.chain = _ROOT_CHAIN


class PrefixIndex:
    """Block-granularity radix tree over cached prompt prefixes."""

    def __init__(self, cache, block_size: Optional[int] = None):
        self.cache = cache
        self.block_size = int(block_size if block_size is not None
                              else cache.block_size)
        self._root = _Node(None, None, None)
        self._nodes = 0
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted = 0
        self.evictions = 0
        self.exports = 0

    # -- lookup --------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens`: returns (block ids to
        adopt, tokens covered). Coverage is whole blocks, plus one
        shared partial block when it completes the prompt exactly."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        with self._lock:
            stamp = next(self._clock)
            node = self._root
            blocks: List[int] = []
            covered = 0
            for i in range(len(toks) // bs):
                child = node.children.get(tuple(toks[i * bs:(i + 1) * bs]))
                if child is None:
                    break
                child.last_use = stamp
                blocks.append(child.block)
                covered += bs
                node = child
            rem = len(toks) - covered
            if 0 < rem < bs and covered == (len(toks) // bs) * bs:
                # Sub-block remainder at the frontier: adopt a child
                # block whose leading tokens ARE the remainder (prompt
                # is a mid-block proper prefix of an indexed sequence).
                tail = tuple(toks[covered:])
                for chunk, child in node.children.items():
                    if chunk[:rem] == tail:
                        child.last_use = stamp
                        blocks.append(child.block)
                        covered = len(toks)
                        break
            if covered:
                self.hits += 1
                self.hit_tokens += covered
            else:
                self.misses += 1
            return blocks, covered

    # -- insertion -----------------------------------------------------
    def insert(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Index every FULL block of a just-prefilled sequence
        (`table[i]` holds `tokens[i*bs:(i+1)*bs]`). Existing nodes are
        touched, new ones retain their block; returns how many nodes
        were created."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        created = 0
        with self._lock:
            stamp = next(self._clock)
            node = self._root
            for i in range(min(len(toks) // bs, len(table))):
                chunk = tuple(toks[i * bs:(i + 1) * bs])
                child = node.children.get(chunk)
                if child is None:
                    block = int(table[i])
                    self.cache.retain(block)
                    child = _Node(chunk, block, node)
                    child.chain = chunk_chain_hash(node.chain, chunk)
                    node.children[chunk] = child
                    self._nodes += 1
                    self.inserted += 1
                    created += 1
                child.last_use = stamp
                node = child
        return created

    # -- fleet surface ---------------------------------------------------
    def digest(self, max_entries: int = 4096) -> Dict[str, object]:
        """Compact summary of the sealed prefix blocks this index holds:
        the set of chained path hashes of every node (capped,
        newest-use first under the cap). The fleet router matches an
        incoming prompt's own chain hashes against these sets — because
        hashes chain, membership of the prompt's i-th hash implies the
        whole i-block prefix is resident here. This is what replicas
        publish through the scrape path: O(nodes) ints, no token ids."""
        with self._lock:
            rows: List[Tuple[int, int]] = []   # (last_use, chain)
            stack = list(self._root.children.values())
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                rows.append((nd.last_use, nd.chain))
            if len(rows) > max_entries:
                rows.sort(reverse=True)
                rows = rows[:max_entries]
            return {"hashes": frozenset(c for _, c in rows),
                    "nodes": self._nodes}

    def export_chain(self, tokens: Sequence[int]
                     ) -> List[Tuple[Tuple[int, ...], int]]:
        """The matched FULL-block path for `tokens` as
        [(chunk, block), ...] — what cross-replica prefix shipping
        reads. Touches LRU stamps (an exported prefix is hot by
        definition) but does not count as a hit/miss: shipping is not an
        admission."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        out: List[Tuple[Tuple[int, ...], int]] = []
        with self._lock:
            stamp = next(self._clock)
            node = self._root
            for i in range(len(toks) // bs):
                child = node.children.get(tuple(toks[i * bs:(i + 1) * bs]))
                if child is None:
                    break
                child.last_use = stamp
                out.append((child.chunk, child.block))
                node = child
            if out:
                self.exports += 1
        return out

    # -- eviction ------------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Free up to `n_blocks` by evicting cold leaf nodes whose only
        holder is the index (block refcount 1), LRU first, cascading as
        parents become leaves. Returns blocks actually freed — this is
        the `KVCacheManager` reclaimer."""
        freed = 0
        with self._lock:
            # One DFS collects every evictable leaf into an LRU heap;
            # cascading parents enter the heap with their own stamps as
            # their last child leaves — O(nodes + victims log nodes),
            # not a full rescan per victim.
            heap: List[Tuple[int, int, _Node]] = []
            stack = list(self._root.children.values())
            while stack:
                nd = stack.pop()
                if nd.children:
                    stack.extend(nd.children.values())
                elif self.cache.block_ref(nd.block) == 1:
                    heap.append((nd.last_use, id(nd), nd))
            heapq.heapify(heap)
            while heap and freed < n_blocks:
                _, _, nd = heapq.heappop(heap)
                parent = nd.parent
                parent.children.pop(nd.chunk, None)
                nd.parent = None
                self._nodes -= 1
                self.evictions += 1
                self.cache.release(nd.block)
                freed += 1
                if (parent is not self._root and not parent.children
                        and self.cache.block_ref(parent.block) == 1):
                    heapq.heappush(heap,
                                   (parent.last_use, id(parent), parent))
        return freed

    def evictable_blocks(self) -> int:
        """How many blocks a full `evict` could free right now. Nodes
        whose block has an active holder beyond the index pin their
        ancestors too (an adopter's table spans its whole matched
        path), so every refcount-1 node cascades out eventually."""
        with self._lock:
            count = 0
            stack = list(self._root.children.values())
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if self.cache.block_ref(nd.block) == 1:
                    count += 1
            return count

    def release_all(self) -> int:
        """Evict everything evictable (tests / shutdown)."""
        return self.evict(self._nodes)

    # -- observability -------------------------------------------------
    def held_blocks(self) -> int:
        with self._lock:
            return self._nodes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "nodes": self._nodes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "inserted": self.inserted,
                "evictions": self.evictions,
                "exports": self.exports,
            }
