"""Block-granular KV-cache manager (the vLLM PagedAttention idea).

Reference: Kwon et al., "Efficient Memory Management for Large Language
Model Serving with PagedAttention" (SOSP'23) — the KV cache is carved
into fixed-size blocks in ONE preallocated buffer; each sequence owns an
ordered block list instead of a contiguous max-length slab, so cache
memory is committed token-by-token and freed the moment a sequence
retires. Fragmentation is bounded to less than one block per sequence,
and admission/preemption decisions reduce to free-block arithmetic.

Blocks are **refcounted and shareable** (prefix sharing): a full block
holding a common prompt prefix can appear in many sequences' tables at
once — `adopt` extends a table by reference (refcount bump, no copy, no
recompute), `free` decrements and only reclaims a block at refcount
zero, and a write into a block whose refcount is above one first copies
it into a private block (**copy-on-write**). `utilization` counts
*physical* blocks once no matter how many tables reference them. The
prefix index (`prefix_index.py`) holds one reference on every block it
indexes via `retain`/`release`, and the manager calls an optional
*reclaimer* under block pressure so cold indexed prefixes are evicted
instead of admissions being rejected.

The manager owns two things:

- **accounting**: the free-block list, per-block refcounts, per-sequence
  block tables and written lengths — `can_allocate` / `allocate` /
  `adopt` / `free` are what the iteration scheduler calls between
  decode steps;
- **storage**: the preallocated `[num_blocks, block_size, *kv_shape]`
  buffer, with `write` / `write_range` / `gather` translating logical
  token positions through the table. The buffer is a numpy array
  (default) or, with `device_pool=True`, a **device-resident pool**: one
  torch tensor on `device`, mutated in place (`index_put_`, `copy_`).
  The paged decode path (`EngineConfig.paged_decode`, on by default)
  reads the pool inside the model's step through block tables
  (`with_pool`, `paged_step`), so no per-sequence KV crosses to the
  host; the `host_gathers` counter shows it.

This is the port of `ray_tpu/serve/engine/kv_cache.py`. JAX's donated
jitted updates become in-place tensor updates; `paged_step` and
`mutate_pool` keep the re-bind interface (the model's step returns the
pool, here the same tensor). JAX scatters padding rows to block
`num_blocks` with `mode="drop"`; torch has no drop mode, and such an index
is a device-side assert on a card, so padding rows are never written.

Determinism contract (the scheduler's loop must never crash on OOM):
`allocate` is atomic — it either extends the table (and privatizes the
requested write range) or changes nothing and returns False; the
scheduler converts False into preempt-and-requeue of the lowest-priority
sequence. COW faults never surprise the decode loop: the scheduler
passes `writable_from` so the copy is planned into the same atomic
free-block arithmetic as table growth.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device


class CacheOverflowError(RuntimeError):
    """A single sequence needs more tokens than the whole cache holds —
    the one OOM shape that cannot be fixed by preempting someone else."""


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((0,), dtype)).dtype


def host_array(values) -> np.ndarray:
    """`values` (numpy, list or a tensor on any device) as a numpy array;
    numpy has no bfloat16, so a bfloat16 tensor comes back as float32."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
        if values.dtype == torch.bfloat16:
            values = values.float()
        return values.numpy()
    return np.asarray(values)


def _weakly(fn: Optional[Callable]) -> Optional[Callable]:
    """`fn`, through a weak reference when it is a bound method; called
    after its object is gone, it returns 0."""
    if fn is None or not hasattr(fn, "__self__"):
        return fn
    ref = weakref.WeakMethod(fn)

    def call(*args):
        method = ref()
        return 0 if method is None else method(*args)

    return call


class KVCacheManager:
    """Fixed-size refcounted blocks in one preallocated buffer +
    per-sequence block tables. Thread-safe (the engine loop and
    `stats()` callers race)."""

    def __init__(self, num_blocks: int, block_size: int,
                 kv_shape: Tuple[int, ...] = (), dtype=np.float32,
                 device_pool: bool = False, device: DeviceLike = None):
        """`dtype` is a numpy dtype, or a torch dtype for a device pool.
        `device` places a device pool (default: the first CUDA card)."""
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_shape = tuple(kv_shape)
        self._device = bool(device_pool)
        shape = (self.num_blocks, self.block_size) + self.kv_shape
        # THE preallocated cache: every sequence's KV lives here.
        if self._device:
            self._buffer = torch.zeros(shape, dtype=_torch_dtype(dtype),
                                       device=resolve_device(device))
        else:
            self._buffer = np.zeros(shape, dtype)
        # Data-movement counters: `host_gathers` counts calls that
        # materialize per-sequence KV for the model's host-gather decode
        # (what the paged path removes); `pool_updates` counts in-place
        # mutations of the device pool.
        self.host_gathers = 0
        self.pool_updates = 0
        # LIFO free list: recently-freed blocks are cache-warm.
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}          # block -> holder count
        self._tables: Dict[str, List[int]] = {}
        self._lens: Dict[str, int] = {}
        # Reentrant: `with_pool` callbacks legitimately read tables /
        # lengths through the public accessors while the lock is held.
        self._lock = threading.RLock()
        self.cow_copies = 0
        self.adoptions = 0
        # Under block pressure, `allocate` asks the reclaimer to free
        # up to N blocks (the prefix index evicts cold nodes); the
        # countable half feeds `can_allocate` so admission control sees
        # evictable capacity as available instead of rejecting.
        self._reclaimer: Optional[Callable[[int], int]] = None
        self._evictable: Optional[Callable[[], int]] = None

    def set_reclaimer(self, reclaim: Optional[Callable[[int], int]],
                      evictable: Optional[Callable[[], int]] = None
                      ) -> None:
        """Install the block-pressure callbacks. `reclaim(n)` must free
        up to n blocks (via `release`) and return how many it freed; it
        is called WITHOUT the cache lock held. `evictable()` returns how
        many blocks a full reclaim could free right now.

        Bound methods are held weakly (a dead one frees nothing): their
        object, the prefix index, holds this cache, and a strong
        reference back would make the two a cycle, whose pool — on the
        card, the engine's KV memory — only the cycle collector would
        free after the engine is dropped."""
        self._reclaimer = _weakly(reclaim)
        self._evictable = _weakly(evictable)

    # -- accounting ----------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        return self.num_blocks * self.block_size

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def utilization(self) -> float:
        """Fraction of PHYSICAL blocks allocated — a block shared by a
        thousand sequences counts once."""
        with self._lock:
            return 1.0 - len(self._free) / self.num_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return max(0, math.ceil(n_tokens / self.block_size))

    def seq_len(self, seq_id: str) -> int:
        with self._lock:
            return self._lens.get(seq_id, 0)

    def block_table(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._tables.get(seq_id, ()))

    def block_ref(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    def _plan(self, seq_id: str, target_tokens: int,
              writable_from: Optional[int]) -> Tuple[int, int]:
        """(growth deficit, COW copies) to cover `target_tokens` with
        every block overlapping [writable_from, target) private."""
        table = self._tables.get(seq_id, ())
        need = self.blocks_for(target_tokens)
        grow = max(0, need - len(table))
        cow = 0
        if writable_from is not None and writable_from < target_tokens:
            first = writable_from // self.block_size
            for b in table[first:min(len(table), need)]:
                if self._refs.get(b, 0) > 1:
                    cow += 1
        return grow, cow

    def can_allocate(self, seq_id: str, target_tokens: int,
                     writable_from: Optional[int] = None) -> bool:
        """Would `allocate(...)` succeed right now — counting blocks a
        reclaim could evict as available?"""
        with self._lock:
            grow, cow = self._plan(seq_id, target_tokens, writable_from)
            shortfall = grow + cow - len(self._free)
        if shortfall <= 0:
            return True
        return (self._evictable is not None
                and self._evictable() >= shortfall)

    def allocate(self, seq_id: str, target_tokens: int,
                 writable_from: Optional[int] = None) -> bool:
        """Grow `seq_id`'s table to cover `target_tokens` total tokens;
        when `writable_from` is given, additionally privatize (COW)
        every shared block overlapping positions
        [writable_from, target_tokens) so subsequent writes never fault.
        Atomic: returns False (and changes nothing) on a shortfall,
        after asking the reclaimer to evict cold prefixes. Raises
        CacheOverflowError when the request exceeds the whole cache —
        no amount of preemption can satisfy it."""
        if target_tokens > self.capacity_tokens:
            raise CacheOverflowError(
                f"sequence needs {target_tokens} tokens; the cache holds "
                f"{self.capacity_tokens} "
                f"({self.num_blocks}x{self.block_size})")
        while True:
            with self._lock:
                grow, cow = self._plan(seq_id, target_tokens,
                                       writable_from)
                shortfall = grow + cow - len(self._free)
                if shortfall <= 0:
                    self._commit(seq_id, target_tokens, grow,
                                 writable_from)
                    return True
            # Block pressure: evict cold indexed prefixes (the
            # reclaimer calls `release`, which takes the lock — so the
            # lock must NOT be held here) and retry; no progress means
            # genuinely full.
            if self._reclaimer is None:
                return False
            if self._reclaimer(shortfall) <= 0:
                return False

    def _commit(self, seq_id: str, target_tokens: int, grow: int,
                writable_from: Optional[int]) -> None:
        table = self._tables.setdefault(seq_id, [])
        for _ in range(grow):
            b = self._free.pop()
            self._refs[b] = 1
            table.append(b)
        if writable_from is not None and writable_from < target_tokens:
            first = writable_from // self.block_size
            last = min(len(table), self.blocks_for(target_tokens))
            for i in range(first, last):
                if self._refs.get(table[i], 0) > 1:
                    self._privatize_locked(seq_id, i)

    def adopt(self, seq_id: str, blocks: Sequence[int],
              n_tokens: int) -> None:
        """Extend `seq_id`'s (empty) table by REFERENCE to existing
        blocks whose contents already cover positions [0, n_tokens) —
        the prefix-hit admission: refcount bumps, no copy, no prefill.
        The adopted coverage is recorded as the sequence's written
        length, so `gather` serves it immediately."""
        with self._lock:
            if self._tables.get(seq_id):
                raise ValueError(
                    f"adopt requires an empty table for {seq_id!r}")
            if n_tokens > len(blocks) * self.block_size:
                raise ValueError("adopted blocks do not cover n_tokens")
            for b in blocks:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(f"block {b} is not allocated")
            for b in blocks:
                self._refs[b] += 1
            self._tables[seq_id] = list(blocks)
            self._lens[seq_id] = n_tokens
            self.adoptions += 1

    def retain(self, block: int) -> None:
        """Add one reference to an allocated block (the prefix index's
        hold on a block it has indexed)."""
        with self._lock:
            if self._refs.get(block, 0) < 1:
                raise ValueError(f"block {block} is not allocated")
            self._refs[block] += 1

    def release(self, block: int) -> bool:
        """Drop one reference; returns True when the block went back to
        the free list (last holder gone)."""
        with self._lock:
            return self._release_locked(block)

    def _release_locked(self, block: int) -> bool:
        n = self._refs.get(block, 0)
        if n < 1:
            raise ValueError(f"block {block} is not allocated")
        if n == 1:
            del self._refs[block]
            self._free.append(block)
            return True
        self._refs[block] = n - 1
        return False

    def free(self, seq_id: str) -> int:
        """Release every block of a retired/preempted sequence; returns
        how many blocks actually came back to the free list. Shared
        blocks (held by the prefix index or other sequences) survive —
        preemption only reclaims a sequence's private tail."""
        with self._lock:
            table = self._tables.pop(seq_id, [])
            self._lens.pop(seq_id, None)
            freed = 0
            for b in reversed(table):
                if self._release_locked(b):
                    freed += 1
            return freed

    # -- cross-replica shipping ----------------------------------------
    def read_block(self, block: int) -> np.ndarray:
        """Host copy of one allocated block's contents
        (`[block_size, *kv_shape]`) — what prefix shipping exports. A
        copy, not a view: the frame outlives the lock, and the source
        block may COW/evict underneath a view."""
        with self._lock:
            if self._refs.get(block, 0) < 1:
                raise ValueError(f"block {block} is not allocated")
            return np.array(host_array(self._buffer[block]))

    def install_block(self, values) -> Optional[int]:
        """Allocate one free block, fill it with `values`
        (`[block_size, *kv_shape]`) and return its index with ONE
        reference held by the caller — the receiving half of prefix
        shipping (the caller hands the reference to the prefix index
        via `insert` + `release`). Asks the reclaimer under pressure
        like `allocate`; returns None when genuinely full."""
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        expect = (self.block_size,) + self.kv_shape
        if tuple(values.shape) != expect:
            raise ValueError(
                f"install_block expects shape {expect}, got "
                f"{tuple(values.shape)}")
        while True:
            with self._lock:
                if self._free:
                    b = self._free.pop()
                    self._refs[b] = 1
                    if self._device:
                        self._buffer[b].copy_(self._pool_values(values))
                        self.pool_updates += 1
                    else:
                        self._buffer[b] = host_array(values)
                    return b
            if self._reclaimer is None or self._reclaimer(1) <= 0:
                return None

    # -- storage -------------------------------------------------------
    def _pool_values(self, values) -> torch.Tensor:
        if isinstance(values, np.ndarray) and not values.flags.writeable:
            # A decoded wire frame is a read-only view, which torch wraps
            # only with a warning; copy it on the host first.
            values = np.array(values)
        return torch.as_tensor(values, dtype=self._buffer.dtype,
                               device=self._buffer.device)

    def _slot(self, seq_id: str, pos: int) -> Tuple[int, int]:
        table = self._tables.get(seq_id)
        if table is None or pos // self.block_size >= len(table):
            raise IndexError(
                f"position {pos} of sequence {seq_id!r} has no allocated "
                f"block (table covers "
                f"{len(table or ()) * self.block_size} tokens)")
        return pos // self.block_size, pos % self.block_size

    def _privatize_locked(self, seq_id: str, block_idx: int) -> int:
        """The COW fault: copy a shared block into a fresh private one
        and repoint this sequence's table at the copy. Caller holds the
        lock and has ensured a free block exists."""
        table = self._tables[seq_id]
        old = table[block_idx]
        if not self._free:
            raise RuntimeError(
                "COW fault with no free block — the scheduler must "
                "allocate(writable_from=...) before writing into a "
                "shared block")
        new = self._free.pop()
        if self._device:
            self._buffer[new].copy_(self._buffer[old])
            self.pool_updates += 1
        else:
            self._buffer[new] = self._buffer[old]
        self._refs[new] = 1
        self._refs[old] -= 1          # shared => was > 1, stays >= 1
        table[block_idx] = new
        self.cow_copies += 1
        return new

    def _writable_block(self, seq_id: str, pos: int) -> Tuple[int, int]:
        """Slot lookup that COWs on the way in (backstop — the engine
        pre-privatizes via allocate(writable_from=...))."""
        idx, off = self._slot(seq_id, pos)
        table = self._tables[seq_id]
        if self._refs.get(table[idx], 0) > 1:
            self._privatize_locked(seq_id, idx)
        return table[idx], off

    def _scatter(self, blocks: Sequence[int], offs: Sequence[int],
                 values) -> None:
        """Write row i of `values` at slot (blocks[i], offs[i]), one
        `index_put_` for a whole prefill range or a decode batch. Only
        the given rows are written: there are no padding rows."""
        n = len(blocks)
        if not n:
            return
        dev = self._buffer.device
        b = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
        o = torch.as_tensor(np.asarray(offs, np.int64), device=dev)
        self._buffer.index_put_((b, o), self._pool_values(values[:n]))
        self.pool_updates += 1

    def write(self, seq_id: str, pos: int, value) -> None:
        """Store one token's KV entry at logical position `pos`. A
        write into a shared block privatizes it first (COW)."""
        with self._lock:
            block, off = self._writable_block(seq_id, pos)
            if self._device:
                self._buffer[block, off].copy_(self._pool_values(value))
                self.pool_updates += 1
            else:
                self._buffer[block, off] = host_array(value)
            self._lens[seq_id] = max(self._lens.get(seq_id, 0), pos + 1)

    def write_range(self, seq_id: str, start: int, values) -> None:
        """Store KV entries for positions [start, start+len(values)) —
        the prefill bulk write. Shared blocks in the range privatize
        first (COW). The numpy pool writes block-sized slices in place;
        the device pool resolves every token's (block, off) slot and
        lands the whole range in one scatter."""
        n = len(values)
        with self._lock:
            if not self._device:
                values = host_array(values)
                pos = start
                written = 0
                while written < n:
                    block, off = self._writable_block(seq_id, pos)
                    take = min(self.block_size - off, n - written)
                    self._buffer[block, off:off + take] = \
                        values[written:written + take]
                    written += take
                    pos += take
            elif n:
                blocks: List[int] = []
                offs: List[int] = []
                for pos in range(start, start + n):
                    block, off = self._writable_block(seq_id, pos)
                    blocks.append(block)
                    offs.append(off)
                self._scatter(blocks, offs, values)
            self._lens[seq_id] = max(self._lens.get(seq_id, 0), start + n)

    def write_step(self, entries: Sequence[Tuple[str, int]],
                   values) -> None:
        """Batched one-token-per-sequence decode-step write: row i of
        `values` (`[b_pad, *kv_shape]`) lands at `entries[i]`'s
        (seq_id, pos) slot. Rows past `len(entries)` are padding and
        are not written. Shared blocks privatize first (COW), same as
        `write`."""
        b = len(entries)
        with self._lock:
            blocks: List[int] = []
            offs: List[int] = []
            for seq_id, pos in entries:
                blk, off = self._writable_block(seq_id, pos)
                blocks.append(blk)
                offs.append(off)
                self._lens[seq_id] = max(
                    self._lens.get(seq_id, 0), pos + 1)
            if self._device:
                self._scatter(blocks, offs, values)
            else:
                self._buffer[blocks, offs] = host_array(values)[:b]

    def with_pool(self, fn):
        """Run `fn(pool)` on the live buffer under the cache lock — the
        in-step reader's entry point (paged prefill gathers the adopted
        prefix straight from the pool). `fn` must treat the pool as
        read-only; mutations go through the manager."""
        with self._lock:
            return fn(self._buffer)

    def mutate_pool(self, fn):
        """Run ``fn(pool) -> (result, new_pool)`` under the cache lock
        and re-bind the buffer — for a model step that owns the pool for
        the call without going through `paged_step`'s slot resolution
        (e.g. a read-only full-prefix-hit decode with an empty write
        list)."""
        with self._lock:
            result, new_pool = fn(self._buffer)
            self._buffer = new_pool
            if self._device:
                self.pool_updates += 1
            return result

    def paged_step(self, entries: Sequence[Tuple[str, int]], fn):
        """One fused paged decode step. Resolves each entry's
        (seq_id, pos) to a private (block, off) slot (COW backstop,
        same as `write`), calls ``fn(pool, blocks, offs)`` — the
        model's step, which gathers KV through the tables, computes,
        writes the new tokens' KV at the given slots in place and
        returns ``(result, pool)`` — then re-binds the buffer and
        records the written lengths, all under the cache lock: readers
        can neither see the pre-write pool after lens advance nor race
        the write."""
        with self._lock:
            blocks: List[int] = []
            offs: List[int] = []
            for seq_id, pos in entries:
                blk, off = self._writable_block(seq_id, pos)
                blocks.append(blk)
                offs.append(off)
            result, new_pool = fn(self._buffer, blocks, offs)
            self._buffer = new_pool
            if self._device:
                self.pool_updates += 1
            for seq_id, pos in entries:
                self._lens[seq_id] = max(
                    self._lens.get(seq_id, 0), pos + 1)
            return result

    def gather(self, seq_id: str, length: Optional[int] = None):
        """Contiguous `[length, *kv_shape]` copy of a sequence's cache
        (a numpy view for the host pool, a tensor on the pool's device
        otherwise) — what the model's host-gather decode attends over.
        One gather over whole blocks."""
        with self._lock:
            self.host_gathers += 1
            n = self._lens.get(seq_id, 0) if length is None else length
            if n == 0:
                return self._buffer[0, 0:0]
            nblocks = math.ceil(n / self.block_size)
            idx = self._tables.get(seq_id, [])[:nblocks]
            if self._device:
                rows = self._buffer.index_select(0, torch.as_tensor(
                    idx, dtype=torch.long, device=self._buffer.device))
            else:
                rows = self._buffer[np.asarray(idx, np.int64)]
            return rows.reshape(
                (nblocks * self.block_size,) + self.kv_shape)[:n]

    @property
    def pool_residency(self) -> str:
        """Where the block pool lives: `device` (a torch tensor mutated
        in place) or `host` (numpy)."""
        return "device" if self._device else "host"

    @property
    def pool_bytes(self) -> int:
        """Size of the preallocated block pool in bytes."""
        if self._device:
            return self._buffer.numel() * self._buffer.element_size()
        return self._buffer.nbytes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            used = self.num_blocks - len(self._free)
            shared = sum(1 for n in self._refs.values() if n > 1)
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "used_blocks": used,
                "free_blocks": len(self._free),
                "utilization": used / self.num_blocks,
                "sequences": len(self._tables),
                "shared_blocks": shared,
                "cow_copies": self.cow_copies,
                "adoptions": self.adoptions,
                "pool_residency": self.pool_residency,
                "pool_bytes": self.pool_bytes,
                "host_gathers": self.host_gathers,
                "pool_updates": self.pool_updates,
            }
