"""Iteration-level scheduler: the continuous-batching decode loop (the
port of `ray_tpu/serve/engine/scheduler.py`). Every iteration sets the
`serve_engine_*` instruments of `serve/_private/metrics.py` in the
process registry; `stats()` reports the same counters.

Reference: Yu et al., "Orca: A Distributed Serving System for
Transformer-Based Generative Models" (OSDI'22) — scheduling decisions
are made per *iteration* (one decode step), not per batch: newly-arrived
requests join the running batch between steps, finished sequences retire
immediately, and no request ever waits for a batch-mate to finish. Under
cache pressure the engine preempts the lowest-priority sequence
(freeing its blocks, requeueing it for recompute — vLLM's recompute
preemption mode) instead of crashing or deadlocking the loop.

The engine is deliberately split so the unit tier can drive it without
threads: `step()` executes exactly one scheduler iteration (admissions →
capacity check/preemption → one decode step → retirements) and is what
the tests call in a plain loop; `start()` merely runs
`step()` on a daemon thread with an idle-event park, which is how a
Serve replica hosts it.

`policy="static"` runs the SAME loop but only admits into an empty
batch (the `@serve.batch` shape: form once, hold to completion) — the
honest baseline the `llm_serve` bench compares continuous batching
against, paying identical per-step bookkeeping.

Prefix sharing (on by default): admission consults a radix prefix
index (`prefix_index.PrefixIndex`) and ADOPTS the longest cached prefix
by reference — matched blocks cost a refcount bump instead of prefill
compute and duplicate cache capacity; only the unmatched tail is
prefilled (`model.prefill(tokens, prefix_kv)` when the model supports
prefix prefill, full recompute with tail-only writes otherwise). A
prompt that is fully cached skips the prefill pass entirely: its first
token is one `model.decode` step over the adopted blocks. Preemption
frees only a sequence's private tail (shared blocks survive and stay
indexed), and cold prefixes are LRU-evicted under block pressure
instead of admissions being rejected.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.core import attribution, flight
from ray_tpu_torch.serve.engine.kv_cache import (CacheOverflowError,
                                                 KVCacheManager)
from ray_tpu_torch.serve.engine.prefix_index import PrefixIndex


class EngineOverloadedError(RuntimeError):
    """The waiting queue is full — the caller should shed, not enqueue.

    `retry_after_s` (set at raise time from the engine's observed queue
    drain rate) tells the shedding edge how long a well-behaved client
    should back off — the proxy surfaces it as an HTTP `Retry-After`
    header so overload backpressure is actionable, not just a 503."""

    retry_after_s: Optional[float] = None


@dataclass
class EngineConfig:
    max_batch_size: int = 8
    block_size: int = 16
    num_blocks: int = 64
    max_queue: int = 64            # waiting-queue bound (backpressure)
    max_new_tokens_default: int = 64
    prefix_sharing: bool = True    # adopt cached prompt prefixes
    policy: str = "continuous"     # "continuous" | "static"
    replica_tag: str = ""          # fleet identity (metrics/digests)
    # Paged decode (the default): read KV inside the model's step
    # through block tables, with the pool on the model's device. Requires
    # a model with `supports_paged`; falls back to the host-gather loop
    # (numpy pool, per-sequence gather) otherwise or when False.
    paged_decode: bool = True


class TokenStream:
    """Per-request token channel: the engine pushes one token per
    iteration; consumers iterate synchronously (`for tok in stream`) or
    asynchronously (`async for tok in stream`) — both see tokens as they
    are produced, so time-to-first-token decouples from completion."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._done = False
        self._error: Optional[BaseException] = None
        self._waiters: List = []   # threading.Event | (loop, aio.Event)
        self.cancelled = False
        self.finished_at: Optional[float] = None  # perf_counter stamp

    # -- producer (engine loop) ----------------------------------------
    def _push(self, token: int) -> None:
        with self._lock:
            self._tokens.append(token)
            waiters, self._waiters = self._waiters, []
        self._wake(waiters)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._done:
                return
            self._error = error
            self._done = True
            self.finished_at = time.perf_counter()
            waiters, self._waiters = self._waiters, []
        self._wake(waiters)

    @staticmethod
    def _wake(waiters) -> None:
        for w in waiters:
            if isinstance(w, tuple):
                loop, ev = w
                try:
                    loop.call_soon_threadsafe(ev.set)
                except RuntimeError:
                    pass  # consumer loop already closed
            else:
                w.set()

    # -- consumer ------------------------------------------------------
    @property
    def finished(self) -> bool:
        with self._lock:
            return self._done

    def cancel(self) -> None:
        """Ask the engine to retire this sequence at the next iteration
        boundary; already-produced tokens stay readable."""
        self.cancelled = True

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def __iter__(self):
        idx = 0
        while True:
            with self._lock:
                if idx < len(self._tokens):
                    tok = self._tokens[idx]
                    idx += 1
                elif self._done:
                    if self._error is not None:
                        raise self._error
                    return
                else:
                    ev = threading.Event()
                    self._waiters.append(ev)
                    tok = None
            if tok is None:
                ev.wait()
                continue
            yield tok

    async def __aiter__(self):
        import asyncio

        loop = asyncio.get_running_loop()
        idx = 0
        while True:
            with self._lock:
                if idx < len(self._tokens):
                    tok = self._tokens[idx]
                    idx += 1
                elif self._done:
                    if self._error is not None:
                        raise self._error
                    return
                else:
                    ev = asyncio.Event()
                    self._waiters.append((loop, ev))
                    tok = None
            if tok is None:
                await ev.wait()
                continue
            yield tok


@dataclass
class _Sequence:
    seq_id: str
    prompt: List[int]
    all_tokens: List[int]          # prompt + generated so far
    max_new_tokens: int
    priority: int                  # higher = more important
    arrival: float
    stream: TokenStream
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    preemptions: int = 0

    @property
    def generated(self) -> int:
        return len(self.all_tokens) - len(self.prompt)


class InferenceEngine:
    """Continuous-batching engine around one model + one KV cache.

    Invariant between iterations: for every running sequence, the cache
    holds KV for `all_tokens[:-1]` (the last token is the decode input
    that the NEXT step will both consume and cache)."""

    def __init__(self, model, config: Optional[EngineConfig] = None):
        self.model = model
        self.config = config or EngineConfig()
        kv_shape = tuple(getattr(model, "kv_token_shape", ()))
        self.paged = bool(self.config.paged_decode
                          and getattr(model, "supports_paged", False))
        self.cache = KVCacheManager(
            self.config.num_blocks, self.config.block_size,
            kv_shape=kv_shape,
            dtype=getattr(model, "kv_dtype", np.float32),
            # The paged step reads the pool in place: it lives on the
            # model's device.
            device_pool=self.paged,
            device=getattr(model, "device", None))
        self.prefix_index: Optional[PrefixIndex] = None
        if self.config.prefix_sharing:
            self.prefix_index = PrefixIndex(self.cache,
                                            self.config.block_size)
            self.cache.set_reclaimer(self.prefix_index.evict,
                                     self.prefix_index.evictable_blocks)
        self._waiting: deque = deque()
        self._running: List[_Sequence] = []
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ids = itertools.count()
        self.replica_tag = self.config.replica_tag or "replica-0"
        # Counters (reported through stats() and the metrics).
        self.steps = 0
        self.prefills = 0
        self.preemptions = 0
        self.tokens_generated = 0
        self.prefix_hit_tokens = 0
        self.prefix_exports = 0
        self.prefix_imports = 0
        self.prefix_import_tokens = 0
        self.finished = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.paged_steps = 0
        # Decode-step phase split (the cost paged decode removes is the
        # kv_gather slice): host gather / compiled step / cache write.
        self.kv_gather_s = 0.0
        self.model_step_s = 0.0
        self.kv_write_s = 0.0
        self._ttfts: List[float] = []
        self._pushed: Dict[str, float] = {}
        # Retirement stamps feeding the queue-drain-rate estimate behind
        # EngineOverloadedError.retry_after_s.
        self._finish_stamps: deque = deque(maxlen=64)

    # -- submission ----------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               priority: int = 0) -> TokenStream:
        """Enqueue a request; returns its TokenStream immediately.
        Raises EngineOverloadedError when the waiting queue is full and
        CacheOverflowError when the request can never fit the cache."""
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError("empty prompt")
        max_new = (self.config.max_new_tokens_default
                   if max_new_tokens is None else int(max_new_tokens))
        # Worst-case footprint must fit the cache at all, or no amount
        # of preemption ever admits it — reject at the door.
        worst = len(prompt) + max_new
        if worst > self.cache.capacity_tokens:
            raise CacheOverflowError(
                f"prompt+max_new_tokens={worst} exceeds cache capacity "
                f"{self.cache.capacity_tokens}")
        seq_id = f"seq-{next(self._ids)}"
        stream = TokenStream(seq_id)
        seq = _Sequence(seq_id=seq_id, prompt=prompt,
                        all_tokens=list(prompt), max_new_tokens=max_new,
                        priority=priority, arrival=time.monotonic(),
                        stream=stream)
        with self._lock:
            if len(self._waiting) >= self.config.max_queue:
                err = EngineOverloadedError(
                    f"waiting queue full ({self.config.max_queue})")
                err.retry_after_s = self._retry_after_locked()
                raise err
            self._waiting.append(seq)
        self._work.set()
        return stream

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def batch_occupancy(self) -> int:
        with self._lock:
            return len(self._running)

    # -- overload backpressure -----------------------------------------
    def drain_rate(self) -> float:
        """Sequences retired per second over the recent window (0.0
        until two retirements have been observed)."""
        stamps = list(self._finish_stamps)
        if len(stamps) < 2:
            return 0.0
        dt = stamps[-1] - stamps[0]
        return (len(stamps) - 1) / dt if dt > 0 else 0.0

    def retry_after_s(self) -> float:
        """How long a shed client should wait before retrying: the time
        for the current waiting queue to drain one slot at the observed
        retirement rate, clamped to [0.05, 30] so a cold engine still
        hints something sane."""
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        rate = self.drain_rate()
        depth = len(self._waiting) + 1
        if rate <= 0.0:
            return 1.0
        return min(30.0, max(0.05, depth / rate))

    # -- cross-replica prefix shipping ---------------------------------
    def export_prefix(self, tokens: Sequence[int]):
        """The cached FULL-block prefix of `tokens` as
        (chunks, kv_arrays) — the holding side of cross-replica prefix
        shipping. kv_arrays[i] is a copy of the block holding
        chunks[i]; a block evicted between the index walk and the read
        truncates the chain there (shipping is best-effort)."""
        if self.prefix_index is None:
            return [], []
        chain = self.prefix_index.export_chain(tokens)
        chunks: List = []
        kvs: List = []
        for chunk, block in chain:
            try:
                kvs.append(self.cache.read_block(block))
            except ValueError:
                break   # evicted under us: ship the intact head only
            chunks.append(chunk)
        if chunks:
            self.prefix_exports += 1
        return chunks, kvs

    def import_prefix(self, chunks, kv_blocks) -> int:
        """Adopt shipped sealed blocks into the LOCAL cache + prefix
        index by reference-semantics insert: each block is installed
        once, the index takes its usual single reference, and the next
        admission matching this prefix adopts it exactly like a
        locally-prefilled one. Chunks already indexed here keep the
        first-indexed block (the duplicate import frees immediately).
        Returns tokens now covered by the imported chain."""
        if self.prefix_index is None:
            return 0
        installed: List[int] = []
        flat: List[int] = []
        for chunk, kv in zip(chunks, kv_blocks):
            b = self.cache.install_block(kv)
            if b is None:
                break   # no capacity even after reclaim: partial adopt
            installed.append(b)
            flat.extend(int(t) for t in chunk)
        if not installed:
            return 0
        self.prefix_index.insert(flat, installed)
        for b in installed:
            # Drop the installer's reference: newly indexed blocks stay
            # held by the index; duplicates go straight back free.
            self.cache.release(b)
        adopted = len(installed) * self.config.block_size
        self.prefix_imports += 1
        self.prefix_import_tokens += adopted
        return adopted

    def prefix_digest(self, max_entries: int = 4096):
        """The radix index summary the fleet router keys on (None when
        prefix sharing is off)."""
        if self.prefix_index is None:
            return None
        return self.prefix_index.digest(max_entries)

    # -- the iteration loop --------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration. Returns False when idle (nothing
        running and nothing admittable). Never raises for per-sequence
        failures — a poisoned sequence finishes its stream with the
        error; the loop survives."""
        self._reap_cancelled()
        self._admit()
        with self._lock:
            batch = list(self._running)
        if not batch:
            self._update_gauges()
            return False
        self._ensure_capacity()
        with self._lock:
            batch = list(self._running)
        if not batch:
            self._update_gauges()
            return False
        try:
            self._decode_once(batch)
        except Exception as e:  # noqa: BLE001 — the loop must survive
            for seq in batch:
                self._retire(seq, error=e)
        self.steps += 1
        self._update_gauges()
        return True

    def _reap_cancelled(self) -> None:
        with self._lock:
            cancelled = [s for s in self._running if s.stream.cancelled]
            waiting_cancelled = [s for s in self._waiting
                                 if s.stream.cancelled]
            for s in waiting_cancelled:
                self._waiting.remove(s)
        for s in cancelled + waiting_cancelled:
            self._retire(s)

    def _admit(self) -> None:
        """Pull waiting requests into the running batch (prefill). The
        static policy only forms a batch when the previous one fully
        retired — the `@serve.batch` behavior the bench compares
        against. The in-flight check happens ONCE per pass (not per
        admitted sequence: the first prefill populates `_running`, and
        re-checking would cap static batches at size one — serial
        decoding, not static batching)."""
        with self._lock:
            if self.config.policy == "static" and self._running:
                # A batch is in flight: hold admissions until it
                # completes; the loop below then drains the queue into
                # a full batch.
                return
        while True:
            with self._lock:
                if not self._waiting:
                    return
                if len(self._running) >= self.config.max_batch_size:
                    return
                seq = self._waiting[0]
                # Admission needs the prompt cached (len-1 after the
                # invariant) plus the first decode write — i.e. blocks
                # covering len(prompt) positions, +1 for growth.
                need = len(seq.all_tokens)
                if not self.cache.can_allocate(seq.seq_id, need):
                    return
                self._waiting.popleft()
            try:
                if not self._prefill(seq):
                    return   # allocation lost after the estimate: the
                             # seq is requeued; let the batch make
                             # progress before re-trying admission
            except Exception as e:  # noqa: BLE001
                self.cache.free(seq.seq_id)
                seq.stream._finish(e)

    def _prefill(self, seq: _Sequence) -> bool:
        t0 = time.perf_counter()
        tokens = list(seq.all_tokens)
        n = len(tokens)
        hit = 0
        if self.prefix_index is not None:
            blocks, hit = self.prefix_index.match(tokens)
            if hit:
                self.cache.adopt(seq.seq_id, blocks, hit)
        # Privatize from the first position this prefill writes: a
        # partially-adopted shared block COWs here, planned into the
        # same atomic free-block arithmetic as table growth.
        ok = self.cache.allocate(seq.seq_id, n, writable_from=hit)
        if not ok:   # lost capacity since the admission check: requeue
            self.cache.free(seq.seq_id)
            with self._lock:
                self._waiting.appendleft(seq)
            return False
        if hit == n:
            # Full prefix hit: every prompt position is already cached.
            # The first generated token is ONE decode step over the
            # adopted blocks — no prefill pass at all. (The returned
            # new_kv duplicates what the shared block already holds;
            # writing it would force a pointless COW, so drop it.)
            if self.paged:
                table = self.cache.block_table(seq.seq_id)
                # Empty write list = read-only fused step; mutate_pool
                # re-binds the pool the step returns.
                logits = self.cache.mutate_pool(
                    lambda pool: self.model.decode_paged(
                        pool, [table], [tokens[-1]], [n - 1], [], [],
                        self.config.block_size))
            else:
                ctx = self.cache.gather(seq.seq_id, n - 1)
                logits, _ = self.model.decode([ctx], [tokens[-1]],
                                              [n - 1])
            logits = np.asarray(logits)[0]
        elif hit:
            if self.paged and hasattr(self.model, "prefill_paged"):
                # Paged prefill-from-offset: the adopted prefix is
                # gathered from the pool on the device — no host
                # materialization of the matched head.
                table = self.cache.block_table(seq.seq_id)
                logits, tail_kv = self.cache.with_pool(
                    lambda pool: self.model.prefill_paged(
                        tokens, pool, table, hit,
                        self.config.block_size))
            elif getattr(self.model, "supports_prefix_prefill", False):
                prefix_kv = self.cache.gather(seq.seq_id, hit)
                logits, tail_kv = self.model.prefill(tokens, prefix_kv)
            else:
                # Capacity-only sharing: the model recomputes the whole
                # prompt, but only the unmatched tail is stored.
                logits, kv = self.model.prefill(tokens)
                tail_kv = kv[hit:]
            self.cache.write_range(seq.seq_id, hit, tail_kv)
        else:
            logits, kv = self.model.prefill(tokens)
            self.cache.write_range(seq.seq_id, 0, kv)
        if self.prefix_index is not None:
            # Seal: every full prompt block becomes adoptable.
            self.prefix_index.insert(tokens,
                                     self.cache.block_table(seq.seq_id))
        tok = int(np.argmax(np.asarray(logits)))
        self.prefills += 1
        self.prefix_hit_tokens += hit
        dt = time.perf_counter() - t0
        self.prefill_s += dt
        if flight.enabled:
            # Engine steps in the flight ring; prefix_hit makes
            # shared-prefill savings visible per admission.
            flight.record("engine", "prefill", dur_us=int(dt * 1e6),
                          arg=f"tokens={n} prefix_hit={hit}",
                          t=time.monotonic() - dt)
        self._emit(seq, tok)
        if not self._maybe_finish(seq):
            with self._lock:
                self._running.append(seq)
        return True

    def _ensure_capacity(self) -> None:
        """Every running sequence needs a cache slot for the token the
        next decode step writes. Deterministic OOM: preempt the
        lowest-priority / youngest sequence and requeue it for
        recompute; never crash, never stall the rest of the batch."""
        while True:
            with self._lock:
                running = list(self._running)
            short = None
            for seq in running:
                # Next write position = len(all_tokens) - 1 + 1 slots;
                # writable_from additionally COWs that slot's block if
                # it is shared (a fully-adopted prompt ending mid-block
                # faults here on its first generated token).
                if not self.cache.allocate(
                        seq.seq_id, len(seq.all_tokens),
                        writable_from=len(seq.all_tokens) - 1):
                    short = seq
                    break
            if short is None:
                return
            victim = self._pick_victim()
            if victim is None or victim is short:
                # Nothing lower-priority to evict: preempt `short`
                # itself back to the queue; it re-admits when space
                # frees (or, if it is ALONE and still does not fit,
                # grows block-by-block as retirement frees space —
                # capacity_tokens was checked at submit).
                victim = short
            self._preempt(victim)

    def _pick_victim(self) -> Optional[_Sequence]:
        with self._lock:
            if not self._running:
                return None
            # Lowest priority first; then youngest (latest arrival) —
            # the sequence that has consumed the least service.
            return min(self._running,
                       key=lambda s: (s.priority, -s.arrival))

    def _preempt(self, seq: _Sequence) -> None:
        with self._lock:
            if seq in self._running:
                self._running.remove(seq)
            # Requeue at the FRONT: a preempted sequence re-admits
            # before fresh arrivals (no starvation).
            self._waiting.appendleft(seq)
        self.cache.free(seq.seq_id)
        seq.preemptions += 1
        self.preemptions += 1

    def _decode_once(self, batch: List[_Sequence]) -> None:
        t0 = time.perf_counter()
        lasts = [s.all_tokens[-1] for s in batch]
        poss = [len(s.all_tokens) - 1 for s in batch]
        if self.paged:
            # Paged: hand the model the POOL + block tables + write
            # slots; gather, attention, AND the new tokens' KV
            # write-back all run inside ONE model call. Host work this
            # step is table padding — the KV payload never leaves the
            # device in either direction.
            tables = [self.cache.block_table(s.seq_id) for s in batch]
            t1 = time.perf_counter()
            logits = self.cache.paged_step(
                [(s.seq_id, poss[i]) for i, s in enumerate(batch)],
                lambda pool, blocks, offs: self.model.decode_paged(
                    pool, tables, lasts, poss, blocks, offs,
                    self.config.block_size))
            t2 = time.perf_counter()
            t3 = t2   # write is fused into the model step
            self.paged_steps += 1
        else:
            kvs = [self.cache.gather(s.seq_id) for s in batch]
            t1 = time.perf_counter()
            logits, new_kv = self.model.decode(kvs, lasts, poss)
            t2 = time.perf_counter()
            for i, seq in enumerate(batch):
                self.cache.write(seq.seq_id, poss[i], new_kv[i])
            t3 = time.perf_counter()
        logits = np.asarray(logits)
        dt = t3 - t0
        self.decode_s += dt
        self.kv_gather_s += t1 - t0
        self.model_step_s += t2 - t1
        self.kv_write_s += t3 - t2
        if attribution.enabled:
            attribution.record("engine.kv_gather", t1 - t0)
            attribution.record("engine.model_step", t2 - t1)
            attribution.record("engine.kv_write", t3 - t2)
        if flight.enabled:
            now = time.monotonic()
            flight.record("engine", "decode", dur_us=int(dt * 1e6),
                          arg=len(batch), t=now - dt)
            # Phase split inside the step: the kv_gather span is what
            # the paged path removes.
            flight.record("engine", "kv_gather",
                          dur_us=int((t1 - t0) * 1e6),
                          arg=len(batch), t=now - dt)
            flight.record("engine", "model_step",
                          dur_us=int((t2 - t1) * 1e6),
                          arg=len(batch), t=now - dt + (t1 - t0))
        for i, seq in enumerate(batch):
            tok = int(np.argmax(logits[i]))
            self._emit(seq, tok)
            self._maybe_finish(seq)

    def _emit(self, seq: _Sequence, tok: int) -> None:
        seq.all_tokens.append(tok)
        if seq.first_token_at is None:
            seq.first_token_at = time.perf_counter()
            ttft = seq.first_token_at - seq.submitted_at
            self._ttfts.append(ttft)
            del self._ttfts[:-1024]
            try:
                from ray_tpu_torch.serve._private.metrics import \
                    engine_metrics

                engine_metrics()["ttft"].observe(ttft)
            except Exception:
                pass
        self.tokens_generated += 1
        seq.stream._push(tok)

    def _maybe_finish(self, seq: _Sequence) -> bool:
        eos = getattr(self.model, "eos_token", None)
        if (seq.generated >= seq.max_new_tokens
                or (eos is not None and seq.all_tokens[-1] == eos)):
            self._retire(seq)
            return True
        return False

    def _retire(self, seq: _Sequence,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            if seq in self._running:
                self._running.remove(seq)
        self.cache.free(seq.seq_id)
        self.finished += 1
        self._finish_stamps.append(time.perf_counter())
        seq.stream._finish(error)

    # -- hosting -------------------------------------------------------
    def start(self) -> None:
        """Run the loop on a daemon thread (how a Serve replica hosts
        the engine); idles on an event when there is no work."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except Exception:  # noqa: BLE001 — belt and braces
                    worked = False
                if not worked:
                    self._work.wait(timeout=0.05)
                    self._work.clear()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="inference-engine")
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        # Fail whatever is still in flight so consumers unblock.
        with self._lock:
            leftovers = list(self._running) + list(self._waiting)
            self._running.clear()
            self._waiting.clear()
        for seq in leftovers:
            self.cache.free(seq.seq_id)
            seq.stream._finish(EngineStoppedError("engine stopped"))

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until no work remains (tests / graceful shutdown)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._running and not self._waiting:
                    return True
            time.sleep(0.005)
        return False

    # -- observability -------------------------------------------------
    @property
    def cow_copies(self) -> int:
        return self.cache.cow_copies

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            running = len(self._running)
            waiting = len(self._waiting)
        ttfts = sorted(self._ttfts)
        return {
            "steps": self.steps,
            "prefills": self.prefills,
            "preemptions": self.preemptions,
            "tokens_generated": self.tokens_generated,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_exports": self.prefix_exports,
            "prefix_imports": self.prefix_imports,
            "prefix_import_tokens": self.prefix_import_tokens,
            "cow_copies": self.cache.cow_copies,
            "finished": self.finished,
            "running": running,
            "waiting": waiting,
            "cache": self.cache.stats(),
            "prefix_index": (self.prefix_index.stats()
                             if self.prefix_index is not None else None),
            "paged": self.paged,
            "paged_steps": self.paged_steps,
            "jit_bucket_evictions": getattr(
                self.model, "jit_cache_evictions", 0),
            "prefill_s": round(self.prefill_s, 6),
            "decode_s": round(self.decode_s, 6),
            "kv_gather_s": round(self.kv_gather_s, 6),
            "model_step_s": round(self.model_step_s, 6),
            "kv_write_s": round(self.kv_write_s, 6),
            "ttft_p50_ms": (round(ttfts[len(ttfts) // 2] * 1e3, 3)
                            if ttfts else None),
        }

    def _update_gauges(self) -> None:
        try:
            from ray_tpu_torch.serve._private.metrics import engine_metrics

            m = engine_metrics()
            m["batch_occupancy"].set(float(self.batch_occupancy()))
            m["cache_utilization"].set(self.cache.utilization())
            m["queue_depth"].set(float(self.queue_depth()))
            # Counters take deltas since the last push (the registry
            # instruments are cumulative; the engine's own fields are
            # the source of truth for stats()).
            for attr, key in (("preemptions", "preemptions"),
                              ("tokens_generated", "tokens"),
                              ("prefix_hit_tokens", "prefix_hit_tokens"),
                              ("cow_copies", "cow")):
                cur = getattr(self, attr)
                last = self._pushed.get(attr, 0)
                if cur > last:
                    m[key].inc(cur - last)
                    self._pushed[attr] = cur
            for attr, phase in (("prefill_s", "prefill"),
                                ("decode_s", "decode"),
                                ("kv_gather_s", "kv_gather"),
                                ("model_step_s", "model_step"),
                                ("kv_write_s", "kv_write")):
                cur = getattr(self, attr)
                last = self._pushed.get(attr, 0.0)
                if cur > last:
                    m["step_phase"].inc(cur - last,
                                        tags={"phase": phase})
                    self._pushed[attr] = cur
            m["kv_pool_bytes"].set(
                float(self.cache.pool_bytes),
                tags={"replica": self.replica_tag,
                      "residency": self.cache.pool_residency})
            if self.prefix_index is not None:
                # Per-replica radix-index state on the scrape path:
                # the fleet router's digest freshness rides this.
                pst = self.prefix_index.stats()
                tags = {"replica": self.replica_tag}
                m["prefix_nodes"].set(float(pst["nodes"]), tags=tags)
                m["prefix_sealed"].set(
                    float(self.prefix_index.held_blocks()), tags=tags)
                m["prefix_hits_state"].set(float(pst["hits"]), tags=tags)
                m["prefix_evictions_state"].set(
                    float(pst["evictions"]), tags=tags)
        except Exception:
            pass  # metrics must never fail the decode loop


class EngineStoppedError(RuntimeError):
    pass
