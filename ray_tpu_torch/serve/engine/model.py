"""Decode-step model shims for the continuous-batching engine.

The iteration scheduler drives any model through two calls:

- ``prefill(tokens, prefix_kv=None) -> (next_token_logits [V],
  kv [S-P, *kv_token_shape])`` — run the prompt once, return the logits
  that predict the first generated token plus the per-position KV
  entries to cache. When the engine adopted a shared prefix,
  ``prefix_kv`` is the gathered ``[P, *kv_token_shape]`` cache of
  positions ``[0, P)`` and the model computes (and returns) KV for the
  unmatched tail only — prefill-from-offset, the compute half of prefix
  sharing. Models advertise support with ``supports_prefix_prefill``;
  without it the engine falls back to full recompute with tail-only
  writes (capacity sharing, no compute savings);
- ``decode(kvs, last_tokens, positions) -> (logits [B, V],
  new_kv [B, *kv_token_shape])`` — one incremental step for a batch of
  sequences: ``kvs[i]`` is sequence i's cached KV gathered from the
  block manager (``[positions[i], *kv_token_shape]``), ``last_tokens[i]``
  the most recent token (not yet cached), ``positions[i]`` its position.

Paged models add ``decode_paged`` and ``prefill_paged``, which read the
KV pool through block tables themselves.

Two implementations, the ports of `ray_tpu/serve/engine/model.py`'s:

- **TinyLM** — a deterministic pure-numpy model whose next token is a
  fixed function of the *cached* KV contents, so every block-table bug
  (wrong block, stale entry, bad gather order) changes the output.
- **TransformerEngineModel** — incremental KV decoding over the
  flagship `models/transformer.py` weights in float32. Inputs are padded
  to the JAX engine's power-of-two buckets (there is no jit here; the
  padding keeps the numerics, and so the tokens, equal to the JAX
  engine's). The no-prefix prefill's causal self-attention goes through
  `ops.attention.attention`, so an eligible bucket (>= 128 tokens,
  head_dim 64 or 128) runs the flash-attention kernel on a card.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import _layer, _rmsnorm
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.rotary import (apply_rotary, rotary_freqs,
                                      rotary_rows, rotate_halves)
from ray_tpu_torch.serve.engine.kv_cache import host_array

_NEG_INF = -1e30


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class TinyLM:
    """Deterministic cache-exercising toy LM.

    KV entry per token = ``float(token)`` (shape ``(1,)``). The next
    token is ``2 + (sum(cached) + 7*last + 3*pos) % (vocab-2)`` — a pure
    function of the full token history, but computed FROM THE CACHE, so
    the engine only reproduces the oracle (`TinyLM.oracle`) if block
    allocation, writes, gathers, preemption-requeue and re-prefill are
    all correct. Token ids 0 (pad) and 1 (eos) are reserved; when
    ``eos_period`` is set, the hash landing on a multiple emits eos.
    """

    kv_token_shape: Tuple[int, ...] = (1,)
    kv_dtype = np.float32
    # A numpy model: an engine's device pool for it stays in host memory.
    device = torch.device("cpu")
    supports_prefix_prefill = True
    supports_paged = True

    def __init__(self, vocab_size: int = 32, eos_period: int = 0,
                 step_delay_s: float = 0.0,
                 prefill_token_delay_s: float = 0.0):
        if vocab_size < 4:
            raise ValueError("vocab_size must be at least 4")
        self.vocab_size = vocab_size
        self.eos_token = 1
        self.eos_period = eos_period
        # Simulated model costs: a sleep per decode call, and per
        # prefilled token (a prefix hit pays only the tail), which make
        # batching and shared-prefill savings measurable in the benches.
        self.step_delay_s = step_delay_s
        self.prefill_token_delay_s = prefill_token_delay_s
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.decode_calls = 0

    def _next(self, cached_sum: float, last: int, pos: int) -> int:
        h = int(round(cached_sum)) + 7 * int(last) + 3 * int(pos)
        if self.eos_period and h % self.eos_period == 0:
            return self.eos_token
        return 2 + h % (self.vocab_size - 2)

    def prefill(self, tokens: Sequence[int], prefix_kv=None):
        self.prefill_calls += 1
        toks = np.asarray(tokens, np.int64)
        p = 0 if prefix_kv is None else int(prefix_kv.shape[0])
        self.prefill_tokens += len(toks) - p
        if self.prefill_token_delay_s:
            time.sleep(self.prefill_token_delay_s * (len(toks) - p))
        kv = toks[p:].astype(np.float32)[:, None]      # [S-P, 1]
        # The hash reads the CACHED prefix kv values, not the token
        # ids — an adoption bug (wrong block, stale COW source) changes
        # this sequence's very first token.
        cached = float(host_array(prefix_kv).sum()) if p else 0.0
        if len(toks) - 1 > p:
            cached += float(toks[p:-1].sum())
        nxt = self._next(cached, int(toks[-1]), len(toks) - 1)
        logits = np.full((self.vocab_size,), -1e30, np.float32)
        logits[nxt] = 0.0
        return logits, kv

    def decode(self, kvs, last_tokens: Sequence[int],
               positions: Sequence[int]):
        self.decode_calls += 1
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        b = len(last_tokens)
        logits = np.full((b, self.vocab_size), -1e30, np.float32)
        new_kv = np.zeros((b,) + self.kv_token_shape, np.float32)
        for i in range(b):
            nxt = self._next(float(host_array(kvs[i]).sum()),
                             int(last_tokens[i]), int(positions[i]))
            logits[i, nxt] = 0.0
            new_kv[i, 0] = float(last_tokens[i])
        return logits, new_kv

    def _pool_gather(self, pool, table: Sequence[int], n: int,
                     block_size: int) -> np.ndarray:
        """Host gather of positions [0, n) straight from the pool via a
        block table — the toy model's paged path. What matters is that
        the BLOCK TABLE (not a pre-gathered view) drives the read, so
        table bugs still change tokens."""
        if n == 0:
            return np.zeros((0,) + self.kv_token_shape, np.float32)
        nb = (n + block_size - 1) // block_size
        idx = np.asarray(list(table)[:nb], np.int64)
        return host_array(pool)[idx].reshape(
            (-1,) + self.kv_token_shape)[:n]

    def decode_paged(self, pool, block_tables: List[Sequence[int]],
                     last_tokens: Sequence[int],
                     positions: Sequence[int],
                     write_blocks: Sequence[int],
                     write_offs: Sequence[int], block_size: int):
        """Fused paged step: read through the block tables, decode,
        write each new token's KV into its (block, off) slot, and
        return ``(logits, pool)``. `write_blocks` may be shorter than
        the batch (empty = read-only step, e.g. a full prefix hit)."""
        kvs = [self._pool_gather(pool, block_tables[i],
                                 int(positions[i]), block_size)
               for i in range(len(last_tokens))]
        logits, new_kv = self.decode(kvs, last_tokens, positions)
        k = min(len(write_blocks), len(last_tokens))
        if isinstance(pool, torch.Tensor):
            if k:
                pool[list(write_blocks[:k]), list(write_offs[:k])] = \
                    torch.as_tensor(new_kv[:k], dtype=pool.dtype,
                                    device=pool.device)
        else:
            for i in range(k):
                pool[write_blocks[i], write_offs[i]] = new_kv[i]
        return logits, pool

    def prefill_paged(self, tokens: Sequence[int], pool,
                      block_table: Sequence[int], prefix_len: int,
                      block_size: int):
        prefix_kv = (self._pool_gather(pool, block_table, prefix_len,
                                       block_size)
                     if prefix_len else None)
        return self.prefill(tokens, prefix_kv)

    def oracle(self, prompt: Sequence[int], max_new_tokens: int
               ) -> List[int]:
        """Reference generation, no cache: what the engine MUST emit."""
        toks = list(prompt)
        out: List[int] = []
        while len(out) < max_new_tokens:
            nxt = self._next(float(sum(toks[:-1])), toks[-1],
                             len(toks) - 1)
            out.append(nxt)
            if nxt == self.eos_token:
                break
            toks.append(nxt)
        return out


class TransformerEngineModel:
    """Incremental KV decoding over `models/transformer.py` weights.

    KV entry per token: ``[n_layers, 2, n_heads, head_dim]`` float32.
    Prefill runs a full causal forward (the training model's `_layer`:
    rmsnorm, fused qkv, rotary, attention, silu-gated FFN, tied
    embeddings) while collecting K/V; decode attends one query token
    against the gathered cache. Sequence lengths pad to the next power
    of two (>= 8), batches pad with masked dummy rows, as the JAX
    engine's compile buckets do. The math is float32 throughout, as the
    JAX engine's is: building the model turns TF32 off for matmuls and
    cuDNN (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`), which would otherwise round
    float32 products on a card. MoE configs are rejected.

    `device=None` means the first CUDA card; the params must live on
    the model's device.
    """

    supports_prefix_prefill = True
    supports_paged = True

    def __init__(self, params, cfg, device: DeviceLike = None):
        if cfg.is_moe:
            raise ValueError("TransformerEngineModel supports dense "
                             "configs only (num_experts == 0)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not on {self.device}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._params = params
        self._cfg = cfg
        self.vocab_size = cfg.vocab_size
        self.eos_token = 1
        self.kv_token_shape = (cfg.n_layers, 2, cfg.n_heads, cfg.head_dim)
        self.kv_dtype = np.float32
        self._cos, self._sin = rotary_freqs(cfg.head_dim, cfg.max_seq_len,
                                            cfg.rope_theta, self.device)
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.decode_calls = 0

    # -- shared math ---------------------------------------------------
    def _tensor(self, values, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.device)

    def _check_tokens(self, tokens) -> np.ndarray:
        """Token ids from outside, validated on the host: an
        out-of-range embedding row is a device-side assert on a card
        (JAX clamps it)."""
        toks = np.asarray(tokens, np.int64)
        if toks.size and (toks.min() < 0 or toks.max() >= self.vocab_size):
            raise ValueError(
                f"token ids must lie in [0, {self.vocab_size})")
        return toks

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._params["embed"][tokens].float()

    def _logits(self, x: torch.Tensor) -> np.ndarray:
        """Final norm and tied-embedding logits of rows x [..., D]."""
        x = _rmsnorm(x, self._params["ln_f"])
        return (x @ self._params["embed"].float().T).cpu().numpy()

    def _prefill_math(self, tokens: torch.Tensor, length: int):
        """Full causal prefill of `tokens` [S_pad] (zero-padded past
        `length`). Padded rows compute garbage that nothing reads: a
        causal query at row < length never attends to a key at or past
        `length`, the logits come from row length-1 and the caller
        keeps KV rows [:length]."""
        cfg = self._cfg
        x = self._embed(tokens)[None]                     # [1, S, D]

        def rope(t):
            return apply_rotary(t, self._cos, self._sin)

        def attend(q, k, v):
            return attention(q, k, v, causal=True)

        kvs = []
        for lp in self._params["layers"]:
            x, _, k, v = _layer(x, lp, cfg, rope, attend)
            kvs.append(torch.stack([k[0], v[0]], dim=1))  # [S, 2, H, hd]
        return self._logits(x[0, length - 1]), torch.stack(kvs, dim=1)

    def _prefill_cached_math(self, tail_tokens: torch.Tensor, p_len: int,
                             t_len: int, prefix: torch.Tensor):
        """Prefill-from-offset: tail queries attend over the prefix KV
        plus the tail's own keys — the prompt's matched head is never
        recomputed. `prefix` [P_pad, L, 2, H, hd] rows at or past `p_len`
        are masked out of attention, so callers may hand in zero padding
        (host path) or stale pool rows (paged gather) alike."""
        cfg = self._cfg
        t_pad, p_pad = tail_tokens.shape[0], prefix.shape[0]
        dev = self.device
        x = self._embed(tail_tokens)[None]                # [1, T, D]
        ar_t = torch.arange(t_pad, device=dev)
        tpos = p_len + ar_t                               # absolute
        pref_valid = torch.arange(p_pad, device=dev) < p_len
        causal_tt = (ar_t[:, None] >= ar_t[None, :]) & (ar_t < t_len)[None]
        scale = cfg.head_dim ** -0.5

        def rope(t):
            return apply_rotary(t, self._cos, self._sin, tpos)

        kvs = []
        for li, lp in enumerate(self._params["layers"]):
            pk = prefix[None, :, li, 0]                   # [1, P, H, hd]
            pv = prefix[None, :, li, 1]

            def attend(q, k, v, pk=pk, pv=pv):
                sc_p = torch.einsum("bqhd,bkhd->bhqk", q, pk) * scale
                sc_t = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                sc_p = sc_p.masked_fill(~pref_valid, _NEG_INF)
                sc_t = sc_t.masked_fill(~causal_tt, _NEG_INF)
                probs = torch.softmax(torch.cat([sc_p, sc_t], dim=-1),
                                      dim=-1)
                return (torch.einsum("bhqk,bkhd->bqhd",
                                     probs[..., :p_pad], pv)
                        + torch.einsum("bhqk,bkhd->bqhd",
                                       probs[..., p_pad:], v))

            x, _, k, v = _layer(x, lp, cfg, rope, attend)
            kvs.append(torch.stack([k[0], v[0]], dim=1))  # [T, 2, H, hd]
        return self._logits(x[0, t_len - 1]), torch.stack(kvs, dim=1)

    def _decode_math(self, tokens: torch.Tensor, positions: torch.Tensor,
                     cache: torch.Tensor):
        """One incremental step: tokens [B], positions [B], cache
        [B, S_pad, L, 2, H, hd]. Cache rows past each sequence's
        `position` may hold ANYTHING — zero padding on the host-gather
        path, stale reused-block data on the paged path — so the new
        token's K/V OVERWRITES its slot (`where`, not an add) and
        `attend` masks everything past `position`."""
        cfg = self._cfg
        s_pad = cache.shape[1]
        ar_s = torch.arange(s_pad, device=self.device)
        slot = (ar_s[None, :] == positions[:, None])[:, :, None, None]
        attend_mask = ar_s[None, :] <= positions[:, None]     # [B, S]
        c, s = rotary_rows(self._cos, self._sin, positions)   # [B, D/2]
        c, s = c[:, None, None, :], s[:, None, None, :]
        scale = cfg.head_dim ** -0.5
        x = self._embed(tokens)[:, None]                      # [B, 1, D]

        def rope(t):
            return rotate_halves(t, c, s)

        new_kv = []
        for li, lp in enumerate(self._params["layers"]):
            kv_l = cache[:, :, li]                        # [B, S, 2, H, hd]

            def attend(q, k, v, kv_l=kv_l):
                keys = torch.where(slot, k, kv_l[:, :, 0])
                vals = torch.where(slot, v, kv_l[:, :, 1])
                scores = torch.einsum("bqhd,bshd->bhqs", q, keys) * scale
                scores = scores.masked_fill(
                    ~attend_mask[:, None, None, :], _NEG_INF)
                probs = torch.softmax(scores, dim=-1)
                return torch.einsum("bhqs,bshd->bqhd", probs, vals)

            x, _, k, v = _layer(x, lp, cfg, rope, attend)
            new_kv.append(torch.stack([k[:, 0], v[:, 0]], dim=1))
        # new_kv: L x [B, 2, H, hd] -> [B, L, 2, H, hd]
        return self._logits(x[:, 0]), torch.stack(new_kv, dim=1)

    # -- engine interface ----------------------------------------------
    def prefill(self, tokens: Sequence[int], prefix_kv=None):
        """Returns (logits [V] numpy, KV [n - p, *kv_token_shape] as a
        float32 tensor on the model's device)."""
        toks = self._check_tokens(tokens)
        self.prefill_calls += 1
        n = len(toks)
        p = 0 if prefix_kv is None else int(prefix_kv.shape[0])
        self.prefill_tokens += n - p
        if p == 0:
            padded = np.zeros((_next_pow2(max(n, 8)),), np.int64)
            padded[:n] = toks
            logits, kv = self._prefill_math(self._tensor(padded), n)
            return logits, kv[:n]
        t = n - p
        tail = np.zeros((_next_pow2(max(t, 8)),), np.int64)
        tail[:t] = toks[p:]
        cache = torch.zeros((_next_pow2(max(p, 8)),) + self.kv_token_shape,
                            dtype=torch.float32, device=self.device)
        cache[:p] = self._tensor(prefix_kv, torch.float32)
        logits, kv = self._prefill_cached_math(self._tensor(tail), p, t,
                                               cache)
        return logits, kv[:t]

    def decode(self, kvs, last_tokens: Sequence[int],
               positions: Sequence[int]):
        """Returns (logits [B, V] numpy, new KV [B, *kv_token_shape] as
        a tensor on the model's device)."""
        toks = self._check_tokens(last_tokens)
        self.decode_calls += 1
        b = len(toks)
        # Bucket from the ACTUAL batch — never clamp below it.
        b_pad = _next_pow2(max(b, 1))
        s_pad = _next_pow2(max(max(int(p) for p in positions) + 1, 8))
        cache = torch.zeros((b_pad, s_pad) + self.kv_token_shape,
                            dtype=torch.float32, device=self.device)
        tok_pad = np.zeros((b_pad,), np.int64)
        pos_pad = np.zeros((b_pad,), np.int64)
        for i in range(b):
            n = int(positions[i])
            if n:
                cache[i, :n] = self._tensor(kvs[i], torch.float32)
            tok_pad[i] = toks[i]
            pos_pad[i] = n
        logits, new_kv = self._decode_math(
            self._tensor(tok_pad), self._tensor(pos_pad), cache)
        return logits[:b], new_kv[:b]

    def decode_paged(self, pool, block_tables: List[Sequence[int]],
                     last_tokens: Sequence[int],
                     positions: Sequence[int],
                     write_blocks: Sequence[int],
                     write_offs: Sequence[int], block_size: int):
        """One incremental step reading KV straight out of the pool
        through the padded block tables (`index_select` on the device)
        and writing the new tokens' KV back in place. Host work is O(B)
        table/token padding; the KV payload never touches the host.
        Returns host logits plus the pool (the same tensor; the caller
        re-binds it, e.g. via `KVCacheManager.paged_step`).
        `write_blocks` may be shorter than the batch; only its rows are
        written, so an empty write list is a read-only step."""
        toks = self._check_tokens(last_tokens)
        b = len(toks)
        if isinstance(pool, np.ndarray):
            # Host-resident pool with paged tables: gather on host
            # (still table-driven), step, write rows back in place.
            kvs = []
            for i in range(b):
                n = int(positions[i])
                idx = np.asarray(list(block_tables[i])[:n // block_size + 1],
                                 np.int64)
                kvs.append(pool[idx].reshape(
                    (-1,) + self.kv_token_shape)[:n])
            logits, new_kv = self.decode(kvs, last_tokens, positions)
            for i in range(min(len(write_blocks), b)):
                pool[write_blocks[i], write_offs[i]] = host_array(new_kv[i])
            return logits, pool
        self.decode_calls += 1
        b_pad = _next_pow2(max(b, 1))
        nb = max(int(p) // block_size + 1 for p in positions)
        nb_pad = _next_pow2(max(nb, 1))
        # Rows past the batch and blocks past a row's coverage gather
        # block 0; `attend`/`slot` in the core mask the garbage.
        tables = np.zeros((b_pad, nb_pad), np.int64)
        tok_pad = np.zeros((b_pad,), np.int64)
        pos_pad = np.zeros((b_pad,), np.int64)
        for i in range(b):
            row = np.asarray(list(block_tables[i])[:nb_pad], np.int64)
            tables[i, :row.shape[0]] = row
            tok_pad[i] = toks[i]
            pos_pad[i] = int(positions[i])
        cache = pool.index_select(0, self._tensor(tables.reshape(-1)))
        cache = cache.reshape(
            (b_pad, nb_pad * block_size) + self.kv_token_shape).float()
        logits, new_kv = self._decode_math(
            self._tensor(tok_pad), self._tensor(pos_pad), cache)
        k = min(len(write_blocks), b)
        if k:
            pool.index_put_(
                (self._tensor(list(write_blocks[:k])),
                 self._tensor(list(write_offs[:k]))),
                new_kv[:k].to(pool.dtype))
        return logits[:b], pool

    def prefill_paged(self, tokens: Sequence[int], pool,
                      block_table: Sequence[int], prefix_len: int,
                      block_size: int):
        """Prefill-from-offset with the adopted prefix gathered from the
        pool through the block table on the device. Returns host logits
        plus the tail KV [tail, *kv_token_shape] as a device tensor for
        `write_range`."""
        toks = self._check_tokens(tokens)
        self.prefill_calls += 1
        n = len(toks)
        p = int(prefix_len)
        t = n - p
        self.prefill_tokens += t
        tail = np.zeros((_next_pow2(max(t, 8)),), np.int64)
        tail[:t] = toks[p:]
        nbp = (p + block_size - 1) // block_size
        nbp_pad = _next_pow2(max(nbp, 1))
        # Zero-padded table: block 0's rows are masked by `pref_valid`.
        table = np.zeros((nbp_pad,), np.int64)
        table[:nbp] = np.asarray(list(block_table)[:nbp], np.int64)
        if isinstance(pool, np.ndarray):
            prefix = self._tensor(pool[table], torch.float32)
        else:
            prefix = pool.index_select(0, self._tensor(table)).float()
        prefix = prefix.reshape((nbp_pad * block_size,)
                                + self.kv_token_shape)
        logits, kv = self._prefill_cached_math(self._tensor(tail), p, t,
                                               prefix)
        return logits, kv[:t]
