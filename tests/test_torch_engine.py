"""The port's serving engine (`ray_tpu_torch.serve.engine`) against the JAX
package's engine on the same weights and the same requests.

Each `TransformerEngineModel` path (prefill, prefill from a cached prefix,
host decode, paged decode, paged prefill) is held against the JAX model's
logits and KV; whole engines must emit the JAX engine's greedy tokens token
for token, paged and host, with prefix sharing and preemption. The port's
`TinyLM` engine is held against `TinyLM.oracle`. All on the CPU, float32.
"""

import importlib
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
import ray_tpu.serve.engine as jax_engine
import ray_tpu_torch.serve.engine as torch_engine
from ray_tpu_torch.core import attribution, flight
from ray_tpu_torch.models import TransformerConfig, params_from_jax
from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                        KVCacheManager, TinyLM,
                                        TransformerEngineModel)

torch_attention = importlib.import_module("ray_tpu_torch.ops.attention")

# float32 on both sides; the frameworks sum in different orders.
ATOL = 1e-4

FLASH = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, d_ff=128,
             max_seq_len=256)
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128)
# Two heads of 256: prefills in buckets of 128 and 256 take the flash path.
WIDE = dict(vocab_size=64, d_model=512, n_layers=2, n_heads=2, d_ff=128,
            max_seq_len=256)
KV = (2, 3)          # toy per-token KV shape for manager-level tests


def _models(widths):
    jcfg = JaxConfig(dtype=jnp.float32, **widths)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = TransformerConfig(dtype=torch.float32, **widths)
    return (jax_engine.TransformerEngineModel(jparams, jcfg),
            TransformerEngineModel(params, cfg, device="cpu"))


@pytest.fixture(scope="module")
def flash_models():
    return _models(FLASH)


@pytest.fixture(scope="module")
def tiny_models():
    return _models(TINY)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)


def _prompt(seed, n, vocab=64):
    return [int(t) for t in
            np.random.default_rng(seed).integers(2, vocab, n)]


# ---------------------------------------------------------------------------
# TransformerEngineModel, path by path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which,n", [("flash", 130), ("tiny", 5)])
def test_prefill_matches_jax(which, n, flash_models, tiny_models,
                             monkeypatch):
    """No-prefix prefill: 130 tokens pad to a 256 bucket, which takes the
    flash path (once per layer); 5 tokens stay on plain attention."""
    jm, tm = flash_models if which == "flash" else tiny_models
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    prompt = _prompt(1, n)
    j_logits, j_kv = jm.prefill(prompt)
    logits, kv = tm.prefill(prompt)
    assert tuple(kv.shape) == (n,) + tm.kv_token_shape
    assert len(calls) == (2 if which == "flash" else 0)
    _close(logits, j_logits)
    _close(kv, j_kv)


@pytest.mark.parametrize("p", [64, 129])
def test_prefill_from_prefix_matches_jax(p, flash_models):
    jm, tm = flash_models
    prompt = _prompt(2, 140)
    _, j_full_kv = jm.prefill(prompt)
    prefix = np.asarray(j_full_kv)[:p]
    j_logits, j_tail = jm.prefill(prompt, prefix)
    logits, tail = tm.prefill(prompt, prefix)
    assert tuple(tail.shape) == (140 - p,) + tm.kv_token_shape
    _close(logits, j_logits)
    _close(tail, j_tail)


def test_decode_matches_jax(tiny_models):
    jm, tm = tiny_models
    kvs, lasts, poss = [], [], []
    for seed, n in ((3, 9), (4, 17), (5, 2)):
        prompt = _prompt(seed, n)
        _, kv = jm.prefill(prompt[:-1])
        kvs.append(np.asarray(kv))
        lasts.append(prompt[-1])
        poss.append(n - 1)
    j_logits, j_new = jm.decode(kvs, lasts, poss)
    logits, new = tm.decode(kvs, lasts, poss)
    assert logits.shape == (3, 64)
    _close(logits, j_logits)
    _close(new, j_new)


def _pool_fixture(tm, seed=6, num_blocks=12, bs=4):
    """A pool of stale random rows and two sequences' tables over it."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(
        (num_blocks, bs) + tm.kv_token_shape).astype(np.float32)
    tables = [[7, 2, 9, 4], [3, 11]]
    return pool, tables


def test_decode_paged_matches_jax(tiny_models):
    """Gather through padded tables over a pool full of stale rows, then
    write each new token's KV at its slot; rows past the write list are
    left alone (JAX drops them, the port never writes them)."""
    jm, tm = tiny_models
    pool, tables = _pool_fixture(tm)
    lasts, poss = [5, 9], [13, 6]
    wblocks, woffs = [4], [1]          # only the first row writes
    j_logits, j_pool = jm.decode_paged(
        jnp.asarray(pool), tables, lasts, poss, wblocks, woffs, 4)
    t_pool = torch.from_numpy(pool.copy())
    logits, out = tm.decode_paged(t_pool, tables, lasts, poss, wblocks,
                                  woffs, 4)
    assert out is t_pool               # written in place
    _close(logits, j_logits)
    _close(out, j_pool)
    assert not np.array_equal(out.numpy()[4, 1], pool[4, 1])
    np.testing.assert_array_equal(out.numpy()[11], pool[11])
    # A host (numpy) pool takes the host-gather path to the same result.
    h_pool = pool.copy()
    h_logits, _ = tm.decode_paged(h_pool, tables, lasts, poss, wblocks,
                                  woffs, 4)
    _close(h_logits, j_logits)
    _close(h_pool, j_pool)


def test_prefill_paged_matches_jax(flash_models):
    jm, tm = flash_models
    prompt = _prompt(7, 150)
    _, j_kv = jm.prefill(prompt)
    bs, p = 16, 70
    rng = np.random.default_rng(8)
    pool = rng.standard_normal((12, bs) + tm.kv_token_shape).astype(
        np.float32)
    table = [5, 0, 9, 2, 7]               # covers the 70 prefix tokens
    flat = np.asarray(j_kv)[:p]
    for i in range(p):
        pool[table[i // bs], i % bs] = flat[i]
    j_logits, j_tail = jm.prefill_paged(prompt, jnp.asarray(pool), table,
                                        p, bs)
    logits, tail = tm.prefill_paged(prompt, torch.from_numpy(pool), table,
                                    p, bs)
    _close(logits, j_logits)
    _close(tail, j_tail)


def test_engine_model_rejects_out_of_range_tokens(tiny_models):
    _, tm = tiny_models
    with pytest.raises(ValueError, match="token ids"):
        tm.prefill([3, 64])


def test_engine_model_needs_a_card_or_an_explicit_cpu(tiny_models,
                                                      monkeypatch):
    _, tm = tiny_models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerEngineModel(tm._params, tm._cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCacheManager(4, 4, KV, device_pool=True)


# ---------------------------------------------------------------------------
# whole engines: the port against the JAX engine, token for token
# ---------------------------------------------------------------------------
def _drive(eng):
    while eng.step():
        pass


def _requests():
    """Four requests, three sharing a 16-token prefix (two full blocks of
    8) — the third and fourth adopt it — with lengths that force
    preemption in an 8-block cache."""
    shared = _prompt(10, 16)
    return [shared + _prompt(11, 5), _prompt(20, 14),
            shared + _prompt(13, 3), shared + _prompt(15, 9)]


def _run(eng_mod, model, paged):
    eng = eng_mod.InferenceEngine(model, eng_mod.EngineConfig(
        max_batch_size=3, block_size=8, num_blocks=8, paged_decode=paged))
    streams = [eng.submit(p, 10) for p in _requests()]
    _drive(eng)
    return [s.tokens_so_far() for s in streams], eng


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax_engine(paged, tiny_models):
    jm, tm = tiny_models
    want, j_eng = _run(jax_engine, jm, paged)
    got, eng = _run(torch_engine, tm, paged)
    assert got == want
    assert all(len(t) == 10 for t in got)
    st, j_st = eng.stats(), j_eng.stats()
    assert st["preemptions"] >= 1 and st["prefix_hit_tokens"] > 0
    for key in ("preemptions", "prefix_hit_tokens", "tokens_generated",
                "finished", "cow_copies"):
        assert st[key] == j_st[key], key
    assert st.keys() == j_st.keys()
    assert st["cache"].keys() == j_st["cache"].keys()
    assert st["cache"]["pool_residency"] == ("device" if paged else "host")
    if paged:
        assert st["cache"]["host_gathers"] == 0 and st["paged_steps"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_engine_at_head_dim_256_matches_jax_engine(paged, monkeypatch):
    """Heads of 256 through whole engines: prompts of 100 and 130 tokens
    (buckets of 128 and 256, flash-eligible at head_dim 256) and a third
    sharing the first's 96-token prefix, 6 new tokens each. The port's
    tokens are the JAX engine's, token for token, and each no-prefix
    prefill runs K1 (its plain version here) once a layer."""
    jm, tm = _models(WIDE)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    first = _prompt(30, 100)
    prompts = [first, _prompt(31, 130), first[:96] + _prompt(32, 20)]

    def run(eng_mod, model):
        eng = eng_mod.InferenceEngine(model, eng_mod.EngineConfig(
            max_batch_size=3, block_size=16, num_blocks=40,
            paged_decode=paged))
        streams = [eng.submit(p, 6) for p in prompts]
        _drive(eng)
        return [s.tokens_so_far() for s in streams], eng

    want, _ = run(jax_engine, jm)
    got, eng = run(torch_engine, tm)
    assert got == want and all(len(t) == 6 for t in got)
    assert eng.stats()["prefix_hit_tokens"] > 0
    assert set(calls) == {(1, 128, 2, 256), (1, 256, 2, 256)}
    assert len(calls) == WIDE["n_layers"] * (
        eng.stats()["prefills"] - (eng.stats()["prefix_hit_tokens"] > 0))


@pytest.mark.parametrize("head_dim", [384, 512])
def test_engine_at_head_dims_above_256_matches_jax_engine(head_dim,
                                                          monkeypatch):
    """One head of 384 or 512 (the D-slice kernels on the card) through
    whole paged engines, on the prompts of the head-dim-256 case: the
    port's tokens are the JAX engine's, and each no-prefix prefill runs K1
    (its plain version here) once a layer."""
    widths = dict(WIDE, d_model=head_dim, n_heads=1)
    jm, tm = _models(widths)
    assert tm.kv_token_shape[-1] == head_dim
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    first = _prompt(33, 100)
    prompts = [first, _prompt(34, 130), first[:96] + _prompt(35, 20)]

    def run(eng_mod, model):
        eng = eng_mod.InferenceEngine(model, eng_mod.EngineConfig(
            max_batch_size=3, block_size=16, num_blocks=40,
            paged_decode=True))
        streams = [eng.submit(p, 6) for p in prompts]
        _drive(eng)
        return [s.tokens_so_far() for s in streams], eng

    want, _ = run(jax_engine, jm)
    got, eng = run(torch_engine, tm)
    # A stream ends at 6 tokens or at the end-of-sequence token, as JAX's.
    assert got == want
    assert all(len(t) == 6 or t[-1] == tm.eos_token for t in got)
    assert eng.stats()["prefix_hit_tokens"] > 0
    assert set(calls) == {(1, 128, 1, head_dim), (1, 256, 1, head_dim)}
    assert len(calls) == widths["n_layers"] * (
        eng.stats()["prefills"] - (eng.stats()["prefix_hit_tokens"] > 0))


def test_engine_on_a_background_thread(tiny_models):
    """start() runs the loop on a thread; the model and its pool share the
    model's device, and streams deliver every token."""
    _, tm = tiny_models
    eng = InferenceEngine(tm, EngineConfig(max_batch_size=2, block_size=8,
                                           num_blocks=16, paged_decode=True))
    assert eng.cache._buffer.device == tm.device
    eng.start()
    try:
        streams = [eng.submit(p, 4) for p in _requests()[:2]]
        assert [len(list(s)) for s in streams] == [4, 4]
    finally:
        eng.stop()
    assert eng.stats()["finished"] == 2


def test_prefix_shipping_matches_jax_engine(tiny_models):
    """export_prefix on one engine, import_prefix on a fresh one: the
    shipped chunks, KV blocks and digest match the JAX engine's, and the
    importer adopts the prefix and emits the JAX engine's tokens."""
    prompt = _requests()[0]

    def ship(eng_mod, model):
        cfg = eng_mod.EngineConfig(block_size=8, num_blocks=8,
                                   paged_decode=True)
        src = eng_mod.InferenceEngine(model, cfg)
        src.submit(prompt, 4)
        _drive(src)
        chunks, kvs = src.export_prefix(prompt)
        dst = eng_mod.InferenceEngine(model, cfg)
        adopted = dst.import_prefix(chunks, kvs)
        stream = dst.submit(prompt, 4)
        _drive(dst)
        return (chunks, kvs, adopted, src.prefix_digest(),
                stream.tokens_so_far(), dst.stats())

    jm, tm = tiny_models
    want, got = ship(jax_engine, jm), ship(torch_engine, tm)
    chunks, kvs, adopted, digest, tokens, st = got
    assert [list(c) for c in chunks] == [list(c) for c in want[0]]
    assert len(kvs) == len(want[1]) == 2
    for k, wk in zip(kvs, want[1]):
        _close(k, wk)
    assert adopted == want[2] == 16
    assert digest == want[3]
    assert tokens == want[4]
    assert st["prefix_imports"] == 1 and st["prefix_hit_tokens"] == 16


# ---------------------------------------------------------------------------
# TinyLM engine against its oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
def test_tinylm_engine_matches_oracle(paged):
    model = TinyLM(vocab_size=32, eos_period=13)
    eng = InferenceEngine(model, EngineConfig(
        max_batch_size=3, block_size=4, num_blocks=9, paged_decode=paged))
    prompts = [[5, 6, 7, 8, 9, 10, 11], [5, 6, 7, 8, 9, 3], [2, 3],
               [5, 6, 7, 8, 9, 10, 11, 12, 13], [4] * 11]
    streams = [eng.submit(p, 12) for p in prompts]
    _drive(eng)
    for p, s in zip(prompts, streams):
        assert s.tokens_so_far() == model.oracle(p, 12)
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["prefix_hit_tokens"] > 0


# ---------------------------------------------------------------------------
# KV cache manager: the torch device pool against the numpy pool
# ---------------------------------------------------------------------------
def test_device_pool_write_gather_matches_numpy():
    host = KVCacheManager(num_blocks=8, block_size=4, kv_shape=KV)
    dev = KVCacheManager(num_blocks=8, block_size=4, kv_shape=KV,
                         device_pool=True, device="cpu")
    assert dev.pool_residency == "device"
    vals = np.arange(11 * 6, dtype=np.float32).reshape(11, *KV)
    for mgr in (host, dev):
        assert mgr.allocate("s", 11)
        mgr.write_range("s", 0, vals[:3])
        mgr.write_range("s", 3, torch.from_numpy(vals[3:10]))
        mgr.write("s", 10, vals[10])
    np.testing.assert_array_equal(_np(dev.gather("s")), host.gather("s"))
    np.testing.assert_array_equal(_np(dev.gather("s", 5)), vals[:5])
    assert dev.pool_updates >= 3 and dev.host_gathers == 2
    assert dev.pool_bytes == host.pool_bytes == 8 * 4 * 6 * 4


@pytest.mark.parametrize("device_pool", [False, True])
def test_write_step_skips_padding_rows_and_cows(device_pool):
    mgr = KVCacheManager(num_blocks=8, block_size=4, kv_shape=KV,
                         device_pool=device_pool, device="cpu")
    assert mgr.allocate("a", 3) and mgr.allocate("b", 6)
    mgr.write_range("a", 0, np.zeros((2,) + KV, np.float32))
    mgr.write_range("b", 0, np.zeros((6,) + KV, np.float32))
    shared = mgr.block_table("b")[1]
    mgr.retain(shared)                    # a second holder: COW on write
    batch = np.zeros((4,) + KV, np.float32)
    batch[0], batch[1], batch[2:] = 11.0, 22.0, 99.0
    mgr.write_step([("a", 2), ("b", 5)], batch)
    assert mgr.cow_copies == 1 and mgr.block_table("b")[1] != shared
    np.testing.assert_array_equal(_np(mgr.gather("a"))[2], batch[0])
    np.testing.assert_array_equal(_np(mgr.gather("b"))[5], batch[1])
    for blk in range(8):
        assert not np.any(_np(mgr._buffer[blk]) == 99.0)


def test_device_pool_ship_block_roundtrip():
    src = KVCacheManager(num_blocks=4, block_size=2, kv_shape=KV,
                         device_pool=True, device="cpu")
    assert src.allocate("s", 2)
    vals = np.arange(12, dtype=np.float32).reshape(2, *KV)
    src.write_range("s", 0, vals)
    frame = src.read_block(src.block_table("s")[0])
    assert isinstance(frame, np.ndarray)
    np.testing.assert_array_equal(frame, vals)
    dst = KVCacheManager(num_blocks=4, block_size=2, kv_shape=KV,
                         device_pool=True, device="cpu",
                         dtype=torch.bfloat16)
    b = dst.install_block(frame)
    np.testing.assert_array_equal(dst.read_block(b).astype(np.float32),
                                  vals)
    with pytest.raises(ValueError, match="expects shape"):
        dst.install_block(frame[:1])
    assert dst.stats()["pool_residency"] == "device"
    assert dst.pool_bytes == 4 * 2 * 6 * 2


# ---------------------------------------------------------------------------
# instrumentation: the JAX engine's span names
# ---------------------------------------------------------------------------
def test_engine_records_flight_and_attribution_spans(monkeypatch):
    monkeypatch.setattr(attribution, "enabled", True)
    monkeypatch.setattr(flight, "enabled", True)
    model = TinyLM()
    eng = InferenceEngine(model, EngineConfig(block_size=4, num_blocks=8))
    eng.submit([5, 6, 7, 8, 9], 3)
    eng.submit([5, 6, 7, 8, 2], 3)        # adopts the first block
    _drive(eng)
    labels = {(e[2], e[3]) for e in flight.events()}
    assert {("engine", "prefill"), ("engine", "decode"),
            ("engine", "kv_gather"), ("engine", "model_step")} <= labels
    args = [e[5] for e in flight.events() if e[3] == "prefill"]
    assert "tokens=5 prefix_hit=4" in args
    snap = attribution.snapshot()
    for label in ("engine.kv_gather", "engine.model_step",
                  "engine.kv_write"):
        assert snap[label]["count"] >= 2
    attribution.count("engine.test_count", 3)
    assert attribution.snapshot()["engine.test_count"]["count"] == 3


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to report without a card or away from the checkout
# ---------------------------------------------------------------------------
def _load_smoke(path):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    smoke = _load_smoke(Path(__file__).resolve().parents[1] / "chip_smoke.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_chip_smoke_fails_away_from_the_checkout(tmp_path, monkeypatch,
                                                 capsys):
    copy = tmp_path / "chip_smoke.py"
    shutil.copy(Path(__file__).resolve().parents[1] / "chip_smoke.py", copy)
    smoke = _load_smoke(copy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "not this checkout" in out.err
