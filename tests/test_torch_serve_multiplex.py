"""Model multiplexing on the port (`ray_tpu_torch.serve.multiplex` and the
replica's hooks) against the JAX package's.

- `_ModelMultiplexWrapper`, the port's and the reference's, driven by one
  seeded sequence of requests (held and released loans, bursts of
  concurrent loads of one id, loads outside any request) on one event
  loop each: the same load lists, LRU order and parked evictions after
  every step, and each model dropped (`weakref.finalize`) at the same
  step, with the cycle collector off.
- The three multiplex cases of `tests/test_serve_multiplex_grpc.py`
  (LRU loading, the missing-id error, model affinity), on the port's
  in-process runtime and on its cluster (replica processes).
- A multiplexed deployment of the small transformer in a replica
  process streams, for each model id, the JAX engine's tokens on the
  same parameters (`params_from_jax`), with at most two engines resident
  for three ids.
"""

import asyncio
import gc
import os
import random
import sys
import time
import weakref

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
import torch_multiplex_helpers as mux  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu.serve.multiplex as ref_multiplex  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.serve.multiplex as port_multiplex  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402

pytestmark = pytest.mark.unit


# ---------------------------------------------------------------------------
# The LRU, step by step, against the reference's
# ---------------------------------------------------------------------------
IDS = ["m0", "m1", "m2", "m3", "m4"]
STEPS = 60


def seeded_ops(seed: int):
    """("req", id) opens a request that loads `id` and holds its loan;
    ("burst", id, k) opens k at once; ("release", i) ends the i-th
    oldest open request; ("direct", id) loads outside any request."""
    rng = random.Random(seed)
    ops, open_ = [], 0
    for _ in range(STEPS):
        r = rng.random()
        if open_ and r < 0.35:
            ops.append(("release", rng.randrange(open_)))
            open_ -= 1
        elif r < 0.55:
            k = rng.randint(2, 4)
            ops.append(("burst", rng.choice(IDS), k))
            open_ += k
        elif r < 0.65:
            ops.append(("direct", rng.choice(IDS)))
        else:
            ops.append(("req", rng.choice(IDS)))
            open_ += 1
    ops += [("release", 0)] * open_
    return ops


class Model:
    def __init__(self, model_id: str):
        self.model_id = model_id


def drive(multiplex, ops, max_models: int):
    """Run `ops` through `multiplex`'s wrapper on one loop; returns the
    state after each step: (loads, LRU order, parked evictions, drops)."""
    loads, drops, states = [], [], []
    step = [0]

    async def load_fn(owner, model_id):
        loads.append(model_id)
        await asyncio.sleep(0)     # a burst's other requests arrive here
        model = Model(model_id)
        weakref.finalize(model, lambda mid=model_id, n=len(loads):
                         drops.append((mid, n, step[0])))
        return model

    wrapper = multiplex._ModelMultiplexWrapper(load_fn, object(),
                                               max_models)

    async def request(model_id, loaded, hold):
        scope = multiplex._begin_request_loans()
        try:
            model = await wrapper.load(model_id)
            assert model.model_id == model_id
            del model
            loaded.set()
            await hold.wait()
        finally:
            multiplex._end_request_loans(scope)

    async def main():
        open_ = []          # (task, hold)
        for i, op in enumerate(ops):
            step[0] = i
            if op[0] in ("req", "burst"):
                k = 1 if op[0] == "req" else op[2]
                started = []
                for _ in range(k):
                    loaded, hold = asyncio.Event(), asyncio.Event()
                    task = asyncio.create_task(request(op[1], loaded, hold))
                    started.append(loaded)
                    open_.append((task, hold))
                for loaded in started:
                    await loaded.wait()
            elif op[0] == "release":
                task, hold = open_.pop(op[1])
                hold.set()
                await task
            else:
                model = await wrapper.load(op[1])
                assert model.model_id == op[1]
                del model
            for _ in range(5):
                await asyncio.sleep(0)
            states.append((list(loads), wrapper.model_ids,
                           sorted(wrapper._pending_evict),
                           sorted(drops)))
        assert not open_

    enabled = gc.isenabled()
    gc.disable()
    try:
        asyncio.run(main())
    finally:
        if enabled:
            gc.enable()
    return states


@pytest.mark.parametrize("max_models", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_lru_steps_equal_reference(seed, max_models):
    ops = seeded_ops(seed)
    port = drive(port_multiplex, ops, max_models)
    ref = drive(ref_multiplex, ops, max_models)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, (i, ops[i], p, r)
    assert len(port) == len(ref) == len(ops)
    loads, resident, parked, drops = port[-1]
    # Everything loaded and not resident has been dropped, nothing is
    # left parked once every request ended.
    assert parked == [] and len(drops) == len(loads) - len(resident)
    assert any(op[0] == "burst" for op in ops)


def test_a_burst_shares_one_load_and_a_loaned_model_waits():
    """The two guarantees alone: four concurrent cold requests give one
    load; an evicted model that a request holds is dropped at the
    request's end, not at the eviction."""
    ops = [("burst", "a", 4), ("req", "b"), ("req", "c")] + \
        [("release", 0)] * 6
    states = drive(port_multiplex, ops, 2)
    assert states[0][0] == ["a"]
    # "c" evicted "a" while the burst still held it: parked, not dropped.
    assert states[2][1:3] == (["b", "c"], ["a"])
    assert states[2][3] == []
    # Dropped when the last of the four borrowers let go (step 6).
    assert states[5][3] == [] and states[6][3] == [("a", 1, 6)]
    assert states == drive(ref_multiplex, ops, 2)


def test_loader_is_shared_across_event_loops():
    """The port's streaming path runs each request on a loop of its own
    thread: a burst of cold loads from four threads still shares one
    load, and every caller gets the one model."""
    import threading

    loads = []
    gate = threading.Event()

    async def load_fn(owner, model_id):
        loads.append(model_id)
        await asyncio.to_thread(gate.wait, 10)
        return Model(model_id)

    wrapper = port_multiplex._ModelMultiplexWrapper(load_fn, object(), 2)
    got = []

    def caller():
        got.append(asyncio.run(wrapper.load("x")))

    threads = [threading.Thread(target=caller) for _ in range(4)]
    for t in threads:
        t.start()
    while not wrapper._loading:
        time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(10)
    assert loads == ["x"] and len(got) == 4
    assert all(m is got[0] for m in got)


def test_loader_under_thread_stress():
    """Sixteen threads (more than this host's cores), each on a loop of its
    own, run requests for random ids through one LRU of two with the
    interpreter switching threads every microsecond: every request gets
    its own id's model, at most two are ever resident, and when all end
    nothing is left loaned, parked or loading, and every evicted model
    has been dropped."""
    import threading

    loads, live = [], set()
    lock = threading.Lock()

    class Tracked(Model):
        def __del__(self):
            with lock:
                live.discard(id(self))

    async def load_fn(owner, model_id):
        await asyncio.sleep(0.001)
        model = Tracked(model_id)
        with lock:
            loads.append(model_id)
            live.add(id(model))
        return model

    wrapper = port_multiplex._ModelMultiplexWrapper(load_fn, object(), 2)
    errors, peak = [], [0]

    def worker(seed):
        rng = random.Random(seed)

        async def one():
            scope = port_multiplex._begin_request_loans()
            try:
                mid = rng.choice(IDS[:4])
                model = await wrapper.load(mid)
                if model.model_id != mid:
                    errors.append((mid, model.model_id))
                peak[0] = max(peak[0], len(wrapper.model_ids))
                await asyncio.sleep(rng.random() * 0.002)
            finally:
                port_multiplex._end_request_loans(scope)

        async def main():
            for _ in range(40):
                await one()

        try:
            asyncio.run(main())
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert peak[0] <= 2 and len(wrapper.model_ids) <= 2
    assert wrapper._refs == {} and wrapper._pending_evict == {}
    assert wrapper._loading == {}
    assert len(live) == len(wrapper.model_ids)
    assert len(loads) >= 4


def test_a_dropped_engine_frees_its_pool_without_the_cycle_collector():
    """An evicted engine must give its memory back when its last
    reference goes: with the cycle collector off, dropping a multiplexed
    engine (which stops its thread) frees its weights and its KV pool,
    prefix index and all."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import TransformerConfig, init_params

    jparams = init_params(jax.random.PRNGKey(0), TransformerConfig(
        dtype=jnp.float32, **TINY))
    np_params = jax.tree.map(np.asarray, jparams)
    model = mux.TinyEngine(np_params, TINY, ENGINE)
    # (The engine modules' first import leaves its frames in a cycle
    # through the constructor's frame: collected here, before the check.)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        assert model.engine.prefix_index is not None
        toks = list(model.engine.submit(PROMPTS[1], NEW))
        assert toks == list(model.engine.submit(PROMPTS[1], NEW))
        assert model.engine.stats()["prefix_hit_tokens"] > 0
        pool = weakref.ref(model.engine.cache._buffer)
        embed = weakref.ref(model.engine.model._params["embed"])
        thread = model.engine._thread
        del model
        assert pool() is None and embed() is None
        assert not thread.is_alive()
    finally:
        if enabled:
            gc.enable()


# ---------------------------------------------------------------------------
# tests/test_serve_multiplex_grpc.py's multiplex cases, in process and on
# the cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["in_process", "cluster"])
def runtime(request):
    if request.param == "in_process":
        ray_tpu_torch.init(local_mode=True)
    else:
        helpers.start(ray_tpu_torch)
    serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    try:
        yield request.param
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_multiplexed_loading_and_lru(runtime):
    handle = serve.run(serve.deployment(mux.Adapters).bind(),
                       name="adapters")
    h1 = handle.options(multiplexed_model_id="aa")

    out = h1.remote(3).result(timeout_s=60)
    assert out == {"model": "aa", "y": 6, "loads": ["aa"]}
    # Warm hit: no second load of "aa".
    out = h1.remote(4).result(timeout_s=60)
    assert out["loads"] == ["aa"]

    # Second model coexists (cap 2).
    out = handle.options(multiplexed_model_id="bbbb").remote(
        2).result(timeout_s=60)
    assert out["model"] == "bbbb" and out["y"] == 8
    assert out["loads"] == ["aa", "bbbb"]

    # Third model evicts the LRU ("aa"); re-requesting "aa" re-loads.
    handle.options(multiplexed_model_id="cc").remote(1).result(
        timeout_s=60)
    out = h1.remote(1).result(timeout_s=60)
    assert out["loads"].count("aa") == 2, out["loads"]
    serve.delete("Adapters")


def test_missing_model_id_is_typed_error(runtime):
    handle = serve.run(serve.deployment(mux.Adapters, name="adapters2")
                       .bind(), name="adapters2")
    with pytest.raises(Exception, match="model id"):
        handle.remote(1).result(timeout_s=60)
    serve.delete("adapters2")


def test_model_affinity_routes_to_warm_replica(runtime):
    handle = serve.run(serve.deployment(mux.Affinity, num_replicas=2)
                       .bind(), name="affinity")
    h = handle.options(multiplexed_model_id="m1")
    pids = set()
    loaded = []
    for _ in range(10):
        out = h.remote(0).result(timeout_s=60)
        pids.add(out["pid"])
        loaded = out["loaded"]
    # All 10 requests for one model land on ONE replica of the two, and
    # it loaded the model once.
    assert len(pids) == 1, f"model m1 bounced across replicas: {pids}"
    assert loaded == ["m1"]
    if runtime == "cluster":
        assert pids != {os.getpid()}
    serve.delete("Affinity")


# ---------------------------------------------------------------------------
# The small transformer, multiplexed, in a replica process
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128)
ENGINE = dict(max_batch_size=4, block_size=8, num_blocks=32)
MODEL_SEEDS = {"tenant-a": 1, "tenant-b": 2, "tenant-c": 3}
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(2, 64, n)]
           for s, n in ((1, 5), (2, 17))]
NEW = 8


def jax_engine_tokens(jparams, jcfg):
    import ray_tpu.serve.engine as jax_engine

    out = []
    for prompt in PROMPTS:
        eng = jax_engine.InferenceEngine(
            jax_engine.TransformerEngineModel(jparams, jcfg),
            jax_engine.EngineConfig(**ENGINE))
        stream = eng.submit(prompt, NEW)
        while eng.step():
            pass
        out.append(stream.tokens_so_far())
    return out


def test_multiplexed_transformer_streams_jax_engine_tokens(runtime):
    """Three model ids (the order a, b, a, c, b) on one replica (a replica
    process on the cluster) of at most two engines: each id's streams are the JAX engine's tokens on that
    id's parameters, and the loads follow the LRU (a, b, c, b)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import TransformerConfig, init_params

    jcfg = TransformerConfig(dtype=jnp.float32, **TINY)
    jparams = {mid: init_params(jax.random.PRNGKey(seed), jcfg)
               for mid, seed in MODEL_SEEDS.items()}
    want = {mid: jax_engine_tokens(p, jcfg) for mid, p in jparams.items()}
    np_params = {mid: jax.tree.map(np.asarray, p)
                 for mid, p in jparams.items()}
    handle = serve.run(serve.deployment(mux.MuxTiny).bind(
        np_params, TINY, ENGINE), name="mux_tiny")
    got = {}
    for mid in ["tenant-a", "tenant-b", "tenant-a", "tenant-c",
                "tenant-b"]:
        h = handle.options(multiplexed_model_id=mid, stream=True,
                           method_name="generate")
        got.setdefault(mid, []).append(
            [list(h.remote({"prompt": p, "max_new_tokens": NEW}))
             for p in PROMPTS])
    loads = handle.options(method_name="load_log").remote().result(
        timeout_s=60)
    serve.delete("MuxTiny")
    assert loads == ["tenant-a", "tenant-b", "tenant-c", "tenant-b"]
    for mid, runs in got.items():
        for streamed in runs:
            assert all(type(t) is int for s in streamed for t in s)
            assert streamed == want[mid], mid
    assert want["tenant-a"] != want["tenant-b"]
