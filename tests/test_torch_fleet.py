"""The port's serving fleet (`ray_tpu_torch.serve.fleet`) and what it stands
on (the fast wire codec, fault plans, metrics, the engine's static policy
and gauges) against the JAX package's, on the same inputs, on the CPU.

- the codec's frames equal the reference's byte for byte, and each side
  decodes the other's;
- fault decisions, chain hashes and route decisions equal the reference's;
- the static policy's steps and peak width, and the engine's instruments
  after one run, equal the reference engine's;
- TinyLM fleets (the reference's unit and fault-tolerance scenarios) give
  `TinyLM.oracle`'s streams and the reference fleet's;
- three small float32 transformer replicas give the reference fleet's
  tokens with shipping and a seeded kill, and a shipped block equals the
  holder's within 1e-6.
"""

import asyncio
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.core.faults as jax_faults
import ray_tpu.core.serialization as jax_ser
import ray_tpu.serve.engine as jax_engine
import ray_tpu.serve.fleet as jax_fleet
import ray_tpu.serve.fleet.fleet as jax_fleet_mod
import ray_tpu.util.metrics as jax_metrics
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
import ray_tpu_torch.core.faults as faults
import ray_tpu_torch.core.serialization as ser
import ray_tpu_torch.serve.engine as engine
import ray_tpu_torch.serve.fleet as fleet_pkg
import ray_tpu_torch.serve.fleet.fleet as fleet_mod
import ray_tpu_torch.util.metrics as metrics
from ray_tpu_torch.kernels import flash_attn
from ray_tpu_torch.models import TransformerConfig, params_from_jax

BS = 16
SYS = [5, 9, 3] * 27 + [4]                  # 82 tokens: 5 full blocks + tail
FT_SYS = [7 + (i % 19) for i in range(80)]  # 5 sealed blocks


# ---------------------------------------------------------------------------
# the fast wire codec
# ---------------------------------------------------------------------------
CODEC_ARRAYS = [
    np.zeros((0,), np.float32),
    np.zeros((3, 0, 200), np.float32),
    np.arange(12, dtype=np.int64).reshape(3, 4),
    np.random.default_rng(0).standard_normal((16, 2, 12, 128)).astype(
        np.float32),
    np.random.default_rng(1).integers(0, 1 << 40, (5, 16)).astype(np.int64),
    np.ones((128,), np.float32),
    np.ones((255, 256), np.int64),
    np.ones((70000,), np.uint8),
    np.ones((1,) * 17, np.float32),
    np.array(3.5, np.float32),
]


@pytest.mark.parametrize("arr", CODEC_ARRAYS,
                         ids=[f"{a.dtype}{list(a.shape)[:5]}"
                              for a in CODEC_ARRAYS])
def test_codec_frames_equal_reference(arr):
    frame = ser.serialize_fast(arr)
    assert frame == jax_ser.serialize_fast(arr)
    for decoded in (ser.deserialize_fast(jax_ser.serialize_fast(arr)),
                    jax_ser.deserialize_fast(frame)):
        assert decoded.dtype == arr.dtype and decoded.shape == arr.shape
        np.testing.assert_array_equal(decoded, arr)


def test_codec_scalars_and_no_pickle():
    for value in (None, b"\x00frame", "päth"):
        frame = ser.serialize_fast(value)
        assert frame == jax_ser.serialize_fast(value)
        assert ser.deserialize_fast(frame) == value
    for value in (3, 2.5, [1, 2], {"a": 1},
                  np.ones((4, 4), np.float32)[:, ::2],
                  np.array([object()], object)):
        with pytest.raises(TypeError):
            ser.serialize_fast(value)
    with pytest.raises(ValueError):
        ser.deserialize_fast(jax_ser.serialize_fast(7))   # "M": no tag here


# ---------------------------------------------------------------------------
# the kernel launch counts, bumped by several engine threads at once
# ---------------------------------------------------------------------------
class _YieldingCount(int):
    """A count whose `+ 1` gives the other threads the interpreter between
    reading the old value and writing the new one, so an unguarded
    read-add-write loses updates on every run."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


def test_launch_counts_are_exact_under_threads(monkeypatch):
    monkeypatch.setattr(flash_attn, "launches", _YieldingCount(0))
    threads = [threading.Thread(
        target=lambda: [flash_attn._count_launch("launches")
                        for _ in range(200)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert flash_attn.launches == 8 * 200


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------
def _plan_rules(mod, crashed):
    plan = mod.FaultPlan(seed=7)
    plan.drop("a", "b", "ping", p=0.3)
    plan.delay("*", "b", "*", p=0.5, delay_s=0.0)
    plan.duplicate("a", "*", "put", p=0.4, start=2, end=9)
    cut = plan.partition("c", "a")
    plan.isolate("d", ["a"])
    plan.crash_after("b", 5, method="put", on_crash=crashed.append)
    return plan, cut


def _drive_plan(mod):
    crashed = []
    plan, cut = _plan_rules(mod, crashed)
    messages = ([("a", "b", m) for m in ("ping", "put") * 6]
                + [("c", "a", "x"), ("d", "a", "y"), ("a", "d", "z")]
                + [("a", "b", "put")] * 3)
    outcomes = []
    for i, (src, dst, method) in enumerate(messages):
        if i == 14:
            plan.heal(cut)
        try:
            outcomes.append(asyncio.run(plan.apply(src, dst, method)))
        except mod.FaultInjected as e:
            outcomes.append(str(e))
    decisions = [a.key() for a in plan.preview("a", "b", "ping", 40)]
    return outcomes, plan.log_keys(), decisions, crashed


def test_fault_plan_decisions_equal_reference():
    got = _drive_plan(faults)
    want = _drive_plan(jax_faults)
    assert got == want
    assert got[3] == ["b"]                      # the crash fired once
    assert issubclass(faults.FaultInjected, faults.ConnectionLost)
    plan = faults.FaultPlan(seed=1)
    faults.install(plan)
    try:
        assert faults.enabled and faults.get_plan() is plan
    finally:
        faults.uninstall()
    assert not faults.enabled and faults.get_plan() is None


# ---------------------------------------------------------------------------
# chain hashes, digests and the router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block_size", [4, 16])
def test_chain_hashes_equal_reference(block_size):
    rng = np.random.default_rng(3)
    prompts = [SYS, FT_SYS, [], [2] * 15,
               rng.integers(0, 32768, 300).tolist()]
    for p in prompts:
        got = fleet_pkg.prompt_chain_hashes(p, block_size)
        assert got == jax_fleet.prompt_chain_hashes(p, block_size)
        assert len(got) == len(p) // block_size


class _FakeReplica:
    def __init__(self, digest_cls, hashes=(), alive=True):
        self.alive = alive
        self._d = digest_cls(hashes, len(hashes), stamp=0.0)

    def digest(self):
        return self._d


def _route_scenario(pkg, name):
    """Run one routing scenario on package `pkg`'s router; returns every
    decision and the router's stats."""
    h = pkg.prompt_chain_hashes(SYS, BS)
    r = pkg.FleetRouter(BS)
    rep = lambda hashes=(), alive=True: _FakeReplica(  # noqa: E731
        pkg.ReplicaDigest, hashes, alive)
    out = []
    if name == "longest_prefix":
        r.register("a", rep(h[:2]))
        r.register("b", rep(h))
        r.register("c", rep())
        out.append(r.route(SYS + [7]))
        out.append(r.route(SYS[:40]))
    elif name == "sticky_until_overloaded":
        r.register("a", rep())
        r.register("b", rep(h))
        out.append(r.route(SYS, session_id="s"))
        out.append(r.route(SYS, session_id="s"))
        for _ in range(6):
            r.begin("b")
        out.append(r.route(SYS, session_id="s"))
        out.append(r.route([2, 3], session_id="s"))
    elif name == "miss_with_remote_hit":
        r.register("hot", rep(h))
        r.register("cold", rep())
        r.register("warm", rep(h[:1]))
        for _ in range(6):
            r.begin("hot")
        out.append(r.route(SYS + [7]))
        r.begin("cold")
        r.begin("warm")
        out.append(r.route(SYS + [7]))
    elif name == "least_loaded":
        r.register("a", rep())
        r.register("b", rep())
        r.register("c", rep(alive=False))
        r.begin("a")
        out.append(r.route([2, 3]))
        r.begin("b")
        r.begin("b")
        out.append(r.route([2, 3]))
        out.append(r.route([2, 3], exclude=("a",)))
    elif name == "dropped_replica":
        r.register("a", rep(h))
        r.register("b", rep())
        out.append(r.route(SYS, session_id="s"))
        r.begin("a")
        r.drop_replica("a")
        r.complete("a")
        out.append(r.route(SYS, session_id="s"))
        r.drop_replica("b")
        try:
            r.route(SYS)
        except pkg.NoReplicasError as e:
            out.append(type(e).__name__)
    return ([dataclasses.asdict(d) if not isinstance(d, str) else d
             for d in out], r.stats(), r.inflight_snapshot())


@pytest.mark.parametrize("name", ["longest_prefix", "sticky_until_overloaded",
                                  "miss_with_remote_hit", "least_loaded",
                                  "dropped_replica"])
def test_router_decisions_equal_reference(name):
    got = _route_scenario(fleet_pkg, name)
    assert got == _route_scenario(jax_fleet, name)
    assert got[0], "the scenario made no decision"


def test_engine_digest_matches_reference():
    port, ref = _tiny_engine(engine), _tiny_engine(jax_engine)
    for eng in (port, ref):
        _run(eng, SYS + [7], 4)
    d, dj = (pkg.ReplicaDigest.from_engine(e)
             for pkg, e in ((fleet_pkg, port), (jax_fleet, ref)))
    assert d.hashes == dj.hashes and d.nodes == dj.nodes > 0
    for prompt, blocks in ((SYS + [7, 8], 5), ([60] * 40, 0),
                           (SYS[:BS * 2], 2)):
        hashes = fleet_pkg.prompt_chain_hashes(prompt, BS)
        assert d.match_blocks(hashes) == dj.match_blocks(hashes) == blocks


# ---------------------------------------------------------------------------
# the engine: static policy, replica tag, instruments
# ---------------------------------------------------------------------------
def _tiny_engine(pkg, **kw):
    cfg = dict(max_batch_size=4, block_size=BS, num_blocks=96, max_queue=64)
    cfg.update(kw)
    return pkg.InferenceEngine(pkg.TinyLM(vocab_size=64),
                               pkg.EngineConfig(**cfg))


def _run(eng, prompt, n):
    s = eng.submit(prompt, n)
    while eng.step():
        pass
    return list(s)


def _static_run(pkg, policy):
    """The reference's static-policy workload (one 24-token long pole,
    six 3-token shorts, batch 4): steps, peak width, whether a second
    batch started while the first was held, and the streams."""
    reqs = [([3, 3, 3], 24)] + [([4 + i], 3) for i in range(6)]
    eng = pkg.InferenceEngine(pkg.TinyLM(), pkg.EngineConfig(
        max_batch_size=4, block_size=4, num_blocks=64, policy=policy))
    streams = [eng.submit(p, n) for p, n in reqs]
    steps = peak = 0
    refilled = False
    while eng.step():
        steps += 1
        peak = max(peak, eng.batch_occupancy())
        if (not streams[0].finished
                and any(s.finished for s in streams[1:4])
                and any(not s.finished and s.tokens_so_far()
                        for s in streams[4:])):
            refilled = True
        assert steps < 10000
    assert [s.tokens_so_far() for s in streams] == [
        pkg.TinyLM().oracle(p, n) for p, n in reqs]
    return steps, peak, refilled, eng.steps


def test_static_policy_holds_batch_to_completion():
    static = _static_run(engine, "static")
    cont = _static_run(engine, "continuous")
    assert static == _static_run(jax_engine, "static")
    assert cont == _static_run(jax_engine, "continuous")
    steps, peak, refilled, _ = static
    assert peak == 4 and not refilled and steps > cont[0]


def _instruments(mod):
    return {m["name"]: m for m in mod.default_registry().snapshot()}


def _values(snap, name, tags=None):
    """Sum of a counter/gauge's samples whose tags include `tags`."""
    m = snap.get(name)
    if m is None:
        return None
    return sum(s["value"] for s in m["samples"]
               if all(s["tags"].get(k) == v for k, v in (tags or {}).items()))


def _gauges_after_run(pkg, metrics_mod, tag):
    counters = ("serve_engine_tokens_generated", "serve_engine_preemptions",
                "serve_engine_prefix_hit_tokens", "serve_engine_cow_copies")
    before = _instruments(metrics_mod)
    ttft_before = sum(s["count"] for s in before.get(
        "serve_engine_time_to_first_token_seconds", {"samples": []})
        ["samples"])
    eng = _tiny_engine(pkg, num_blocks=24, replica_tag=tag,
                       paged_decode=True)
    assert eng.replica_tag == tag
    streams = [eng.submit(SYS + [7 + i], 6) for i in range(3)]
    streams.append(eng.submit(SYS[:70], 4))
    while eng.step():
        pass
    assert all(s.finished for s in streams)
    after = _instruments(metrics_mod)
    out = {name: _values(after, name) - (_values(before, name) or 0.0)
           for name in counters}
    for name in ("serve_engine_batch_occupancy",
                 "serve_engine_cache_utilization",
                 "serve_engine_queue_depth"):
        out[name] = _values(after, name)
    for name in ("serve_prefix_index_nodes", "serve_prefix_sealed_blocks",
                 "serve_prefix_hits", "serve_prefix_evictions"):
        out[name] = _values(after, name, {"replica": tag})
    out["serve_engine_kv_pool_bytes"] = _values(
        after, "serve_engine_kv_pool_bytes",
        {"replica": tag, "residency": "device"})
    out["phases"] = sorted(
        phase for phase in ("prefill", "decode", "kv_gather", "model_step",
                            "kv_write")
        if _values(after, "serve_engine_step_seconds", {"phase": phase})
        > (_values(before, "serve_engine_step_seconds", {"phase": phase})
           or 0.0))
    out["ttft_count"] = sum(s["count"] for s in after[
        "serve_engine_time_to_first_token_seconds"]["samples"]) - ttft_before
    return out


def test_engine_instruments_equal_reference():
    """After the same run the port's instruments read what the
    reference's read; every gauge was set (a swallowed error in the
    gauge update would leave one unset, which fails here)."""
    got = _gauges_after_run(engine, metrics, "gauge-check")
    want = _gauges_after_run(jax_engine, jax_metrics, "gauge-check")
    assert got == want
    assert all(v is not None for v in got.values()), got
    assert got["serve_engine_tokens_generated"] == 3 * 6 + 4
    assert got["serve_prefix_index_nodes"] > 0
    assert got["serve_engine_kv_pool_bytes"] == 24 * BS * 4
    assert got["ttft_count"] == 4


def test_tinylm_delays():
    m = engine.TinyLM(step_delay_s=0.002, prefill_token_delay_s=0.001)
    t0 = time.perf_counter()
    m.prefill(list(range(2, 12)), np.zeros((4, 1), np.float32))
    t1 = time.perf_counter()
    m.decode([np.zeros((3, 1), np.float32)], [5], [3])
    t2 = time.perf_counter()
    assert t1 - t0 >= 6 * 0.001                 # the tail only
    assert t2 - t1 >= 0.002


# ---------------------------------------------------------------------------
# shipping
# ---------------------------------------------------------------------------
def test_prefix_frames_equal_reference_and_never_pickle():
    port, ref = _tiny_engine(engine), _tiny_engine(jax_engine)
    frames = []
    for pkg, eng in ((fleet_pkg, port), (jax_fleet, ref)):
        _run(eng, SYS + [7], 4)
        chunks, kvs = eng.export_prefix(SYS + [7])
        assert len(chunks) == len(kvs) == 5
        frames.append(pkg.encode_prefix_frames(chunks, kvs))
    assert frames[0] == frames[1]
    assert all(f[:1] == b"A" for f in frames[0])
    chunks, kvs = fleet_pkg.decode_prefix_frames(frames[1])
    assert [list(c) for c in chunks] == [SYS[i * BS:(i + 1) * BS]
                                         for i in range(5)]
    with pytest.raises(ValueError):
        fleet_pkg.decode_prefix_frames(frames[0][:-1])
    assert fleet_pkg.encode_prefix_frames([], []) == []
    assert fleet_pkg.decode_prefix_frames([]) == ([], [])


def _ship(pkg, fpkg):
    src, dst = _tiny_engine(pkg), _tiny_engine(pkg)
    _run(src, SYS + [7], 4)
    shipped = fpkg.ship_prefix(src, dst, SYS + [7])
    held = (dst.cache.stats()["used_blocks"], dst.prefix_index.held_blocks())
    out = _run(dst, SYS + [8], 6)
    again = fpkg.ship_prefix(src, dst, SYS + [7])
    while dst.step():
        pass
    return (shipped, again, held, dst.prefix_imports, src.prefix_exports,
            dst.prefix_hit_tokens, out,
            dst.cache.stats()["used_blocks"] == dst.prefix_index.held_blocks())


def test_ship_prefix_adopts_by_reference():
    got = _ship(engine, fleet_pkg)
    assert got == _ship(jax_engine, jax_fleet)
    shipped, _, held, imports, exports, hits, out, no_leak = got
    assert shipped == 5 * BS and held == (5, 5) and no_leak
    assert hits >= 5 * BS
    assert out == engine.TinyLM(vocab_size=64).oracle(SYS + [8], 6)


def _truncated_export(pkg):
    """A block freed between the index walk and its read truncates the
    export at that block."""
    eng = _tiny_engine(pkg)
    _run(eng, SYS + [7], 4)
    walk = eng.prefix_index.export_chain

    def walk_then_evict(tokens):
        chain = walk(tokens)
        eng.cache.release(chain[2][1])       # the index's only reference
        return chain

    eng.prefix_index.export_chain = walk_then_evict
    chunks, kvs = eng.export_prefix(SYS + [7])
    return [list(c) for c in chunks], [np.asarray(k).tolist() for k in kvs]


def test_export_truncated_by_eviction():
    got = _truncated_export(engine)
    assert got == _truncated_export(jax_engine)
    assert len(got[0]) == len(got[1]) == 2


# ---------------------------------------------------------------------------
# TinyLM fleets
# ---------------------------------------------------------------------------
def _fleet(pkg, fpkg, plan=None, step_delay_s=0.0, **kw):
    cfg = dict(model_factory=lambda: pkg.TinyLM(vocab_size=64,
                                                step_delay_s=step_delay_s),
               num_replicas=3,
               engine_config=pkg.EngineConfig(max_batch_size=4,
                                              block_size=BS, num_blocks=96,
                                              max_queue=64),
               digest_max_age_s=0.01, fault_plan=plan)
    cfg.update(kw)
    return fpkg.ServeFleet(fpkg.FleetConfig(**cfg))


def _join_migrators(fleet, timeout=5.0):
    for t in list(fleet._migrators):
        t.join(timeout=timeout)


BOTH = [(engine, fleet_pkg, faults), (jax_engine, jax_fleet, jax_faults)]


def _zero_conversation_death(pkg, fpkg, _):
    fleet = _fleet(pkg, fpkg)
    fleet.start()
    try:
        c = fleet.submit(SYS + [7], 6, session_id="s0")
        first = list(c.stream)
        victim = next(r for r in fleet.live_replicas() if r != c.owner)
        fleet.kill_replica(victim)
        _join_migrators(fleet)
        snap = fleet.router.inflight_snapshot()
        c2 = fleet.submit(SYS + [8], 6, session_id="s1")
        return (first, list(c2.stream), fleet.recoveries,
                victim not in snap and all(v == 0 for v in snap.values()))
    finally:
        fleet.stop()


def _finish_during_migration(pkg, fpkg, _):
    fleet = _fleet(pkg, fpkg)
    fleet.start()
    try:
        conv = fleet.submit(SYS + [7], 6, session_id="s0")
        got = list(conv.stream)
        before = fleet.router.inflight_snapshot()
        fleet._migrate_owned(conv.owner, [conv])
        return (got, conv.done, fleet.recoveries, conv.recoveries,
                fleet.router.inflight_snapshot() == before)
    finally:
        fleet.stop()


def _double_death(pkg, fpkg, fmod):
    plan = fmod.FaultPlan(seed=11)
    fleet = _fleet(pkg, fpkg, plan)
    plan.crash_after("replica-0", 4, method="token",
                     on_crash=lambda d: fleet.kill_replica(d))
    plan.crash_after("replica-1", 10, method="token",
                     on_crash=lambda d: fleet.kill_replica(d))
    fleet.start()
    try:
        conv = fleet.submit(SYS + [9], 30, session_id="d0")
        got = list(conv.stream)
        _join_migrators(fleet)
        return (got, fleet.recoveries, conv.recoveries, conv.owner,
                fleet.router.inflight_snapshot(), fleet.lost_conversations,
                plan.log_keys())
    finally:
        fleet.stop()


def _all_dead(pkg, fpkg, _):
    """One replica, never started: the request waits in its queue, so the
    kill always lands before any token (no race with completion)."""
    fleet = _fleet(pkg, fpkg, num_replicas=1)
    try:
        conv = fleet.submit(SYS + [7], 64, session_id="s0")
        fleet.kill_replica("replica-0")
        _join_migrators(fleet)
        try:
            list(conv.stream)
            raised = None
        except Exception as e:  # noqa: BLE001 — the kind is compared
            raised = type(e).__name__
        return (raised, fleet.lost_conversations, fleet.recoveries,
                fleet.live_replicas())
    finally:
        fleet.stop()


@pytest.mark.parametrize("scenario", [_zero_conversation_death,
                                      _finish_during_migration,
                                      _double_death, _all_dead],
                         ids=lambda f: f.__name__.strip("_"))
def test_fleet_failover_bookkeeping_equals_reference(scenario):
    got = scenario(*BOTH[0])
    assert got == scenario(*BOTH[1])
    oracle = engine.TinyLM(vocab_size=64).oracle
    if scenario is _zero_conversation_death:
        assert got[:2] == (oracle(SYS + [7], 6), oracle(SYS + [8], 6))
        assert got[2:] == (0, True)
    elif scenario is _finish_during_migration:
        assert got == (oracle(SYS + [7], 6), True, 0, 0, True)
    elif scenario is _double_death:
        assert got[0] == oracle(SYS + [9], 30)
        assert got[1:6] == (2, 2, "replica-2", {"replica-2": 0}, 0)
    else:
        assert got == ("NoReplicasError", 1, 1, [])


def _ft_burst(pkg, fpkg, fmod):
    """The reference's fault-tolerance scenario: a warm-up conversation,
    then 8 conversations on a shared system prompt while a seeded
    crash kills replica-0 on its 30th streamed token."""
    plan = fmod.FaultPlan(seed=19)
    fleet = fpkg.ServeFleet(fpkg.FleetConfig(
        model_factory=lambda: pkg.TinyLM(vocab_size=64, step_delay_s=0.001),
        num_replicas=3,
        engine_config=pkg.EngineConfig(max_batch_size=8, block_size=BS,
                                       num_blocks=160, max_queue=128),
        digest_max_age_s=0.01, fault_plan=plan))
    killed = []
    plan.crash_after("replica-0", 30, method="token",
                     on_crash=lambda d: killed.append(d)
                     or fleet.kill_replica(d))
    fleet.start()
    try:
        warm = fleet.submit(FT_SYS + [2, 3, 4], 4, session_id="warmup")
        for _ in warm.stream:
            pass
        time.sleep(0.05)
        prompts = [FT_SYS + [2 + (i % 9), 3 + (i % 5), 4 + (i % 7)]
                   for i in range(8)]
        convs = [fleet.submit(p, 24, session_id=f"s{i}")
                 for i, p in enumerate(prompts)]
        streams = [list(c.stream) for c in convs]
        _join_migrators(fleet)
        snap = fleet.router.inflight_snapshot()
        assert fleet.drain(10.0)
        leaks = []
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            leaks = []
            for rid in fleet.live_replicas():
                eng = fleet.replica(rid).engine
                st = eng.cache.stats()
                if not eng.drain(0.1) or \
                        st["used_blocks"] != eng.prefix_index.held_blocks():
                    leaks.append(rid)
            if not leaks:
                break
            time.sleep(0.02)
        return dict(prompts=prompts, streams=streams, killed=killed,
                    live=fleet.live_replicas(), recoveries=fleet.recoveries,
                    lost=fleet.lost_conversations,
                    ships=fleet.prefix_ships,
                    ship_tokens=fleet.prefix_ship_tokens, inflight=snap,
                    leaks=leaks)
    finally:
        fleet.stop()


def test_mid_decode_kill_recovers_every_conversation():
    got = _ft_burst(*BOTH[0])
    want = _ft_burst(*BOTH[1])
    oracle = engine.TinyLM(vocab_size=64).oracle
    assert got["streams"] == [oracle(p, 24) for p in got["prompts"]]
    assert got["streams"] == want["streams"]
    assert got["killed"] == want["killed"] == ["replica-0"]
    assert "replica-0" not in got["live"]
    assert got["recoveries"] >= 1 and got["lost"] == 0
    assert got["ships"] > 0 and got["ship_tokens"] >= 5 * BS
    assert "replica-0" not in got["inflight"]
    assert all(v == 0 for v in got["inflight"].values()), got["inflight"]
    assert not got["leaks"], got["leaks"]
    snap = _instruments(metrics)
    assert _values(snap, "serve_fleet_prefix_ships") > 0
    assert _values(snap, "serve_fleet_conversation_recoveries") > 0
    assert snap["serve_fleet_replicas_alive"]["samples"]


def _replay(pkg, fpkg, fmod):
    outcomes = []
    for _ in range(2):
        plan = fmod.FaultPlan(seed=23)
        fleet = fpkg.ServeFleet(fpkg.FleetConfig(
            model_factory=lambda: pkg.TinyLM(vocab_size=64,
                                             step_delay_s=0.001),
            num_replicas=3,
            engine_config=pkg.EngineConfig(max_batch_size=8, block_size=BS,
                                           num_blocks=160, max_queue=128),
            digest_max_age_s=0.01, fault_plan=plan))
        plan.crash_after("replica-0", 12, method="token",
                         on_crash=lambda d: fleet.kill_replica(d))
        fleet.start()
        try:
            conv = fleet.submit(FT_SYS + [5], 32, session_id="r")
            got = list(conv.stream)
            _join_migrators(fleet)
            outcomes.append((got, fleet.recoveries,
                             [a.key() for a in plan.log
                              if a.kind == "crash"]))
        finally:
            fleet.stop()
    return outcomes


def test_fault_schedule_is_replayable():
    got = _replay(*BOTH[0])
    assert got[0] == got[1] and got[0][1] == 1
    assert got[0][0] == engine.TinyLM(vocab_size=64).oracle(FT_SYS + [5], 32)
    assert got == _replay(*BOTH[1])


# ---------------------------------------------------------------------------
# three small transformer replicas against the reference fleet
# ---------------------------------------------------------------------------
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
             max_seq_len=256)


@pytest.fixture(scope="module")
def small_params():
    jcfg = JaxConfig(dtype=jnp.float32, **SMALL)
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return (jparams, jcfg), (params, TransformerConfig(dtype=torch.float32,
                                                       **SMALL))


def _transformer_fleet(pkg, fpkg, fmod, factory, mod, shipped):
    """A warm-up conversation seals a 64-token shared prompt on one
    replica; a burst of 6 conversations spills over (shipping the prompt
    ahead of each spilled one) while a seeded crash kills the holder on
    its 20th streamed token."""
    real = mod.ship_prefix

    def recording_ship(src, dst, tokens):
        n = real(src, dst, tokens)
        shipped.append((src, dst, list(tokens), n))
        return n

    plan = fmod.FaultPlan(seed=5)
    fleet = fpkg.ServeFleet(fpkg.FleetConfig(
        model_factory=factory, num_replicas=3,
        engine_config=pkg.EngineConfig(max_batch_size=2, block_size=BS,
                                       num_blocks=64, max_queue=64,
                                       paged_decode=True),
        digest_max_age_s=0.0, fault_plan=plan))
    plan.crash_after("replica-0", 20, method="token",
                     on_crash=lambda d: fleet.kill_replica(d))
    rng = np.random.default_rng(11)
    shared = rng.integers(2, 64, 64).tolist()
    tails = [rng.integers(2, 64, int(n)).tolist()
             for n in rng.integers(3, 9, 6)]
    mod.ship_prefix = recording_ship
    fleet.start()
    try:
        warm = fleet.submit(shared + [5, 6, 7], 4, session_id="warmup")
        warm_out = list(warm.stream)
        convs = [fleet.submit(shared + t, 12, session_id=f"s{i}")
                 for i, t in enumerate(tails)]
        out = [list(c.stream) for c in convs]
        _join_migrators(fleet)
        blocks = []
        for src, dst, tokens, n in shipped[:1]:
            for (c_src, b_src), (c_dst, b_dst) in zip(
                    src.prefix_index.export_chain(tokens),
                    dst.prefix_index.export_chain(tokens)):
                assert c_src == c_dst
                blocks.append((np.asarray(src.cache.read_block(b_src)),
                               np.asarray(dst.cache.read_block(b_dst))))
        return dict(warm=warm_out, out=out, ships=fleet.prefix_ships,
                    recoveries=fleet.recoveries,
                    lost=fleet.lost_conversations, blocks=blocks)
    finally:
        mod.ship_prefix = real
        fleet.stop()


def test_transformer_fleet_equals_reference(small_params):
    (jparams, jcfg), (params, cfg) = small_params
    got = _transformer_fleet(
        engine, fleet_pkg, faults,
        lambda: engine.TransformerEngineModel(params, cfg, device="cpu"),
        fleet_mod, [])
    want = _transformer_fleet(
        jax_engine, jax_fleet, jax_faults,
        lambda: jax_engine.TransformerEngineModel(jparams, jcfg),
        jax_fleet_mod, [])
    assert got["warm"] == want["warm"]
    assert got["out"] == want["out"]
    assert got["lost"] == want["lost"] == 0
    assert got["recoveries"] >= 1 and got["ships"] >= 1
    assert len(got["blocks"]) == 4              # the 64-token prompt
    for held, installed in got["blocks"]:
        np.testing.assert_allclose(installed, held, atol=1e-6, rtol=0)
