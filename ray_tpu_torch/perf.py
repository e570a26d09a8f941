"""Serving benchmarks, the twins of `ray_tpu/perf.py`'s serving half:

    python -m ray_tpu_torch.perf --llm-serve [--scale S] [--device D]
    python -m ray_tpu_torch.perf --fleet [--scale S]

`run_llm_serve_bench` drives one `InferenceEngine`: continuous vs static
batching, 2x overload behind the ingress's admission gate, prefix
sharing warm vs cold, and paged vs host-gather decode over a small
`TransformerEngineModel` on `device` (default: the first CUDA card).
`run_fleet_bench` drives three TinyLM replicas behind `ServeFleet`:
warm-everywhere (KV-aware routing and prefix shipping) vs
cold-per-replica, then a seeded replica kill and its recovery. Both
return the reference's keys; each run prints one JSON object. The TinyLM
sections run on the host, as the reference's do.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict

from ray_tpu_torch.device import DeviceLike, resolve_device

_PAGED_BENCH_MODELS: Dict[Any, Any] = {}


def _paged_bench_model(device: DeviceLike = None):
    """One `TransformerEngineModel` per device, shared across bench
    rounds and modes (the reference's own config: d_model 256, 8 heads,
    2 layers, vocab 128), with weights from a generator seeded with 0.
    Its head_dim of 32 takes plain attention, as on the TPU."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve.engine import TransformerEngineModel

    dev = resolve_device(device)
    model = _PAGED_BENCH_MODELS.get(dev)
    if model is None:
        # d_model 256 / 8 heads -> 4 KB of KV per token: big enough
        # that the per-step host materialization the paged path removes
        # is a real fraction of the step, small enough to stay cheap.
        cfg = TransformerConfig(vocab_size=128, d_model=256, n_layers=2,
                                n_heads=8, d_ff=256, max_seq_len=256,
                                dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = _PAGED_BENCH_MODELS[dev] = TransformerEngineModel(
            init_params(cfg, gen, dev), cfg, dev)
    return model


def run_llm_serve_bench(scale: float = 1.0,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """LLM-serving scenario: the continuous-batching engine vs the
    `@serve.batch`-style static policy on the SAME mixed-length
    workload, plus shedding behavior under 2x overload.

    Both sides run the identical `InferenceEngine` loop (same KV-cache
    manager, same bookkeeping, same deterministic TinyLM with a 1 ms
    simulated model-dispatch cost per prefill/decode call) — only the
    admission policy differs, so the ratio measures iteration-level
    scheduling itself: static pays the batch's long pole at shrinking
    occupancy (28 near-empty decode calls for one 32-token straggler),
    continuous refills those slots from the queue.

    Returns:
      llm_engine_tok_s / llm_static_tok_s : generated tokens per second
      llm_engine_vs_static               : the continuous-batching win
      llm_ttft_p50_ms                    : submit -> first-token median
      llm_overload_shed / llm_overload_p99_ms : 2x-overload behavior
        behind the proxy's admission gate (sheds counted pre-queue;
        p99 of SERVED requests must stay bounded)
      llm_prefix_warm_vs_cold            : prefix-sharing win — the
        SAME shared-system-prompt workload through the identical loop
        with sharing on (warm: one prefill, every conversation adopts
        the prompt's blocks) vs off (cold: every request re-prefills),
        with warm/cold TTFT p50s, llm_prefix_hit_tokens and
        llm_prefix_cow_copies riding along
      llm_paged_vs_host                  : device-resident paged decode
        (block gather and pool writes on `device`) vs the host-gather
        loop over a TransformerEngineModel on `device`, with
        llm_paged_steps / llm_paged_host_gathers / llm_paged_parity
        structural asserts riding along

    The TinyLM sections run on the host. `device` (default: the first
    CUDA card) places the paged section's model and pool.
    """
    from ray_tpu_torch.serve._private.proxy import _AdmissionGate
    from ray_tpu_torch.serve.engine import (EngineConfig,
                                            EngineOverloadedError,
                                            InferenceEngine, TinyLM)

    out: Dict[str, Any] = {}

    def workload():
        reqs = []
        for i in range(max(8, int(48 * scale))):
            if i % 8 == 0:
                reqs.append(([3 + (i % 11), 5, 7], 32))    # long pole
            else:
                reqs.append(([2 + (i % 13), 4], 4))        # short
        return reqs

    step_cost = 0.001
    for policy in ("continuous", "static"):
        eng = InferenceEngine(
            TinyLM(step_delay_s=step_cost),
            EngineConfig(max_batch_size=8, block_size=8, num_blocks=96,
                         max_queue=256, policy=policy))
        reqs = workload()
        t0 = time.perf_counter()
        streams = [eng.submit(p, n) for p, n in reqs]
        while eng.step():
            pass
        dt = time.perf_counter() - t0
        tokens = eng.tokens_generated
        assert all(s.finished for s in streams)
        key = "llm_engine" if policy == "continuous" else "llm_static"
        out[f"{key}_tok_s"] = round(tokens / dt, 1)
        out[f"{key}_steps"] = eng.steps
        if policy == "continuous":
            st = eng.stats()
            out["llm_ttft_p50_ms"] = st["ttft_p50_ms"]
    out["llm_engine_vs_static"] = round(
        out["llm_engine_tok_s"] / max(out["llm_static_tok_s"], 1e-9), 2)

    # -- 2x overload through the admission gate ------------------------
    # Service capacity ~ max_batch tokens per step_cost; offer double
    # that arrival rate for a fixed window. The gate caps in-flight at
    # the engine's own bound, so excess arrivals shed in microseconds
    # and the p99 of SERVED requests stays a function of queue bound x
    # service time, not of the offered load.
    eng = InferenceEngine(
        TinyLM(step_delay_s=step_cost),
        EngineConfig(max_batch_size=8, block_size=8, num_blocks=96,
                     max_queue=16, policy="continuous"))
    eng.start()
    gate = _AdmissionGate(max_inflight=24)
    capacity_rps = 8 / (4 * step_cost)     # ~batch/step per short req
    offered_rps = 2 * capacity_rps
    window_s = 1.2
    interval = 1.0 / offered_rps
    shed = 0
    done: list = []
    lock_t0 = time.perf_counter()
    submitted = []
    next_at = lock_t0
    while time.perf_counter() - lock_t0 < window_s:
        now = time.perf_counter()
        if now < next_at:
            time.sleep(min(next_at - now, 0.001))
            continue
        next_at += interval
        inflight = eng.batch_occupancy() + eng.queue_depth()
        if gate.check(inflight) is not None:
            shed += 1
            continue
        try:
            submitted.append((time.perf_counter(),
                              eng.submit([5, 9], 4)))
        except EngineOverloadedError:
            shed += 1
    for t_sub, stream in submitted:
        for _ in stream:
            pass
        # finished_at is stamped by the engine thread at retirement, so
        # the latency is submit -> completion, not submit -> drain.
        done.append(stream.finished_at - t_sub)
    eng.stop()
    lat = sorted(done)
    out["llm_overload_shed"] = shed
    out["llm_overload_served"] = len(done)
    out["llm_overload_p99_ms"] = round(
        lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3, 1) \
        if lat else None

    # -- prefix-sharing workload: shared system prompt, N convos ------
    # A fleet-wide 80-token system prompt (5 full 16-token blocks)
    # fronts every conversation; per-token prefill cost makes the
    # compute half of sharing measurable. Warm = prefix_sharing on
    # (first admission prefills the prompt once, later ones adopt its
    # blocks and prefill only their 3-token tail); cold = sharing off
    # through the IDENTICAL loop, so the ratio measures prefix reuse
    # itself. Two truncated re-asks (mid-block proper prefixes of the
    # shared doc) exercise the full-hit + COW path.
    sys_prompt = [7 + (i % 19) for i in range(80)]

    def prefix_workload():
        reqs = [(sys_prompt + [2 + (i % 9), 3 + (i % 5), 4 + (i % 7)],
                 8) for i in range(max(6, int(24 * scale)))]
        reqs += [(sys_prompt[:76], 8), (sys_prompt[:70], 8)]
        return reqs

    for mode, sharing in (("warm", True), ("cold", False)):
        eng = InferenceEngine(
            TinyLM(step_delay_s=step_cost,
                   prefill_token_delay_s=0.0004),
            EngineConfig(max_batch_size=8, block_size=16,
                         num_blocks=160, max_queue=256,
                         prefix_sharing=sharing))
        reqs = prefix_workload()
        t0 = time.perf_counter()
        streams = [eng.submit(p, n) for p, n in reqs]
        while eng.step():
            pass
        dt = time.perf_counter() - t0
        assert all(s.finished for s in streams)
        st = eng.stats()
        out[f"llm_prefix_{mode}_tok_s"] = round(
            eng.tokens_generated / dt, 1)
        out[f"llm_prefix_{mode}_ttft_p50_ms"] = st["ttft_p50_ms"]
        if sharing:
            out["llm_prefix_hit_tokens"] = eng.prefix_hit_tokens
            out["llm_prefix_cow_copies"] = eng.cache.cow_copies
    out["llm_prefix_warm_vs_cold"] = round(
        out["llm_prefix_warm_tok_s"]
        / max(out["llm_prefix_cold_tok_s"], 1e-9), 2)
    out["llm_prefix_ttft_cold_over_warm"] = round(
        out["llm_prefix_cold_ttft_p50_ms"]
        / max(out["llm_prefix_warm_ttft_p50_ms"], 1e-9), 2)

    # -- paged vs host-gather decode -----------------------------------
    # The device-resident paged path (pool + block tables into one
    # model step: `index_select` gather, decode math, in-place KV
    # `index_put_`) vs the identical loop materializing the padded KV
    # batch on the host every step — over a TransformerEngineModel
    # (TinyLM's numpy decode would hide the data movement this path
    # removes). The host side pays O(batch)
    # per-sequence gathers + row copies + a zeros alloc per step, so
    # the measured win scales with occupancy and decode length; the
    # workload is therefore FIXED (batch 16, 96-token decodes), not
    # `scale`d — shrinking it shrinks the structural gap the floor
    # guards, not just the runtime. Rounds INTERLEAVE the two modes so
    # box-level drift (turbo, neighbors) common-modes out of the
    # fold-best ratio, and each engine gets two untimed warmups: the
    # first meets the cold-cache buckets, the second the
    # prefix-hit/adoption buckets only repeat traffic reaches.
    model = _paged_bench_model(device)

    def paged_workload():
        reqs = []
        for i in range(16):
            plen = 6 + (i * 7) % 19
            prompt = [2 + ((i * 5 + j) % 120) for j in range(plen)]
            reqs.append((prompt, 96))
        return reqs

    def paged_engine(paged: bool):
        eng = InferenceEngine(model, EngineConfig(
            max_batch_size=16, block_size=16, num_blocks=192,
            max_queue=256, paged_decode=paged))
        # Threaded (production-shaped) drive: the engine loop overlaps
        # with the consumer drain, the same overlap a replica serves
        # under — and the shape where one-dispatch-per-step pays most.
        eng.start()
        return eng

    def run_paged_round(eng):
        reqs = paged_workload()
        t0 = time.perf_counter()
        streams = [eng.submit(p, n) for p, n in reqs]
        toks = [tuple(s) for s in streams]
        dt = time.perf_counter() - t0
        assert all(s.finished for s in streams)
        return sum(len(t) for t in toks) / dt, toks

    eng_pg = paged_engine(True)
    eng_hg = paged_engine(False)
    for eng in (eng_pg, eng_hg):
        run_paged_round(eng)
        run_paged_round(eng)
    best_pg = best_hg = 0.0
    toks_pg = toks_hg = None
    for _ in range(3):
        r, toks_pg = run_paged_round(eng_pg)
        best_pg = max(best_pg, r)
        r, toks_hg = run_paged_round(eng_hg)
        best_hg = max(best_hg, r)
    out["llm_paged_tok_s"] = round(best_pg, 1)
    out["llm_hostgather_tok_s"] = round(best_hg, 1)
    out["llm_paged_vs_host"] = round(best_pg / max(best_hg, 1e-9), 2)
    # Structural honesty: the paged engine actually ran paged steps,
    # never host-gathered KV, and emitted token-for-token what the
    # host-gather loop emitted.
    out["llm_paged_steps"] = eng_pg.paged_steps
    out["llm_paged_host_gathers"] = eng_pg.cache.host_gathers
    out["llm_paged_parity"] = int(toks_pg == toks_hg)
    out["llm_paged_kv_gather_ms"] = round(eng_pg.kv_gather_s * 1e3, 2)
    out["llm_hostgather_kv_gather_ms"] = round(
        eng_hg.kv_gather_s * 1e3, 2)
    eng_pg.stop()
    eng_hg.stop()
    return out


def run_fleet_bench(scale: float = 1.0) -> Dict[str, Any]:
    """Multi-replica serving fleet: cross-replica prefix shipping and
    conversation recovery, 3 in-process `InferenceEngine` replicas
    behind the KV-cache-aware `ServeFleet` router.

    Phase 1 — warm-everywhere vs cold-per-replica: the SAME burst of
    shared-system-prompt conversations (80-token prompt, 5 sealed
    16-token blocks, simulated per-token prefill cost) through the
    identical fleet twice. Cold: KV-aware routing and shipping OFF —
    pure least-loaded spread, each replica pays its own full system-
    prompt prefill. Warm: routing + shipping ON after one warm-up
    conversation on one replica — overload spill moves excess
    conversations to cold replicas, but each spill ships the sealed
    prompt chain first, so the spilled conversation prefills only its
    3-token tail. The ratio measures the fleet layer itself (the
    per-replica engines are identical, local prefix sharing on in both).

    Phase 2 — recovery: a seeded `crash_after` kills a replica on its
    nth streamed token mid-decode; the fleet migrates the conversation
    to a survivor which re-prefills through its radix index and
    continues. Recovery latency = kill -> first post-recovery token;
    the output is asserted token-for-token against the no-fault oracle.

    Returns:
      fleet_warm_tok_s / fleet_cold_tok_s / fleet_warm_vs_cold
      fleet_cold_ttft_p50_ms      : TTFT when every replica re-prefills
      fleet_remote_warm_ttft_p50_ms : TTFT of conversations whose
        prefix was shipped in (must beat cold re-prefill)
      fleet_ttft_cold_over_remote : the shipping TTFT win
      fleet_prefix_ships / fleet_prefix_ship_tokens
      fleet_recovery_ms           : replica kill -> first survivor token
      fleet_recoveries / fleet_lost_conversations
    """
    from ray_tpu_torch.core.faults import FaultPlan
    from ray_tpu_torch.serve.engine import EngineConfig, TinyLM
    from ray_tpu_torch.serve.fleet import FleetConfig, ServeFleet

    out: Dict[str, Any] = {}
    sys_prompt = [7 + (i % 19) for i in range(80)]
    n_convs = max(9, int(12 * scale))
    max_new = 16

    def econf() -> EngineConfig:
        return EngineConfig(max_batch_size=8, block_size=16,
                            num_blocks=160, max_queue=256)

    def model():
        return TinyLM(vocab_size=64, prefill_token_delay_s=0.0008)

    def run_phase(kv_routing: bool, shipping: bool):
        fleet = ServeFleet(FleetConfig(
            model_factory=model, num_replicas=3,
            engine_config=econf(), shipping=shipping,
            kv_routing=kv_routing, digest_max_age_s=0.01))
        fleet.start()
        try:
            if shipping:
                # One warm-up conversation seals the prompt on exactly
                # one replica; the measured burst then finds the fleet
                # in its steady state: one holder, two cold peers.
                warm = fleet.submit(sys_prompt + [2, 3, 4], 4,
                                    session_id="warmup")
                for _ in warm.stream:
                    pass
                time.sleep(0.05)   # let the holder's digest publish
            t0 = time.perf_counter()
            convs = [fleet.submit(
                sys_prompt + [2 + (i % 9), 3 + (i % 5), 4 + (i % 7)],
                max_new, session_id=f"s{i}") for i in range(n_convs)]
            tokens = 0
            for c in convs:
                tokens += sum(1 for _ in c.stream)
            dt = time.perf_counter() - t0
            ttfts = sorted((c.first_token_at - c.submitted_at)
                           for c in convs if c.first_token_at)
            shipped_ttfts = sorted(
                (c.first_token_at - c.submitted_at)
                for c in convs if c.shipped and c.first_token_at)
            return (tokens / dt, ttfts, shipped_ttfts,
                    fleet.prefix_ships, fleet.prefix_ship_tokens,
                    fleet.lost_conversations)
        finally:
            fleet.stop()

    cold_tok_s, cold_ttfts, _, _, _, cold_lost = run_phase(
        kv_routing=False, shipping=False)
    warm_tok_s, _, ship_ttfts, ships, ship_tokens, warm_lost = \
        run_phase(kv_routing=True, shipping=True)
    out["fleet_cold_tok_s"] = round(cold_tok_s, 1)
    out["fleet_warm_tok_s"] = round(warm_tok_s, 1)
    out["fleet_warm_vs_cold"] = round(warm_tok_s / max(cold_tok_s,
                                                       1e-9), 2)
    out["fleet_cold_ttft_p50_ms"] = round(
        cold_ttfts[len(cold_ttfts) // 2] * 1e3, 1) if cold_ttfts else None
    out["fleet_remote_warm_ttft_p50_ms"] = round(
        ship_ttfts[len(ship_ttfts) // 2] * 1e3, 1) if ship_ttfts else None
    out["fleet_ttft_cold_over_remote"] = (
        round(out["fleet_cold_ttft_p50_ms"]
              / max(out["fleet_remote_warm_ttft_p50_ms"], 1e-9), 2)
        if ship_ttfts and cold_ttfts else None)
    out["fleet_prefix_ships"] = ships
    out["fleet_prefix_ship_tokens"] = ship_tokens

    # -- phase 2: seeded kill mid-decode, recovery on a survivor -------
    plan = FaultPlan(seed=19)
    fleet = ServeFleet(FleetConfig(
        model_factory=lambda: TinyLM(vocab_size=64,
                                     step_delay_s=0.002),
        num_replicas=3, engine_config=econf(),
        digest_max_age_s=0.01, fault_plan=plan))
    t_kill: list = []

    def kill(dst: str):
        t_kill.append(time.perf_counter())
        fleet.kill_replica(dst)

    plan.crash_after("replica-0", 8, method="token", on_crash=kill)
    fleet.start()
    try:
        conv = fleet.submit(sys_prompt + [5], 40, session_id="r0")
        got = list(conv.stream)
        want = TinyLM(vocab_size=64).oracle(sys_prompt + [5], 40)
        assert got == want, "recovered stream diverged from oracle"
        assert conv.recovered_token_at is not None and t_kill
        out["fleet_recovery_ms"] = round(
            (conv.recovered_token_at - t_kill[0]) * 1e3, 1)
        out["fleet_recoveries"] = fleet.recoveries
        out["fleet_lost_conversations"] = (
            cold_lost + warm_lost + fleet.lost_conversations)
    finally:
        fleet.stop()
    return out


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="device of --llm-serve's paged section (default: "
                        "the first CUDA card)")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--llm-serve", action="store_true",
                      help="the in-process LLM-serving scenario "
                           "(continuous vs static batching, TTFT, 2x-"
                           "overload shedding, prefix sharing, paged vs "
                           "host-gather decode)")
    mode.add_argument("--fleet", action="store_true",
                      help="the multi-replica serving-fleet scenario "
                           "(KV-aware routing, cross-replica prefix "
                           "shipping warm-vs-cold, seeded replica kill -> "
                           "conversation recovery)")
    args = p.parse_args()
    if args.llm_serve:
        print(json.dumps(run_llm_serve_bench(scale=args.scale,
                                             device=args.device)))
    else:
        print(json.dumps(run_fleet_bench(scale=args.scale)))


if __name__ == "__main__":
    main()
