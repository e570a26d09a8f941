"""Benchmarks, the twins of `ray_tpu/perf.py`'s runtime microbenchmark,
its observability benches and its serving half:

    python -m ray_tpu_torch.perf --microbench [--local] [--attribute]
    python -m ray_tpu_torch.perf --timeline [FILE]
    python -m ray_tpu_torch.perf --flight-overhead
    python -m ray_tpu_torch.perf --metrics-overhead
    python -m ray_tpu_torch.perf --llm-serve [--scale S] [--device D]
    python -m ray_tpu_torch.perf --fleet [--scale S]

`run_microbench` measures the runtime on the host: tasks/s, actor
calls/s, put/get of 10 MB, a 3-actor chain through the lazy DAG
(`dag.execute`, three actor tasks a call) and compiled
(`experimental_compile`, persistent loops and channels), and a 4 MB
array over a 2-stage compiled chain's `"array"` edges, on the cluster
runtime (worker processes) or, with `--local`, the in-process one. Its
keys are the reference's. `--attribute` turns on the per-call
attribution profiler (`core/attribution.py`) in the driver and every
worker it spawns and adds its breakdown (where each task's time went,
the inline/remote split, lease batch sizes) and `wire_decode_bench`
under "attribution"; `format_attribution` prints it as a table on
stderr.

`run_timeline_capture` brackets a remote task burst with the flight
recorder and writes the merged Chrome trace of the driver, the raylet
and every worker. `run_flight_overhead_bench` and
`run_metrics_overhead_bench` measure remote tasks/s with the flight
recorder, and with the metrics pipeline, on and off (two clusters each:
workers read the flag at spawn); the second also reads each raylet's
push counters.

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
from typing import TYPE_CHECKING, Any, Dict, List

if TYPE_CHECKING:
    from ray_tpu_torch.device import DeviceLike


def _noop():
    return None


def _p50(samples: List[float]) -> float:
    s = sorted(samples) or [float("nan")]
    return s[len(s) // 2]


def _p95(samples: List[float]) -> float:
    s = sorted(samples) or [float("nan")]
    return s[min(len(s) - 1, int(len(s) * 0.95))]


def wire_decode_bench(n: int = 3000) -> Dict[str, float]:
    """Validated vs fast-path decode of a representative TaskSpec, in
    microseconds per message (the worker pays exactly one of these per
    pushed task, fast after the schema handshake)."""
    from ray_tpu_torch.core import codec
    from ray_tpu_torch.core.wire import (TaskSpec, from_wire,
                                         from_wire_fast, to_wire)

    payload = codec.unpackb(codec.packb(to_wire(TaskSpec(
        task_id="ab" * 16, job_id="cd" * 8, name="bench", fn_key="k" * 40,
        args=b"x" * 200, resources={"CPU": 1.0}, owner="127.0.0.1:1"))))
    t0 = time.perf_counter()
    for _ in range(n):
        from_wire(payload)
    t1 = time.perf_counter()
    for _ in range(n):
        from_wire_fast(payload)
    t2 = time.perf_counter()
    return {"validated_us": round((t1 - t0) / n * 1e6, 2),
            "fast_us": round((t2 - t1) / n * 1e6, 2)}


class _Counter:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n


class _ChainStage:
    def step(self, x):
        return x + 1

    def echo(self, x):
        return x


def run_microbench(local_mode: bool = False,
                   scale: float = 1.0,
                   attribute: bool = False) -> Dict[str, Any]:
    """{metric: value}: throughputs in ops/s, latencies in ms, the
    reference's keys (`ray_tpu/perf.py` run_microbench). Starts its own
    runtime (and shuts it down), on the cluster with up to 4 CPUs. With
    `attribute`, the attribution profiler runs in the driver and in the
    workers (they inherit its flag at spawn) and its snapshot, with
    `wire_decode_bench`, comes back under "attribution"."""
    import os

    import numpy as np

    import ray_tpu_torch

    from ray_tpu_torch.core import attribution

    prev_attr = attribution.enabled
    if attribute:
        # Before init so spawned workers inherit the env flag.
        attribution.enable()
        attribution.reset()
    ncpu = min(4, max(2, os.cpu_count() or 1))
    ray_tpu_torch.init(local_mode=local_mode,
                       **({} if local_mode else {"num_cpus": ncpu}))
    try:
        # The default handle may dispatch inline (the cluster's
        # same-process fast path); the `_metadata` one keeps measuring
        # leased-worker dispatch.
        noop = ray_tpu_torch.remote(_noop)
        noop_remote = ray_tpu_torch.remote(_metadata={"inline": False})(
            _noop)
        get = ray_tpu_torch.get
        out: Dict[str, Any] = {"mode": "local" if local_mode else "cluster"}
        get([noop_remote.remote() for _ in range(10)], timeout=120)

        def burst(fn, n):
            best = 0.0
            for _ in range(2):
                t0 = time.perf_counter()
                get([fn.remote() for _ in range(n)], timeout=300)
                best = max(best, n / (time.perf_counter() - t0))
            return round(best, 1)

        n = max(1, int(1000 * scale))
        out["tasks_per_s"] = burst(noop_remote, n)
        out["tasks_inline_per_s"] = burst(noop, n)
        lat = []
        for _ in range(max(1, int(50 * scale))):
            t0 = time.perf_counter()
            get(noop_remote.remote(), timeout=60)
            lat.append(time.perf_counter() - t0)
        out["task_roundtrip_p50_ms"] = round(_p50(lat) * 1e3, 3)

        counter = ray_tpu_torch.remote(num_cpus=0)(_Counter).remote()
        get(counter.inc.remote(), timeout=120)
        lat = []
        for _ in range(max(1, int(50 * scale))):
            t0 = time.perf_counter()
            get(counter.inc.remote(), timeout=60)
            lat.append(time.perf_counter() - t0)
        out["actor_call_p50_ms"] = round(_p50(lat) * 1e3, 3)
        n = max(1, int(500 * scale))
        t0 = time.perf_counter()
        get([counter.inc.remote() for _ in range(n)], timeout=300)
        out["actor_calls_per_s"] = round(n / (time.perf_counter() - t0), 1)

        arr = np.zeros(10 * 1024 * 1024 // 4, np.float32)
        puts, gets = [], []
        for _ in range(8):
            t0 = time.perf_counter()
            ref = ray_tpu_torch.put(arr)
            puts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            get(ref, timeout=60)
            gets.append(time.perf_counter() - t0)
            del ref
            time.sleep(0.1)
        out["put_10mb_ms"] = round(_p50(puts) * 1e3, 2)
        out["get_10mb_ms"] = round(_p50(gets) * 1e3, 2)
        out["put_10mb_p95_ms"] = round(_p95(puts) * 1e3, 2)
        out["get_10mb_p95_ms"] = round(_p95(gets) * 1e3, 2)
        mb = arr.nbytes / 1e6
        out["put_bw_MBps"] = round(mb / max(_p50(puts), 1e-9), 1)
        out["get_bw_MBps"] = round(mb / max(_p50(gets), 1e-9), 1)
        out.update(_dag_chain_bench(scale))
        ray_tpu_torch.kill(counter)
        if attribute:
            out["attribution"] = attribution.snapshot()
            out["attribution"]["wire_decode_bench"] = wire_decode_bench()
    finally:
        ray_tpu_torch.shutdown()
        if attribute and not prev_attr:
            attribution.disable()
    return out


def _raylet_calls(rt, method: str, **kwargs) -> List[Dict[str, Any]]:
    """`method`'s reply from the raylet of every live node (a dead or
    wedged one is skipped)."""

    async def _collect():
        out = []
        for node in await rt._gcs.get_nodes():
            if not node.get("alive", True):
                continue
            try:
                client = await rt._raylet_client(node["address"])
                out.append(await client.call(method, timeout=10.0,
                                             **kwargs))
            except Exception:  # noqa: BLE001 — skip a dead node
                pass
        return out

    return [r for r in rt._loop.run(_collect(), timeout=30)
            if isinstance(r, dict)]


def run_timeline_capture(path: str = "ray_tpu_timeline.json",
                         scale: float = 1.0) -> Dict[str, Any]:
    """`python -m ray_tpu_torch.perf --timeline`: bracket a remote task
    burst with the (always-on) flight recorder and write the MERGED
    Chrome trace — the driver's ring, the raylet's and every worker's,
    clock-skew aligned — to `path` (open in Perfetto or
    chrome://tracing). Boots its own cluster; the burst's tasks do not
    dispatch inline, so the trace shows the driver's pushes and the
    workers' executions, the lease churn, and a forced `gc.collect()`
    on the same timeline. (The reference also turns its worker-direct
    rings on here; the port has none yet.)"""
    import gc
    import os

    import ray_tpu_torch
    from ray_tpu_torch.core import flight
    from ray_tpu_torch.core.worker import current_runtime

    ray_tpu_torch.shutdown()
    ncpu = min(4, max(2, os.cpu_count() or 1))
    ray_tpu_torch.init(num_cpus=ncpu)
    out: Dict[str, Any] = {}
    try:
        noop = ray_tpu_torch.remote(_metadata={"inline": False})(_noop)
        ray_tpu_torch.get([noop.remote() for _ in range(10)], timeout=120)
        n = max(1, int(400 * scale))
        t0 = time.perf_counter()
        ray_tpu_torch.get([noop.remote() for _ in range(n)], timeout=300)
        out["tasks_per_s"] = round(n / (time.perf_counter() - t0), 1)
        gc.collect()  # at least one gc event inside the window

        records = [flight.dump(window_s=120.0)]
        for res in _raylet_calls(current_runtime(), "dump_flight_record",
                                 window_s=120.0):
            records.extend(res.get("records", []))
        flight.write_chrome_trace(records, path)
        cats: set = set()
        roles: set = set()
        total = 0
        for rec in records:
            roles.add(rec.get("role"))
            for ev in rec.get("events", ()):
                cats.add(ev[2])
                total += 1
        out.update({
            "timeline_path": os.path.abspath(path),
            "timeline_events": total,
            "timeline_processes": len(records),
            "timeline_roles": sorted(r for r in roles if r),
            "timeline_categories": sorted(cats),
        })
    finally:
        ray_tpu_torch.shutdown()
    return out


def _on_off_bench(module, key: str, scale: float, bursts: int,
                  on_cluster=None) -> Dict[str, Any]:
    """Remote tasks/s on a cluster with `module`'s flag on, then on one
    with it off (workers read the flag from their environment at spawn,
    so it cannot be flipped on a live cluster), fold-best of `bursts`
    bursts on each; `on_cluster(out)` runs before the ON cluster goes.
    The flag and its environment variable are restored afterwards."""
    import os

    import ray_tpu_torch

    out: Dict[str, Any] = {}
    prev_env = os.environ.get(module.ENV_FLAG)
    prev_enabled = module.enabled
    ncpu = min(4, max(2, os.cpu_count() or 1))
    n = max(1, int(800 * scale))

    def measure() -> float:
        noop = ray_tpu_torch.remote(_metadata={"inline": False})(_noop)
        ray_tpu_torch.get([noop.remote() for _ in range(10)], timeout=120)
        best = 0.0
        for _ in range(max(1, bursts)):
            t0 = time.perf_counter()
            ray_tpu_torch.get([noop.remote() for _ in range(n)],
                              timeout=300)
            best = max(best, n / (time.perf_counter() - t0))
        return round(best, 1)

    try:
        ray_tpu_torch.shutdown()
        module.enable()
        ray_tpu_torch.init(num_cpus=ncpu)
        out[f"tasks_per_s_{key}_on"] = measure()
        if on_cluster is not None:
            on_cluster(out)
        ray_tpu_torch.shutdown()
        module.disable()
        ray_tpu_torch.init(num_cpus=ncpu)
        out[f"tasks_per_s_{key}_off"] = measure()
    finally:
        ray_tpu_torch.shutdown()
        if prev_env is None:
            os.environ.pop(module.ENV_FLAG, None)
        else:
            os.environ[module.ENV_FLAG] = prev_env
        module.enabled = prev_enabled
    out[f"{key}_ratio"] = round(
        out[f"tasks_per_s_{key}_on"]
        / max(out[f"tasks_per_s_{key}_off"], 1e-9), 3)
    return out


def run_flight_overhead_bench(scale: float = 1.0,
                              bursts: int = 4) -> Dict[str, Any]:
    """Recorder-on vs recorder-off remote tasks/s: what the always-on
    flight recorder costs the task plane."""
    from ray_tpu_torch.core import flight

    return _on_off_bench(flight, "flight", scale, bursts)


def run_metrics_overhead_bench(scale: float = 1.0,
                               bursts: int = 4) -> Dict[str, Any]:
    """Metrics-pipeline-on vs -off remote tasks/s, and, from the ON
    cluster's raylets (`metrics_push_stats`), the structural invariant:
    one heartbeat interval carries at most one metrics push RPC per node
    (pushes <= intervals)."""
    from ray_tpu_torch.core import metrics_ts
    from ray_tpu_torch.core.worker import current_runtime

    def push_stats(out: Dict[str, Any]) -> None:
        stats = _raylet_calls(current_runtime(), "metrics_push_stats")
        out["push_pushes"] = sum(s.get("pushes", 0) for s in stats)
        out["push_intervals"] = sum(s.get("intervals", 0) for s in stats)
        out["push_nodes"] = len(stats)
        out["push_recorder_dropped"] = sum(
            s.get("recorder_dropped", 0) for s in stats)

    return _on_off_bench(metrics_ts, "metrics", scale, bursts, push_stats)


def format_attribution(attr: Dict[str, Any]) -> str:
    """Human table for `python -m ray_tpu_torch.perf --attribute`."""
    lines = [f"{'stage':28s} {'count':>8s} {'mean_us':>10s} "
             f"{'total_ms':>10s} {'max_us':>10s}"]
    for label, s in attr.items():
        if label == "wire_decode_bench":
            continue
        if "mean_us" not in s:
            # Dimensionless distribution (attribution.value — e.g.
            # lease.batch_size): mean/max in the sample's own units.
            lines.append(f"{label:28s} {s['count']:>8d} "
                         f"{s['mean']:>10.1f} {s['total']:>10.1f} "
                         f"{s['max']:>10.1f}")
            continue
        lines.append(f"{label:28s} {s['count']:>8d} {s['mean_us']:>10.1f} "
                     f"{s['total_ms']:>10.1f} {s['max_us']:>10.1f}")
    bench = attr.get("wire_decode_bench")
    if bench:
        lines.append(f"{'wire decode (validated)':28s} {'-':>8s} "
                     f"{bench['validated_us']:>10.2f}")
        lines.append(f"{'wire decode (fast path)':28s} {'-':>8s} "
                     f"{bench['fast_us']:>10.2f}")
    return "\n".join(lines)

def _dag_chain_bench(scale: float) -> Dict[str, Any]:
    """Compiled graphs vs the lazy DAG: the same 3-actor chain through
    `dag.execute` (3 actor tasks a call) and `experimental_compile`
    (persistent loops and channels; no per-call task plane), pipelined
    with a bounded in-flight window; then a 4 MB float32 array a call
    over a 2-stage compiled chain's `"array"` edges (blob-framed pushes),
    in MB/s end to end."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    get = ray_tpu_torch.get
    out: Dict[str, Any] = {}
    stage_cls = ray_tpu_torch.remote(num_cpus=0)(_ChainStage)
    stages = [stage_cls.remote() for _ in range(3)]
    get([s.step.remote(0) for s in stages], timeout=120)
    with InputNode() as inp:
        dag = stages[2].step.bind(
            stages[1].step.bind(stages[0].step.bind(inp)))
    n = max(1, int(200 * scale))

    t0 = time.perf_counter()
    get([dag.execute(i) for i in range(n)], timeout=600)
    dt = time.perf_counter() - t0
    out["dag_chain_calls_per_s"] = round(n / dt, 1)
    out["dag_chain_call_ms"] = round(dt / n * 1e3, 3)

    compiled = dag.experimental_compile(max_in_flight=16)
    get(compiled.execute(0), timeout=120)  # warm the loops
    t0 = time.perf_counter()
    refs = [compiled.execute(i) for i in range(n)]
    for r in refs:
        get(r, timeout=600)
    dt = time.perf_counter() - t0
    out["cgraph_calls_per_s"] = round(n / dt, 1)
    out["cgraph_call_ms"] = round(dt / n * 1e3, 3)
    out["cgraph_vs_dag_speedup"] = round(
        out["dag_chain_call_ms"] / max(out["cgraph_call_ms"], 1e-9), 1)
    compiled.teardown()

    with InputNode() as inp:
        adag = stages[1].echo.bind(
            stages[0].echo.bind(inp).with_channel("array")
        ).with_channel("array")
    acomp = adag.experimental_compile(max_in_flight=4)
    tensor = np.zeros(4 * 1024 * 1024 // 4, np.float32)
    get(acomp.execute(tensor), timeout=120)  # warm
    n = max(4, int(24 * scale))
    t0 = time.perf_counter()
    arefs = [acomp.execute(tensor) for _ in range(n)]
    for r in arefs:
        get(r, timeout=600)
    dt = time.perf_counter() - t0
    out["array_chan_MBps"] = round(n * tensor.nbytes / 1e6 / dt, 1)
    acomp.teardown()
    for s in stages:
        ray_tpu_torch.kill(s)
    return out


_PAGED_BENCH_MODELS: Dict[Any, Any] = {}


def _paged_bench_model(device: DeviceLike = None):
    from ray_tpu_torch.device import resolve_device

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
    p.add_argument("--local", action="store_true",
                   help="--microbench on the in-process runtime")
    p.add_argument("--attribute", action="store_true",
                   help="--microbench with the submit path profiled per "
                        "stage: the breakdown goes into the output JSON "
                        "and, as a table, to stderr")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--microbench", action="store_true",
                      help="the runtime microbenchmark (tasks/s, actor "
                           "calls/s, put/get 10 MB) on the host")
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
    mode.add_argument("--timeline", nargs="?",
                      const="ray_tpu_timeline.json", default=None,
                      metavar="FILE",
                      help="bracket a task burst with the flight recorder "
                           "and write the merged driver+raylet+worker "
                           "Chrome-trace JSON to FILE (default "
                           "ray_tpu_timeline.json); open in Perfetto")
    mode.add_argument("--flight-overhead", action="store_true",
                      help="recorder-on vs recorder-off remote tasks/s")
    mode.add_argument("--metrics-overhead", action="store_true",
                      help="metrics-pipeline-on vs -off remote tasks/s "
                           "plus each node's push and interval counters")
    args = p.parse_args()
    if args.microbench:
        result = run_microbench(local_mode=args.local, scale=args.scale,
                                attribute=args.attribute)
        print(json.dumps(result))
        if args.attribute:
            import sys

            print(format_attribution(result["attribution"]),
                  file=sys.stderr)
    elif args.timeline is not None:
        print(json.dumps(run_timeline_capture(path=args.timeline,
                                              scale=args.scale)))
    elif args.flight_overhead:
        print(json.dumps(run_flight_overhead_bench(scale=args.scale)))
    elif args.metrics_overhead:
        print(json.dumps(run_metrics_overhead_bench(scale=args.scale)))
    elif args.llm_serve:
        print(json.dumps(run_llm_serve_bench(scale=args.scale,
                                             device=args.device)))
    else:
        print(json.dumps(run_fleet_bench(scale=args.scale)))


if __name__ == "__main__":
    main()
