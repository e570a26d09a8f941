"""The port's benches (`ray_tpu_torch.perf`) against the reference's
(`ray_tpu.perf`) on the CPU: the same keys, and the counts that the
workload fixes equal. No timing is asserted. The runtime microbenchmark
runs on both of the port's runtimes (its cluster's processes are reaped
by `torch_cluster_helpers`).

Both paged sections run on a narrowed model (d_model 32, one layer, the
same weights on both sides) so the pair stays cheap here; the paged
workload, and with it every count, is the reference's. The bench's own
model (d_model 256) is checked for its configuration, and runs on the card
in chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.perf as jax_perf
import ray_tpu.serve.engine as jax_engine
import ray_tpu_torch.perf as perf
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu_torch.models import TransformerConfig, params_from_jax
from ray_tpu_torch.serve.engine import TransformerEngineModel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_cluster_helpers import no_leaked_port_processes  # noqa: E402,F401

SCALE = 0.1
NARROW = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, d_ff=32,
              max_seq_len=256)


@pytest.fixture(scope="module")
def benches():
    jparams = jax_init_params(jax.random.PRNGKey(0),
                              JaxConfig(dtype=jnp.float32, **NARROW))
    port_model = TransformerEngineModel(
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        TransformerConfig(dtype=torch.float32, **NARROW), "cpu")
    ref_model = jax_engine.TransformerEngineModel(
        jparams, JaxConfig(dtype=jnp.float32, **NARROW), max_batch_size=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(perf, "_paged_bench_model", lambda device=None: port_model)
        mp.setattr(jax_perf, "_paged_bench_model", lambda: ref_model)
        return dict(
            llm=perf.run_llm_serve_bench(scale=SCALE, device="cpu"),
            ref_llm=jax_perf.run_llm_serve_bench(scale=SCALE),
            fleet=perf.run_fleet_bench(scale=SCALE),
            ref_fleet=jax_perf.run_fleet_bench(scale=SCALE))


@pytest.fixture(scope="module")
def ref_microbench_keys():
    import ray_tpu

    try:
        return set(jax_perf.run_microbench(local_mode=True, scale=0.05))
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("local_mode", [False, True])
def test_microbench_keys_equal_reference(ref_microbench_keys, local_mode):
    out = perf.run_microbench(local_mode=local_mode, scale=0.05)
    assert set(out) == ref_microbench_keys
    assert out["mode"] == ("local" if local_mode else "cluster")
    assert out["tasks_per_s"] > 0 and out["actor_calls_per_s"] > 0
    for key in ("dag_chain_calls_per_s", "dag_chain_call_ms",
                "cgraph_calls_per_s", "cgraph_call_ms",
                "cgraph_vs_dag_speedup", "array_chan_MBps"):
        assert isinstance(out[key], float) and out[key] > 0, (key, out[key])


@pytest.mark.parametrize("bench", ["llm", "fleet"])
def test_bench_keys_equal_reference(benches, bench):
    assert set(benches[bench]) == set(benches[f"ref_{bench}"])


@pytest.mark.parametrize("key", ["llm_engine_steps", "llm_static_steps",
                                 "llm_prefix_hit_tokens",
                                 "llm_prefix_cow_copies", "llm_paged_steps",
                                 "llm_paged_parity",
                                 "llm_paged_host_gathers"])
def test_llm_serve_counts_equal_reference(benches, key):
    assert benches["llm"][key] == benches["ref_llm"][key]


def test_llm_serve_structure(benches):
    llm = benches["llm"]
    assert llm["llm_paged_parity"] == 1
    assert llm["llm_paged_host_gathers"] == 0
    assert llm["llm_paged_steps"] > 0
    assert llm["llm_prefix_hit_tokens"] > 0
    assert llm["llm_overload_served"] > 0


def test_fleet_counts(benches):
    fleet, ref = benches["fleet"], benches["ref_fleet"]
    assert fleet["fleet_prefix_ships"] >= 1
    assert fleet["fleet_prefix_ship_tokens"] >= 80
    assert fleet["fleet_lost_conversations"] == 0
    assert fleet["fleet_recoveries"] == ref["fleet_recoveries"] == 1
    assert fleet["fleet_remote_warm_ttft_p50_ms"] is not None


def test_paged_bench_model_is_the_reference_config():
    model = perf._paged_bench_model("cpu")
    assert perf._paged_bench_model("cpu") is model
    assert model.device == torch.device("cpu")
    assert model.kv_token_shape == (2, 2, 8, 32)   # head_dim 32: plain
    assert model.vocab_size == 128
    assert model._params["embed"].shape == (128, 256)


def test_cli_prints_one_json_object(monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.perf", "--fleet", "--scale",
         str(SCALE)], capture_output=True, text=True, timeout=120,
        check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["fleet_lost_conversations"] == 0
    monkeypatch.setattr(sys, "argv", ["perf"])      # no bench named
    with pytest.raises(SystemExit):
        perf.main()


# ---------------------------------------------------------------------------
# The observability benches: wire decode, attribution, timeline, overheads
# ---------------------------------------------------------------------------
OVERHEAD = dict(scale=0.02, bursts=1)
REF_OBSERVABILITY = """
import json, sys
import ray_tpu.perf as p
out = dict(wire=p.wire_decode_bench(200),
           flight=p.run_flight_overhead_bench(**OVERHEAD),
           metrics=p.run_metrics_overhead_bench(**OVERHEAD),
           timeline=p.run_timeline_capture(sys.argv[1], scale=0.05))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_observability(tmp_path_factory):
    """The reference's benches, in a child interpreter (its clusters, like
    the port's, are the child's own) while the port's run here."""
    path = str(tmp_path_factory.mktemp("ref_timeline") / "trace.json")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"OVERHEAD = {OVERHEAD!r}\n" + REF_OBSERVABILITY, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def ref_result(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_observability_benches_equal_reference(ref_observability, tmp_path):
    flags = ("RAY_TPU_FLIGHT_RECORDER", "RAY_TPU_METRICS_PIPELINE")
    before = {flag: os.environ.get(flag) for flag in flags}
    timeline = perf.run_timeline_capture(str(tmp_path / "trace.json"),
                                         scale=0.05)
    flight = perf.run_flight_overhead_bench(**OVERHEAD)
    metrics = perf.run_metrics_overhead_bench(**OVERHEAD)
    ref = ref_result(ref_observability)
    wire = perf.wire_decode_bench(200)
    assert list(wire) == list(ref["wire"]) == ["validated_us", "fast_us"]
    assert all(v > 0 for v in wire.values())
    assert list(flight) == list(ref["flight"])
    assert list(metrics) == list(ref["metrics"])
    assert flight["tasks_per_s_flight_on"] > 0 < flight["flight_ratio"]
    # One node; at most one metrics push per heartbeat interval.
    assert metrics["push_nodes"] == ref["metrics"]["push_nodes"] == 1
    assert metrics["push_pushes"] <= metrics["push_intervals"]
    assert list(timeline) == list(ref["timeline"])
    assert timeline["timeline_roles"] == ref["timeline"]["timeline_roles"] \
        == ["driver", "raylet", "worker"]
    assert {"task", "lease"} <= set(timeline["timeline_categories"])
    with open(timeline["timeline_path"]) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) >= timeline["timeline_events"] > 0
    # The benches leave the flags as they found them.
    assert {flag: os.environ.get(flag) for flag in flags} == before


ATTRIBUTION = {
    "submit.encode": {"count": 183, "mean_us": 64.04, "total_ms": 11.72,
                      "max_us": 6213.4},
    "lease.batch_size": {"count": 5, "mean": 1.0, "total": 5.0, "max": 1.0},
    "worker.exec": {"count": 1234567, "mean_us": 0.04, "total_ms": 49.4,
                    "max_us": 1e6},
    "wire_decode_bench": {"validated_us": 11.25, "fast_us": 3.46},
}


@pytest.mark.parametrize("drop_bench", [False, True])
def test_format_attribution_equals_reference(drop_bench):
    attr = dict(ATTRIBUTION)
    if drop_bench:
        attr.pop("wire_decode_bench")
    assert perf.format_attribution(attr) == jax_perf.format_attribution(attr)


def test_microbench_attribute_folds_driver_and_workers():
    out = perf.run_microbench(scale=0.05, attribute=True)
    attr = out["attribution"]
    assert list(attr["wire_decode_bench"]) == ["validated_us", "fast_us"]
    for label in ("submit.remote", "submit.encode", "submit.push_rtt",
                  "worker.exec", "worker.decode"):
        assert attr[label]["count"] > 0, label
    table = perf.format_attribution(attr)
    assert table.splitlines()[0].split() == ["stage", "count", "mean_us",
                                             "total_ms", "max_us"]
    assert "wire decode (fast path)" in table
    assert "RAY_TPU_ATTRIBUTION" not in os.environ
