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
