"""Serve on the port's cluster runtime against Serve on the JAX package's
cluster runtime: replicas are worker processes, the HTTP proxy answers
with the reference's bytes, a rolling update and a replica's SIGKILL lose
no request, the controller recovers from its checkpoint after a SIGKILL
under HTTP traffic with zero failed requests, a replica process streams
the small transformer's tokens as the JAX engine does, and shutdown
leaves no process.

The port's cluster runs in this process's driver, started once for the
module; the reference's runs the same scenarios
(`torch_cluster_helpers.serve_scenarios`) in a child interpreter at the
same time.
"""

import concurrent.futures
import os
import sys

import jax
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402

pytestmark = pytest.mark.unit

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)


@pytest.fixture(scope="module")
def reference():
    future = _POOL.submit(helpers.run_reference, "serve")
    yield future
    future.result()


@pytest.fixture(scope="module")
def port_cluster(reference):
    rt = helpers.start(ray_tpu_torch)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port_cluster):
    return helpers.serve_scenarios(ray_tpu_torch)


def _comparable(out: dict, key: str):
    """A result with the run's own counts of successes dropped (they
    follow the host's speed); failures stay."""
    value = out[key]
    if key in ("update", "controller_kill"):
        return value["failed"]
    return value


SERVE_KEYS = ["replica_processes", "replica_pid_is_driver", "http_bytes",
              "handle", "update", "update_served_v2", "replaced",
              "after_replace", "controller_kill", "recovered_replicas",
              "recovered_pid_differs", "after_recovery_update"]


@pytest.mark.parametrize("key", SERVE_KEYS)
def test_serve_matches_reference(key, port_results, reference):
    assert _comparable(port_results, key) == _comparable(reference.result(),
                                                         key)


def test_serve_scenarios_say_what_they_should(port_results):
    out = port_results
    assert out["replica_processes"] == 2 and not out["replica_pid_is_driver"]
    assert out["http_bytes"] == ('{"tag": "v1", "echo": {"a": [1, 2.5, '
                                 '"x"]}}')
    assert out["update"]["failed"] == 0 and out["update"]["ok"] > 0, \
        out["update"]
    assert out["controller_kill"]["failed"] == 0 and \
        out["controller_kill"]["ok"] > 0, out["controller_kill"]
    assert out["replaced"] == 1 and out["recovered_pid_differs"]
    assert out["recovered_replicas"] == ["RUNNING", "RUNNING"]


# ---------------------------------------------------------------------------
# The small transformer in a replica process
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128)
ENGINE = dict(max_batch_size=4, block_size=8, num_blocks=32)
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(2, 64, n)]
           for s, n in ((1, 5), (2, 17), (3, 9))]
NEW = 8


def test_transformer_replica_process_streams_jax_engine_tokens(
        port_results):
    import jax.numpy as jnp

    import ray_tpu.serve.engine as jax_engine
    from ray_tpu.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch import serve

    jcfg = TransformerConfig(dtype=jnp.float32, **TINY)
    jparams = init_params(jax.random.PRNGKey(0), jcfg)
    want = []
    for prompt in PROMPTS:
        eng = jax_engine.InferenceEngine(
            jax_engine.TransformerEngineModel(jparams, jcfg),
            jax_engine.EngineConfig(**ENGINE))
        stream = eng.submit(prompt, NEW)
        while eng.step():
            pass
        want.append(stream.tokens_so_far())

    np_params = jax.tree.map(np.asarray, jparams)
    port = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    try:
        handle = serve.run(
            serve.deployment(helpers.TinyLLM).bind(np_params, TINY, ENGINE),
            name="tiny", route_prefix="/tiny")
        pid = handle.options(method_name="pid").remote().result(
            timeout_s=60)
        streamed = [list(handle.options(stream=True, method_name="generate")
                         .remote({"prompt": p, "max_new_tokens": NEW}))
                    for p in PROMPTS]
    finally:
        serve.shutdown()
    assert pid != os.getpid() and port > 0
    assert all(type(t) is int for s in streamed for t in s)
    assert streamed == want


def test_compile_deployment_chain_matches_the_routed_handles(port_results):
    """tests/test_serve.py's compiled deployment chain, on replica
    processes: one pinned replica of each deployment, channels between
    them, the routed path's answers, and the routed path still serving
    after the compiled graph's teardown."""
    import torch_cgraph_helpers as cg

    from ray_tpu_torch import serve

    serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    try:
        serve.run(serve.deployment(cg.Doubler).bind(), name="d",
                  route_prefix="/double")
        serve.run(serve.deployment(cg.Biaser).bind(), name="b",
                  route_prefix="/bias")
        compiled = serve.compile_deployment_chain(["Doubler", "Biaser"])
        try:
            assert ray_tpu_torch.get(compiled.execute(5), timeout=60) == 13
            d = serve.get_deployment_handle("Doubler")
            b = serve.get_deployment_handle("Biaser")
            assert b.remote(d.remote(5).result(timeout_s=60)).result(
                timeout_s=60) == 13
            refs = [compiled.execute(i) for i in range(20)]
            assert [ray_tpu_torch.get(r, timeout=60) for r in refs] \
                == [i * 2 + 3 for i in range(20)]
        finally:
            compiled.teardown()
        d = serve.get_deployment_handle("Doubler")
        assert d.remote(4).result(timeout_s=60) == 8
        serve.delete("Doubler")
        serve.delete("Biaser")
    finally:
        serve.shutdown()


def test_shutdown_leaves_no_process(port_cluster):
    """The last test: the cluster's own shutdown ends every process of
    the port within the grace period."""
    assert helpers.port_processes()
    ray_tpu_torch.shutdown()
    assert helpers.wait_no_port_processes() == []
