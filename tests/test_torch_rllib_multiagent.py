"""The port's multi-agent RLlib (`rllib/env/multi_agent_env.py`,
`rllib/algorithms/multi_agent_ppo.py`) against the JAX package's, on the
CPU: the multi-agent runner beside the reference's, built in this
process from the same weights and seed, and multi-agent PPO's learning
tests on the port's cluster.

The env, the mapping functions and the module factories live in
`tests/torch_rllib_helpers.py`: the port sends them to its runner actors
by reference. Tolerances: the runners' forward passes are float32 on
both sides and differ only in summation order (some 1e-7 relative); GAE
runs in numpy over those values.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_rllib_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.env import multi_agent_env as jma  # noqa: E402
from ray_tpu_torch import rllib  # noqa: E402
from ray_tpu_torch.rllib.algorithms import multi_agent_ppo as tmappo  # noqa: E402,E501
from ray_tpu_torch.rllib.env import multi_agent_env as tma  # noqa: E402

# Values, log-probabilities and the GAE over them: float32 forward passes
# that differ by summation order only.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mapping,env", [
    ("shared", "TargetMatch"),
    ("by_agent", "TargetMatch"),
    ("by_agent", "truncating_target_match"),
], ids=["shared", "independent", "independent-truncated"])
def test_runner_matches_the_references(mapping, env):
    """The same actions and observations, and per-policy batches within
    tolerance, over two fragments of 20 steps that end episodes mid
    fragment (terminated, or truncated with V of the final observation
    bootstrapped)."""
    mapping_fn = getattr(helpers, mapping)
    env_creator = getattr(helpers, env)
    pids = sorted({mapping_fn(a) for a in helpers.TargetMatch.possible_agents})
    weights = {}
    for i, pid in enumerate(pids):
        w = {k: np.asarray(v) for k, v in helpers.jax_module_factory().init(
            jax.random.PRNGKey(10 + i)).items()}
        # The policy head at the trunk's scale, so the actions depend on
        # the weights (the reference's 0.01 head samples near-uniformly).
        w["pi_w_out"] = w["pi_w_out"] * 100
        weights[pid] = w
    conf = {"gamma": 0.9, "lam": 0.8}
    want_runner = jma.MultiAgentEnvRunner(
        env_creator, {p: helpers.jax_module_factory for p in pids},
        mapping_fn, conf, seed=7)
    runner = tma.MultiAgentEnvRunner(
        env_creator, {p: helpers.port_module_factory for p in pids},
        mapping_fn, dict(conf, num_threads=1), seed=7)
    assert want_runner.set_weights(weights) and runner.set_weights(weights)
    for _ in range(2):
        want, got = want_runner.sample(20), runner.sample(20)
        np.testing.assert_array_equal(got["episode_returns"],
                                      want["episode_returns"])
        assert len(got["episode_returns"]) > 0
        assert sorted(got["batches"]) == sorted(want["batches"]) == pids
        for pid in pids:
            g, w = got["batches"][pid], want["batches"][pid]
            assert set(g) == set(w)
            for k in ("obs", "actions"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("logp_old", "advantages", "value_targets"):
                np.testing.assert_allclose(g[k], w[k], **FWD_TOL, err_msg=k)
                assert g[k].dtype == w[k].dtype
    # The shared policy batches both agents' steps together.
    rows = sum(len(b["actions"]) for b in got["batches"].values())
    assert rows == 2 * 20


def test_truncation_bootstraps_the_final_value():
    """A fragment of exactly one episode: where it ends by truncation,
    each agent's stream closes with V of its final observation; where it
    terminates, with 0."""
    weights = {"shared": helpers.port_module_factory().get_weights()}
    for env, truncated in ((helpers.truncating_target_match, True),
                           (helpers.TargetMatch, False)):
        runner = tma.MultiAgentEnvRunner(
            env, {"shared": helpers.port_module_factory}, helpers.shared,
            {"gamma": 0.5, "lam": 1.0}, seed=1)
        runner.set_weights(weights)
        closed = []
        close = runner._close_stream

        def record(aid, stream, last_value, batches):
            closed.append((stream.done, last_value))
            close(aid, stream, last_value, batches)

        runner._close_stream = record
        runner.sample(runner.env._episode_len)
        assert len(closed) == 2
        for done, last_value in closed:
            assert done == (not truncated)
            assert (last_value != 0.0) == truncated


def test_default_mapping_and_device_rule():
    config = rllib.MultiAgentPPOConfig(
        env_creator=helpers.TargetMatch,
        policies={"shared": helpers.port_module_factory})
    assert config.policy_mapping_fn is tmappo.shared_policy
    assert config.policy_mapping_fn("agent_7") == "shared"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.build()


def test_config_without_policies_or_env_raises():
    with pytest.raises(ValueError, match="policies is empty"):
        rllib.MultiAgentPPOConfig(env_creator=helpers.TargetMatch,
                                  device="cpu").build()
    with pytest.raises(ValueError, match="env_creator is required"):
        rllib.MultiAgentPPOConfig(
            policies={"shared": helpers.port_module_factory},
            device="cpu").build()


# ---------------------------------------------------------------------------
# On the port's cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_cluster():
    niced(lambda: ray_tpu_torch.init(num_cpus=4))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _alive_runners():
    from ray_tpu_torch.util.state import list_actors

    return [a for a in list_actors()
            if a.get("class_name") == "MultiAgentEnvRunner"
            and a.get("state") == "ALIVE"]


@pytest.mark.parametrize("field,value", [
    ("policy_mapping_fn", lambda aid: "shared"),
    ("env_creator", lambda: helpers.TargetMatch()),
    ("policies", {"shared": lambda: helpers.port_module_factory()}),
], ids=["mapping", "env", "policy"])
def test_a_lambda_raises_before_any_actor_starts(port_cluster, field, value):
    kwargs = dict(env_creator=helpers.TargetMatch,
                  policies={"shared": helpers.port_module_factory},
                  policy_mapping_fn=helpers.shared, device="cpu")
    kwargs[field] = value
    before = len(_alive_runners())
    with pytest.raises(TypeError, match="module-level"):
        rllib.MultiAgentPPOConfig(**kwargs).build()
    assert len(_alive_runners()) == before


def test_shared_policy_trains(port_cluster):
    """The reference's test (test_rllib_multiagent.py): random play earns
    2 agents x 8 steps x 1/4 = 4.0, a learned shared policy nears 16."""
    algo = rllib.MultiAgentPPOConfig(
        env_creator=helpers.TargetMatch,
        policies={"shared": helpers.port_module_factory},
        policy_mapping_fn=helpers.shared,
        num_env_runners=2, rollout_fragment_length=64,
        lr=0.02, num_epochs=6, entropy_coeff=0.005, seed=0, device="cpu",
    ).build()
    try:
        best = 0.0
        for _ in range(12):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
        assert best > 9.0, f"shared policy failed to learn (best {best})"
        assert result["num_env_steps_sampled_lifetime"] == 12 * 2 * 2 * 64
    finally:
        algo.stop()


def test_independent_policies_train_and_diverge(port_cluster):
    algo = rllib.MultiAgentPPOConfig(
        env_creator=helpers.TargetMatch,
        policies={"p0": helpers.port_module_factory,
                  "p1": helpers.port_module_factory},
        policy_mapping_fn=helpers.by_agent,
        num_env_runners=2, rollout_fragment_length=64,
        lr=0.02, num_epochs=6, entropy_coeff=0.005, seed=0, device="cpu",
    ).build()
    try:
        assert len(_alive_runners()) == 2
        best = 0.0
        for _ in range(12):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            assert "learner/p0/total_loss" in result
            assert "learner/p1/total_loss" in result
        assert best > 9.0, f"independent policies stuck at {best}"
        w0 = algo.learners["p0"].get_weights()
        w1 = algo.learners["p1"].get_weights()
        assert max(float(np.abs(w0[k] - w1[k]).max()) for k in w0) > 1e-3
    finally:
        algo.stop()
    assert _alive_runners() == []
