"""The port's RLlib (`ray_tpu_torch/rllib/`) and MLP against the JAX
package's, on the CPU: the MLP, the MLP RL module, `ppo_loss` and its
gradients, `PPOLearner.update` (Adam against optax), GAE, the env runner,
the learner group over gloo and a PPO iteration on the port's cluster.

Weights cross from JAX through `module_params_from_jax`; inputs come from
numpy seeds. Tolerances: both sides compute in float32 and differ only
in summation order (some 1e-7 relative); Adam divides each step by the
gradient's running RMS, which carries such differences into the weights
at the scale of a few ulps of the step.
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_cluster_helpers import (ROOT, niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import mlp as jmlp  # noqa: E402
from ray_tpu.rllib.core import learner as jlearner  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu.rllib.env import env_runner as jrunner  # noqa: E402
from ray_tpu_torch import rllib  # noqa: E402
from ray_tpu_torch.models import mlp as tmlp  # noqa: E402
from ray_tpu_torch.rllib.core import learner as tlearner  # noqa: E402
from ray_tpu_torch.rllib.core import learner_group as tgroup  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.env import env_runner as trunner  # noqa: E402

# Forward values and gradients: float32 on both sides, summation order
# only.
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
# Weights after several Adam steps from the same start.
ADAM_TOL = dict(rtol=1e-5, atol=2e-6)
# Every get and join in this file.
TIMEOUT_S = 120


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _ppo_batch(seed: int, n: int, obs_dim: int = 4, num_actions: int = 2):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": (3 * rng.normal(size=n)).astype(np.float32),
    }


def test_mlp_forward_matches_jax():
    cfg = jmlp.MLPConfig(in_dim=12, hidden=(16, 8), out_dim=5)
    jparams = jmlp.mlp_init(jax.random.PRNGKey(0), cfg)
    tparams = tmlp.mlp_init(torch.Generator().manual_seed(0),
                            tmlp.MLPConfig(12, (16, 8), 5), device="cpu")
    assert [{k: v.shape for k, v in layer.items()} for layer in jparams] \
        == [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in tparams]
    x = np.random.default_rng(1).normal(size=(9, 12)).astype(np.float32)
    want = np.asarray(jmlp.mlp_forward(jparams, x))
    got = tmlp.mlp_forward([{k: torch.from_numpy(np.asarray(v))
                             for k, v in layer.items()}
                            for layer in jparams], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("share", [False, True], ids=["separate", "shared"])
def test_mlp_module_apply_matches_jax(share):
    """Names and layouts are the reference's; JAX's weights give JAX's
    logits and values."""
    jmod = jrm.DiscreteMLPModule(obs_dim=6, num_actions=3, hiddens=(16, 8),
                                 vf_share_layers=share)
    jparams = jmod.init(jax.random.PRNGKey(3))
    tmod = trm.DiscreteMLPModule(6, 3, (16, 8), vf_share_layers=share)
    assert {k: v.shape for k, v in jparams.items()} == {
        k: tuple(v.shape) for k, v in tmod.params().items()}
    trm.module_params_from_jax(jparams, tmod)
    for k, v in tmod.get_weights().items():
        np.testing.assert_array_equal(v, np.asarray(jparams[k]))
    obs = np.random.default_rng(2).normal(size=(32, 6)).astype(np.float32)
    want_logits, want_value = jmod.apply(jparams, obs)
    with torch.no_grad():
        logits, value = tmod(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **FWD_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               **FWD_TOL)


def test_module_init_scales_are_the_references():
    """Each parameter's empirical scale against the reference's rule:
    He normal trunks, 0.01 policy head, 1.0 separate value head."""
    mod = trm.DiscreteMLPModule(64, 4, (256, 256),
                                generator=torch.Generator().manual_seed(0))
    w = mod.get_weights()
    for name, want in (("pi_w0", (2 / 64) ** 0.5),
                       ("pi_w1", (2 / 256) ** 0.5), ("pi_w_out", 0.01),
                       ("vf_w_out", 1.0)):
        assert abs(w[name].std() / want - 1) < 0.1, name
    assert not any(w[name].any() for name in w if "_b" in name)
    again = trm.DiscreteMLPModule(
        64, 4, (256, 256), generator=torch.Generator().manual_seed(0))
    for k, v in again.get_weights().items():
        np.testing.assert_array_equal(v, w[k])


def test_ppo_loss_and_gradients_match_jax():
    """`ppo_loss` and its gradient on every parameter against
    `jax.value_and_grad`; vf_clip 1.0 caps part of the value errors."""
    jmod = jrm.DiscreteMLPModule(obs_dim=4, num_actions=2, hiddens=(16, 16))
    jparams = jmod.init(jax.random.PRNGKey(0))
    tmod = trm.module_params_from_jax(
        jparams, trm.DiscreteMLPModule(4, 2, (16, 16)))
    batch = _ppo_batch(0, 64)
    kw = dict(clip_param=0.2, vf_coeff=0.5, entropy_coeff=0.01, vf_clip=1.0)
    (want, want_stats), grads = jax.value_and_grad(
        lambda p: jlearner.ppo_loss(jmod, p, batch, **kw),
        has_aux=True)(jparams)
    total, stats = tlearner.ppo_loss(
        tmod, tlearner.to_device(batch, torch.device("cpu")), **kw)
    total.backward()
    np.testing.assert_allclose(float(total), float(want), **FWD_TOL)
    for k, v in want_stats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **FWD_TOL)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[name]),
                                   **FWD_TOL, err_msg=name)


def test_ppo_learner_update_matches_jax():
    """Two epochs of three minibatches (six Adam steps) from JAX's initial
    weights: the numpy permutation makes the same minibatches, and
    torch's Adam takes optax's steps."""
    config = {"lr": 3e-4, "num_epochs": 2, "minibatch_size": 32,
              "seed": 0, "entropy_coeff": 0.01}
    jmod = jrm.DiscreteMLPModule(obs_dim=4, num_actions=2, hiddens=(16, 16))
    jl = jlearner.PPOLearner(jmod, config)
    tl = tlearner.PPOLearner(trm.DiscreteMLPModule(4, 2, (16, 16)),
                             dict(config, device="cpu"))
    start = jl.get_weights()
    tl.set_weights(start)
    batch = _ppo_batch(1, 96)
    want_stats = jl.update(batch)
    stats = tl.update(batch)
    want, got = jl.get_weights(), tl.get_weights()
    moved = max(np.abs(want[k] - start[k]).max() for k in want)
    assert moved > 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **ADAM_TOL, err_msg=k)
    assert set(stats) == set(want_stats)
    for k in stats:
        np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_learner_device_none_means_the_card():
    """`device=None` puts the learner on cuda:0; without a card it
    raises rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        learner = tlearner.PPOLearner(trm.DiscreteMLPModule(4, 2, (8,)), {})
        assert learner.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlearner.PPOLearner(trm.DiscreteMLPModule(4, 2, (8,)), {})


def _rollout(seed: int, T: int = 12, n: int = 3):
    rng = np.random.default_rng(seed)
    trunc = np.zeros((T, n), np.float32)
    trunc[4, 1] = 0.7
    return {
        "rewards": rng.normal(size=(T, n)).astype(np.float32),
        "values": rng.normal(size=(T, n)).astype(np.float32),
        "dones": (rng.random((T, n)) < 0.2).astype(np.float32),
        "obs": rng.normal(size=(T, n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, n)).astype(np.int32),
        "logp_old": rng.normal(size=(T, n)).astype(np.float32),
        "last_values": rng.normal(size=(n,)).astype(np.float32),
        "trunc_values": trunc,
    }


def test_compute_gae_and_concat_batches_bit_for_bit():
    for seed in range(3):
        r = _rollout(seed)
        want = jrunner.compute_gae(r, 0.99, 0.95)
        got = trunner.compute_gae(r, 0.99, 0.95)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    parts = [trunner.compute_gae(_rollout(s), 0.9, 0.8) for s in range(3)]
    want = jrunner.concat_batches(parts)
    got = trunner.concat_batches(parts)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_env_runner_matches_the_references():
    """The reference's runner and the port's, built in this process from
    the same weights and seed on CartPole cut at 20 steps (so that time
    limits truncate episodes mid-fragment): the same actions and
    observations, and every buffer within tolerance."""
    import gymnasium as gym

    env_creator = functools.partial(gym.make, "CartPole-v1",
                                    max_episode_steps=20)
    jmodule = functools.partial(jrm.DiscreteMLPModule, obs_dim=4,
                                num_actions=2, hiddens=(16,))
    tmodule = functools.partial(trm.DiscreteMLPModule, obs_dim=4,
                                num_actions=2, hiddens=(16,))
    weights = _np(jmodule().init(jax.random.PRNGKey(5)))
    # The policy head at the trunk's scale, so the actions depend on the
    # weights (the reference's 0.01 head samples near-uniformly).
    weights["pi_w_out"] = weights["pi_w_out"] * 100
    want_runner = jrunner.SingleAgentEnvRunner(
        env_creator, jmodule, {"num_envs_per_runner": 3}, seed=7)
    runner = trunner.SingleAgentEnvRunner(
        env_creator, tmodule, {"num_envs_per_runner": 3}, seed=7)
    assert want_runner.set_weights(weights) and runner.set_weights(weights)
    for _ in range(2):
        want, got = want_runner.sample(40), runner.sample(40)
        assert set(got) == set(want)
        assert len(got["trunc_t"]) > 0
        for k in ("actions", "obs", "rewards", "dones", "terminateds",
                  "final_obs", "trunc_t", "trunc_env", "trunc_obs",
                  "episode_returns"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("logp_old", "values", "last_values", "trunc_values"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       **FWD_TOL, err_msg=k)
            assert got[k].dtype == np.asarray(want[k]).dtype


# The names of DQN, the replay buffers, the multi-agent env and multi-agent
# PPO.
ITEM_8B = ("DQN", "DQNConfig", "DQNLearner", "ReplayBuffer",
           "PrioritizedReplayBuffer", "ReservoirReplayBuffer",
           "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
           "MultiAgentPPOConfig")


@pytest.mark.parametrize("name", ITEM_8B)
def test_item_8b_names_are_the_ports_classes(name):
    """Each name resolves to the port's class in the module that mirrors
    the one where the reference defines it."""
    import importlib

    import ray_tpu.rllib

    want = getattr(ray_tpu.rllib, name)
    module = importlib.import_module(
        "ray_tpu_torch" + want.__module__[len("ray_tpu"):])
    got = getattr(rllib, name)
    assert got is getattr(module, name)
    assert got.__module__ == module.__name__
    assert isinstance(got, type) and got is not want


def test_exports_are_the_references():
    import ray_tpu.rllib

    assert rllib.__all__ == ray_tpu.rllib.__all__
    for name in rllib.__all__:
        assert getattr(rllib, name) is not None
    assert not hasattr(rllib, "LATER")


def test_cartpole_without_gymnasium_names_the_package(monkeypatch):
    for name in list(sys.modules):
        if name == "gymnasium" or name.startswith("gymnasium."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="gymnasium"):
        rllib.PPOConfig(device="cpu").build()
    with pytest.raises(ImportError, match="gymnasium"):
        rllib.IMPALAConfig(device="cpu").build()


# ---------------------------------------------------------------------------
# On the port's cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_cluster():
    niced(lambda: ray_tpu_torch.init(num_cpus=6))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def test_learner_group_two_gloo_learners_take_one_jax_adam_step(
        port_cluster):
    """Two remote learners (a gloo gang): after one update of one epoch
    over whole shards both hold the same weights, and those are one JAX
    Adam step of `ppo_loss` on the batch with each shard's advantages
    normalised on their own, from the group's initial weights."""
    import optax

    config = {"lr": 1e-3, "num_epochs": 1, "seed": 0, "device": "cpu",
              "entropy_coeff": 0.01, "minibatch_size": None}
    factory = functools.partial(trm.DiscreteMLPModule, obs_dim=4,
                                num_actions=2, hiddens=(8,))
    group = tgroup.LearnerGroup(factory, config, num_learners=2)
    try:
        start = group.get_weights()
        batch = _ppo_batch(2, 32)
        stats = group.update(batch)
        assert np.isfinite(stats["total_loss"])
        per_learner = ray_tpu_torch.get(
            [w.execute.remote(tgroup._learner_weights)
             for w in group._workers], timeout=TIMEOUT_S)
    finally:
        group.shutdown()
    for k in per_learner[0]:
        np.testing.assert_array_equal(per_learner[0][k], per_learner[1][k])

    halves = [{k: v[i * 16:(i + 1) * 16] for k, v in batch.items()}
              for i in range(2)]
    for h in halves:
        adv = h["advantages"]
        h["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
    whole = {k: np.concatenate([h[k] for h in halves]) for k in batch}
    jmod = jrm.DiscreteMLPModule(obs_dim=4, num_actions=2, hiddens=(8,))
    params = {k: jax.numpy.asarray(v) for k, v in start.items()}
    (_, want_stats), grads = jax.value_and_grad(
        lambda p: jlearner.ppo_loss(jmod, p, whole, clip_param=0.2,
                                    vf_coeff=0.5, entropy_coeff=0.01,
                                    vf_clip=10.0), has_aux=True)(params)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = _np(optax.apply_updates(params, updates))
    for k in want:
        np.testing.assert_allclose(per_learner[0][k], want[k], **ADAM_TOL,
                                   err_msg=k)
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k], float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_remote_runner_samples_with_synced_weights(port_cluster):
    """A runner actor returns the reference's fragment shapes and takes
    a weight push (reference: test_rllib.py:114)."""
    import gymnasium as gym

    factory = functools.partial(trm.DiscreteMLPModule, obs_dim=4,
                                num_actions=2, hiddens=(8,))
    runner = ray_tpu_torch.remote(num_cpus=1)(
        trunner.SingleAgentEnvRunner).remote(
            functools.partial(gym.make, "CartPole-v1"), factory,
            {"num_envs_per_runner": 2, "num_threads": 1}, seed=7)
    try:
        weights = factory(generator=torch.Generator().manual_seed(3)
                          ).get_weights()
        assert ray_tpu_torch.get(runner.set_weights.remote(weights),
                                 timeout=TIMEOUT_S)
        frag = ray_tpu_torch.get(runner.sample.remote(16),
                                 timeout=TIMEOUT_S)
    finally:
        ray_tpu_torch.kill(runner)
    assert frag["obs"].shape == (16, 2, 4)
    assert frag["actions"].shape == (16, 2)
    assert frag["last_values"].shape == (2,)


def test_ppo_iteration_end_to_end(port_cluster):
    """Two `train()` iterations on CartPole: sample -> GAE -> update ->
    sync, with the reference's metric keys."""
    algo = rllib.PPOConfig(num_env_runners=2, num_envs_per_runner=2,
                           rollout_fragment_length=16, num_epochs=2,
                           minibatch_size=32, device="cpu").build()
    try:
        m = algo.train()
        assert m["training_iteration"] == 1
        assert m["num_env_steps_sampled_lifetime"] == 2 * 2 * 16
        assert np.isfinite(m["learner/total_loss"])
        assert {"episode_return_mean", "env_steps_per_sec",
                "time_sample_s", "time_learn_s", "learner/vf_loss",
                "learner/mean_kl"} <= set(m)
        m2 = algo.train()
        assert m2["training_iteration"] == 2
    finally:
        algo.stop()


@pytest.mark.slow
def test_ppo_cartpole_learns(port_cluster):
    """The reference's learning test (test_rllib.py:199): PPO reaches a
    mean return of 450 on CartPole-v1."""
    algo = rllib.PPOConfig(num_env_runners=2, num_envs_per_runner=8,
                           rollout_fragment_length=64, lr=1e-3,
                           num_epochs=8, minibatch_size=256,
                           entropy_coeff=0.0, device="cpu").build()
    try:
        best = 0.0
        for _ in range(100):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best >= 450:
                break
        assert best >= 450, f"PPO failed to learn CartPole: best={best}"
    finally:
        algo.stop()
