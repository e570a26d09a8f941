"""The port's IMPALA/APPO (`ray_tpu_torch/rllib/core/impala_learner.py`,
`algorithms/impala.py`) against the JAX package's, on the CPU: V-trace
with episodes ending mid-fragment, the V-trace loss and its gradients in
both policy terms (IMPALA's and APPO's clipped surrogate), learner
updates from JAX's weights (Adam against optax), and the async pipeline
on the port's cluster with the Nature-CNN module on the synthetic pixel
env.

Tolerances: float32 on both sides, summation order only; the reverse
recursion over T accumulates at most T such roundings.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.core import impala_learner as jimpala  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu_torch import rllib  # noqa: E402
from ray_tpu_torch.rllib.core import impala_learner as timpala  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.env.synthetic_atari import \
    SyntheticAtariEnv  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
# Weights after Adam steps from the same start (see test_torch_rllib.py).
ADAM_TOL = dict(rtol=1e-5, atol=2e-6)


def _vtrace_inputs(seed: int, T: int = 9, B: int = 4):
    rng = np.random.default_rng(seed)
    nonterminal = np.ones((T, B), np.float32)
    nonterminal[3, 0] = nonterminal[6, 2] = nonterminal[0, 3] = 0.0
    return dict(
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap=rng.normal(size=(B,)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        nonterminal=nonterminal,
        rhos=np.exp(rng.normal(scale=0.6, size=(T, B))).astype(np.float32))


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.5)],
                         ids=["rho1_c1", "rho0.8_c1.5"])
def test_vtrace_matches_jax_with_dones_mid_fragment(clips):
    rho_clip, c_clip = clips
    inputs = _vtrace_inputs(0)
    want_vs, want_pg = jimpala.vtrace_returns(
        *inputs.values(), gamma=0.95, rho_clip=rho_clip, c_clip=c_clip)
    vs, pg = timpala.vtrace_returns(
        *(torch.from_numpy(v) for v in inputs.values()), gamma=0.95,
        rho_clip=rho_clip, c_clip=c_clip)
    assert not vs.requires_grad and not pg.requires_grad
    np.testing.assert_allclose(vs.numpy(), np.asarray(want_vs), **FWD_TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(want_pg), **FWD_TOL)


def _impala_batch(seed: int, T: int, B: int, obs_shape, num_actions: int):
    rng = np.random.default_rng(seed)
    if len(obs_shape) == 3:
        obs = rng.integers(0, 256, (T, B) + obs_shape).astype(np.float32)
        final = rng.integers(0, 256, (B,) + obs_shape).astype(np.float32)
    else:
        obs = rng.normal(size=(T, B) + obs_shape).astype(np.float32)
        final = rng.normal(size=(B,) + obs_shape).astype(np.float32)
    dones = np.zeros((T, B), np.float32)
    dones[T // 2, 0] = 1.0
    return {
        "obs": obs,
        "actions": rng.integers(0, num_actions, (T, B)).astype(np.int32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "dones": dones,
        "logp_old": np.log(rng.uniform(0.1, 0.9, (T, B))).astype(np.float32),
        "final_obs": final,
    }


_MODULES = {
    "mlp": (lambda: jrm.DiscreteMLPModule(obs_dim=4, num_actions=2,
                                          hiddens=(16, 16)),
            lambda: trm.DiscreteMLPModule(4, 2, (16, 16)), (4,), 2),
    "conv": (lambda: jrm.DiscreteConvModule(obs_shape=(84, 84, 4),
                                            num_actions=3),
             lambda: trm.DiscreteConvModule((84, 84, 4), 3), (84, 84, 4), 3),
}


@pytest.mark.parametrize("use_clip_loss", [False, True],
                         ids=["impala", "appo"])
@pytest.mark.parametrize("module", ["mlp", "conv"])
def test_impala_loss_and_gradients_match_jax(module, use_clip_loss):
    make_j, make_t, obs_shape, num_actions = _MODULES[module]
    jmod = make_j()
    jparams = jmod.init(jax.random.PRNGKey(0))
    # A policy head at the trunk's scale: ratios away from 1, so the
    # clip and the rho clip act.
    jparams["pi_w_out"] = jparams["pi_w_out"] * 100
    tmod = trm.module_params_from_jax(jparams, make_t())
    batch = _impala_batch(1, 6, 3, obs_shape, num_actions)
    kw = dict(gamma=0.99, rho_clip=1.0, c_clip=1.0, vf_coeff=0.5,
              entropy_coeff=0.01, use_clip_loss=use_clip_loss,
              clip_param=0.2)
    (want, want_stats), grads = jax.value_and_grad(
        lambda p: jimpala.impala_loss(jmod, p, batch, **kw),
        has_aux=True)(jparams)
    total, stats = timpala.impala_loss(
        tmod, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for name, p in tmod.named_parameters():
        g = np.asarray(grads[name])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("use_clip_loss", [False, True],
                         ids=["impala", "appo"])
def test_impala_learner_updates_match_jax(use_clip_loss):
    """Three updates on three batches from JAX's initial weights."""
    config = {"lr": 5e-4, "seed": 0, "use_clip_loss": use_clip_loss}
    jl = jimpala.ImpalaLearner(
        jrm.DiscreteMLPModule(obs_dim=4, num_actions=2, hiddens=(16, 16)),
        config)
    tl = timpala.ImpalaLearner(trm.DiscreteMLPModule(4, 2, (16, 16)),
                               dict(config, device="cpu"))
    start = jl.get_weights()
    tl.set_weights(start)
    for seed in range(3):
        batch = _impala_batch(10 + seed, 8, 4, (4,), 2)
        want_stats = jl.update(batch)
        stats = tl.update(batch)
    want, got = jl.get_weights(), tl.get_weights()
    assert max(np.abs(want[k] - start[k]).max() for k in want) > 1e-4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **ADAM_TOL, err_msg=k)
    for k in want_stats:
        np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The async pipeline on the port's cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_cluster():
    niced(lambda: ray_tpu_torch.init(num_cpus=6))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("config_cls", [rllib.IMPALAConfig, rllib.APPOConfig],
                         ids=["impala", "appo"])
def test_async_iteration_on_pixels(port_cluster, config_cls):
    """One `train()` iteration with the Nature-CNN module on 84x84x4
    frames: fragments land, the learner steps, weights broadcast."""
    algo = config_cls(
        env_creator=functools.partial(SyntheticAtariEnv, max_blocks=4),
        num_env_runners=2, num_envs_per_runner=2,
        rollout_fragment_length=16, train_batch_fragments=2,
        updates_per_iteration=3, device="cpu").build()
    try:
        assert isinstance(algo.learner.module, trm.DiscreteConvModule)
        m = algo.train()
        assert m["training_iteration"] == 1
        # 3 updates x 2 fragments x [T=16 x 2 envs] steps
        assert m["num_env_steps_sampled_lifetime"] == 3 * 2 * 16 * 2
        assert np.isfinite(m["learner/total_loss"])
        assert m["env_steps_per_sec"] > 0
        assert -4.0 <= m["episode_return_mean"] <= 4.0
    finally:
        algo.stop()
    assert algo.learner.config["use_clip_loss"] is (
        config_cls is rllib.APPOConfig)


@pytest.mark.slow
def test_impala_cartpole_learns(port_cluster):
    """The reference's learning test (test_rllib_impala.py:153): async
    IMPALA reaches a mean return of 150 on CartPole-v1."""
    algo = rllib.IMPALAConfig(num_env_runners=2, num_envs_per_runner=8,
                              rollout_fragment_length=32,
                              train_batch_fragments=2,
                              updates_per_iteration=10, lr=5e-4,
                              entropy_coeff=0.01, device="cpu").build()
    try:
        best = 0.0
        for _ in range(60):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best >= 150:
                break
        assert best >= 150, f"IMPALA failed to learn: best={best}"
    finally:
        algo.stop()
