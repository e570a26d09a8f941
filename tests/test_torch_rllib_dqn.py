"""The port's DQN (`ray_tpu_torch/rllib/algorithms/dqn.py`) and replay
buffers (`rllib/utils/replay_buffers.py`) against the JAX package's, on
the CPU: the buffers bit for bit, `dqn_loss` and its gradients,
`DQNLearner` over updates with target syncs, the runners'
epsilon-greedy module and its weights, and DQN on the port's cluster.

Weights cross from JAX through `module_params_from_jax`; inputs come from
numpy seeds. Tolerances: both sides compute in float32 and differ only
in summation order (some 1e-7 relative); Adam divides each step by the
gradient's running RMS, which carries such differences into the weights
at the scale of a few ulps of the step.
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
from ray_tpu.rllib.algorithms import dqn as jdqn  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu.rllib.utils import replay_buffers as jrb  # noqa: E402
from ray_tpu_torch.rllib.algorithms import dqn as tdqn  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.utils import replay_buffers as trb  # noqa: E402

# Forward values and gradients: float32 on both sides, summation order
# only.
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
# Weights after several Adam steps from the same start.
ADAM_TOL = dict(rtol=1e-5, atol=2e-6)
# |td| after several updates: the Q-values of weights within ADAM_TOL.
TD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Replay buffers: bit for bit
# ---------------------------------------------------------------------------
def _fragment(seed: int, T: int = 12, n_envs: int = 3, n_trunc: int = 2):
    """A time-major fragment with `n_trunc` time-limit truncations."""
    rng = np.random.default_rng(seed)
    terms = (rng.random((T, n_envs)) < 0.1).astype(np.float32)
    dones = terms.copy()
    cells = rng.choice(T * n_envs, n_trunc, replace=False)
    trunc_t, trunc_env = (cells // n_envs).astype(np.int32), \
        (cells % n_envs).astype(np.int32)
    dones[trunc_t, trunc_env] = 1.0
    terms[trunc_t, trunc_env] = 0.0
    return {
        "obs": rng.normal(size=(T, n_envs, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, n_envs)).astype(np.int32),
        "rewards": rng.normal(size=(T, n_envs)).astype(np.float32),
        "dones": dones, "terminateds": terms,
        "final_obs": rng.normal(size=(n_envs, 4)).astype(np.float32),
        "trunc_t": trunc_t, "trunc_env": trunc_env,
        "trunc_obs": rng.normal(size=(n_trunc, 4)).astype(np.float32),
    }


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_sum_tree_bit_for_bit():
    rng = np.random.default_rng(0)
    want, got = jrb.SumTree(50), trb.SumTree(50)
    assert got.capacity == want.capacity == 64
    for _ in range(300):
        i, v = int(rng.integers(0, 50)), float(rng.random() ** 3)
        want.set(i, v)
        got.set(i, v)
    np.testing.assert_array_equal(got.tree, want.tree)
    assert got.total() == want.total()
    for mass in rng.uniform(0, want.total(), 200):
        assert got.find_prefix(mass) == want.find_prefix(mass)
    assert [got.get(i) for i in range(50)] == [want.get(i)
                                              for i in range(50)]


@pytest.mark.parametrize("kind", ["ReplayBuffer", "PrioritizedReplayBuffer",
                                  "ReservoirReplayBuffer"])
def test_buffers_bit_for_bit(kind):
    """The same fragments (truncations included) into buffers of the same
    seed that overflow their capacity: the same storage, sampled
    indices, importance weights, and priorities after
    `update_priorities`."""
    want_buf = getattr(jrb, kind)(50, seed=3)
    buf = getattr(trb, kind)(50, seed=3)
    for seed in range(4):
        frag = _fragment(seed)
        assert buf.add_fragment(frag) == want_buf.add_fragment(frag) == 36
    assert len(buf) == len(want_buf) == 50
    for (o, a, r, no, d), (wo, wa, wr, wno, wd) in zip(buf._storage,
                                                       want_buf._storage):
        np.testing.assert_array_equal(o, wo)
        np.testing.assert_array_equal(no, wno)
        assert (a, r, d) == (wa, wr, wd)
    rng = np.random.default_rng(9)
    for step in range(5):
        if kind == "PrioritizedReplayBuffer":
            want, got = want_buf.sample(16, beta=0.5), buf.sample(16, beta=0.5)
            # Every transition enters at the same priority; the weights
            # vary once `update_priorities` has run.
            assert np.all(got["weights"] == 1.0) == (step == 0)
        else:
            want, got = want_buf.sample(16), buf.sample(16)
        _same_batch(got, want)
        td = rng.normal(size=16).astype(np.float32)
        want_buf.update_priorities(want["idx"], td)
        buf.update_priorities(got["idx"], td)
    if kind == "PrioritizedReplayBuffer":
        np.testing.assert_array_equal(buf._tree.tree, want_buf._tree.tree)
        assert buf._max_prio == want_buf._max_prio


def test_add_fragment_bootstraps_truncations_from_their_final_obs():
    frag = _fragment(5)
    buf = trb.ReplayBuffer(100)
    buf.add_fragment(frag)
    n_envs = frag["actions"].shape[1]
    for k in range(len(frag["trunc_t"])):
        t, e = int(frag["trunc_t"][k]), int(frag["trunc_env"][k])
        _, _, _, next_obs, term = buf._storage[t * n_envs + e]
        np.testing.assert_array_equal(next_obs, frag["trunc_obs"][k])
        assert term == 0.0


# The reference's buffer tests (tests/test_rllib_multiagent.py), on the
# port's buffers.
def _fill(buf, n, reward=0.0):
    frag = {
        "obs": np.zeros((n, 1, 2), np.float32),
        "actions": np.zeros((n, 1), np.int64),
        "rewards": np.full((n, 1), reward, np.float32),
        "dones": np.zeros((n, 1), np.float32),
        "terminateds": np.zeros((n, 1), np.float32),
        "final_obs": np.zeros((1, 2), np.float32),
    }
    buf.add_fragment(frag)


def test_sum_tree_total_prefix_and_update():
    t = trb.SumTree(8)
    for i, p in enumerate([1.0, 2.0, 3.0, 4.0]):
        t.set(i, p)
    assert t.total() == pytest.approx(10.0)
    assert t.find_prefix(0.5) == 0
    assert t.find_prefix(1.5) == 1
    assert t.find_prefix(9.9) == 3
    t = trb.SumTree(4)
    t.set(0, 5.0)
    t.set(0, 1.0)
    assert t.total() == pytest.approx(1.0)


def test_high_priority_dominates_sampling():
    buf = trb.PrioritizedReplayBuffer(256, seed=0, alpha=1.0)
    _fill(buf, 100)
    buf.update_priorities(np.arange(100),
                          np.where(np.arange(100) == 7, 10.0, 1e-4))
    batch = buf.sample(64, beta=0.4)
    assert float(np.mean(batch["idx"] == 7)) > 0.9


def test_importance_weights_counteract_bias():
    buf = trb.PrioritizedReplayBuffer(64, seed=0, alpha=1.0)
    _fill(buf, 32)
    buf.update_priorities(np.arange(32),
                          np.where(np.arange(32) == 0, 8.0, 1.0))
    batch = buf.sample(32, beta=1.0)
    w = batch["weights"]
    oversampled = batch["idx"] == 0
    assert oversampled.any() and (~oversampled).any()
    assert w[oversampled].max() < w[~oversampled].min()
    assert w.max() == pytest.approx(1.0)


def test_uniform_api_parity_and_reservoir():
    buf = trb.ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    batch = buf.sample(16)
    assert np.all(batch["weights"] == 1.0)
    buf.update_priorities(batch["idx"], np.ones(16))  # no-op
    res = trb.ReservoirReplayBuffer(100, seed=0)
    _fill(res, 1000)
    assert len(res) == 100 and res._seen == 1000


# ---------------------------------------------------------------------------
# dqn_loss and DQNLearner against JAX
# ---------------------------------------------------------------------------
def _dqn_batch(seed: int, n: int = 32, obs_dim: int = 4, num_actions: int = 3):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        # Rewards large enough that part of the TD errors lie past the
        # Huber knee at 1.
        "rewards": (2 * rng.normal(size=n)).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "dones": (rng.random(n) < 0.2).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32),
    }


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "max"])
def test_dqn_loss_and_gradients_match_jax(double_q):
    jmod = jrm.DiscreteMLPModule(obs_dim=4, num_actions=3, hiddens=(16, 16))
    params = jmod.init(jax.random.PRNGKey(0))
    target = jmod.init(jax.random.PRNGKey(1))
    online = trm.module_params_from_jax(
        params, trm.DiscreteMLPModule(4, 3, (16, 16)))
    tmod = trm.module_params_from_jax(
        target, trm.DiscreteMLPModule(4, 3, (16, 16))).requires_grad_(False)
    batch = _dqn_batch(0)
    (want, want_stats), grads = jax.value_and_grad(
        lambda p: jdqn.dqn_loss(jmod, p, target, batch, gamma=0.9,
                                double_q=double_q), has_aux=True)(params)
    loss, stats = tdqn.dqn_loss(
        online, tmod, {k: torch.from_numpy(v) for k, v in batch.items()},
        gamma=0.9, double_q=double_q)
    loss.backward()
    td = np.asarray(want_stats["td_abs"])
    assert (td > 1).any() and (td < 1).any()
    np.testing.assert_allclose(float(loss.detach()), float(want), **FWD_TOL)
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k].detach().numpy(), np.asarray(v),
                                   **FWD_TOL, err_msg=k)
    for name, p in online.named_parameters():
        # The value head takes no part in the loss: JAX's gradient there
        # is zeros, torch's None (and Adam leaves both unmoved).
        grad = (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.numpy())
        assert (p.grad is None) == name.startswith("vf_"), name
        np.testing.assert_allclose(grad, np.asarray(grads[name]),
                                   **FWD_TOL, err_msg=name)
    assert all(p.grad is None for p in tmod.parameters())


def test_dqn_learner_matches_jax_through_target_syncs():
    """Five updates with `target_network_update_freq=3` on prioritized
    batches (importance weights not all ones) from JAX's initial online
    and target weights: the weights and |td| after each update, and the
    target net — a copy that differs from the online net between syncs
    and equals it right after one (update 3)."""
    config = {"lr": 1e-3, "gamma": 0.99, "double_q": True,
              "target_network_update_freq": 3, "seed": 4}
    jl = jdqn.DQNLearner(
        jrm.DiscreteMLPModule(obs_dim=4, num_actions=3, hiddens=(16, 16)),
        config)
    tl = tdqn.DQNLearner(trm.DiscreteMLPModule(4, 3, (16, 16)),
                         dict(config, device="cpu"))
    trm.module_params_from_jax(jl.params, tl.module)
    trm.module_params_from_jax(jl.target_params, tl.target)
    assert all(p.data_ptr() != t.data_ptr() and not t.requires_grad
               for p, t in zip(tl.module.parameters(),
                               tl.target.parameters()))
    buf = jrb.PrioritizedReplayBuffer(256, seed=2)
    for seed in range(3):
        buf.add_fragment(_fragment(seed, T=40, n_envs=2))
    buf.update_priorities(np.arange(len(buf)),
                          np.random.default_rng(1).exponential(size=len(buf)))
    for step in range(1, 6):
        batch = buf.sample(32, beta=0.4)
        assert not np.all(batch["weights"] == 1.0)
        want = jl.update(batch)
        got = tl.update(batch)
        buf.update_priorities(batch["idx"], want["td_abs"])
        np.testing.assert_allclose(got.pop("td_abs"), want.pop("td_abs"),
                                   **TD_TOL)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TD_TOL, err_msg=k)
        jw, jt = _np(jl.get_weights()), _np(jl.target_params)
        tw, tt = tl.get_weights(), tl.get_target_weights()
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], **ADAM_TOL, err_msg=k)
            np.testing.assert_allclose(tt[k], jt[k], **ADAM_TOL, err_msg=k)
        synced = all(np.array_equal(tw[k], tt[k]) for k in tw)
        assert synced == (step == 3), step


def test_dqn_learner_set_weights_and_device_rule():
    tl = tdqn.DQNLearner(trm.DiscreteMLPModule(4, 2, (8,)), {"device": "cpu"})
    w = trm.DiscreteMLPModule(
        4, 2, (8,), generator=torch.Generator().manual_seed(7)).get_weights()
    other = {k: v + 1 for k, v in w.items()}
    tl.set_weights(w)
    for k, v in tl.get_target_weights().items():
        np.testing.assert_array_equal(v, w[k])
    tl.set_weights(w, target=other)
    for k, v in tl.get_target_weights().items():
        np.testing.assert_array_equal(v, other[k])
    if torch.cuda.is_available():
        learner = tdqn.DQNLearner(trm.DiscreteMLPModule(4, 2, (8,)), {})
        assert learner.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdqn.DQNLearner(trm.DiscreteMLPModule(4, 2, (8,)), {})


def test_per_beats_uniform_on_rare_transitions():
    """The reference's head-to-head (test_rllib_multiagent.py), on the
    port's learner and buffers: after equal update budgets from the same
    init, prioritized replay fits the rare rewarding transitions' targets
    far better than uniform replay."""
    rng = np.random.default_rng(0)
    n_common, n_rare = 500, 8
    obs = rng.normal(size=(n_common + n_rare, 4)).astype(np.float32)
    obs[:n_common, 0] = 0.0
    obs[-n_rare:, 0] = 5.0
    actions = np.zeros(n_common + n_rare, np.int64)
    rewards = np.zeros(n_common + n_rare, np.float32)
    rewards[-n_rare:] = 10.0
    next_obs = np.zeros_like(obs)
    dones = np.ones_like(rewards)

    def run(buf, prioritized):
        buf.add_fragment({
            "obs": obs[:, None, :], "actions": actions[:, None],
            "rewards": rewards[:, None], "dones": dones[:, None],
            "terminateds": dones[:, None], "final_obs": next_obs[-1:]})
        learner = tdqn.DQNLearner(
            trm.DiscreteMLPModule(obs_dim=4, num_actions=2, hiddens=()),
            {"lr": 2e-2, "gamma": 0.99, "double_q": False, "seed": 3,
             "device": "cpu"})
        for _ in range(100):
            batch = (buf.sample(64, beta=0.4) if prioritized
                     else buf.sample(64))
            stats = learner.update(batch)
            buf.update_priorities(batch["idx"], stats.pop("td_abs"))
        with torch.no_grad():
            q, _ = learner.module(torch.from_numpy(obs[-n_rare:]))
        q_sel = q.numpy()[np.arange(n_rare), actions[-n_rare:]]
        return float(np.mean(np.abs(q_sel - 10.0)))

    err_uniform = run(trb.ReplayBuffer(4096, seed=1), False)
    err_per = run(trb.PrioritizedReplayBuffer(4096, seed=1, alpha=0.8), True)
    assert err_per < err_uniform * 0.5, (err_per, err_uniform)


# ---------------------------------------------------------------------------
# The runners' epsilon-greedy module against the reference's
# ---------------------------------------------------------------------------
def _reference_dqn_runner_module(monkeypatch, env_creator):
    """The reference's `_EpsilonGreedyModule` (a class local to
    `DQN.__init__`) and the weights its driver pushes, from a reference
    DQN built with its actor calls recorded: nothing starts."""
    import ray_tpu

    made, pushed = [], []

    class _Runner:
        @staticmethod
        def remote(*args, **kwargs):
            made.append(args)
            return _Runner

        class set_weights:  # noqa: N801 - the handle's method name
            @staticmethod
            def remote(weights):
                pushed.append(weights)

    monkeypatch.setattr(ray_tpu, "remote",
                        lambda *a, **k: (lambda cls: _Runner))
    monkeypatch.setattr(ray_tpu, "get", lambda refs, timeout=None: refs)
    jdqn.DQN(jdqn.DQNConfig(env_creator=env_creator, num_env_runners=1,
                            hiddens=(16,), platform="cpu"))
    _, runner_module_factory, _ = made[0][:3]
    return runner_module_factory(), pushed[0]


def _port_dqn(monkeypatch, env_creator):
    """A port DQN on the CPU with its runners left out."""
    monkeypatch.setattr(tdqn, "_runner_actors", lambda *a: [])
    monkeypatch.setattr(ray_tpu_torch, "get", lambda refs, timeout=None: refs)
    return tdqn.DQN(tdqn.DQNConfig(env_creator=env_creator, hiddens=(16,),
                                   device="cpu"))


def test_epsilon_greedy_logits_and_weights_cross_both_ways(monkeypatch):
    """The reference driver's runner weights (with `__epsilon__`) load
    into the port's `EpsilonGreedyModule` and give the reference
    module's logits, at several epsilons; the port driver's load into
    the reference's module the same way."""
    import gymnasium as gym

    env_creator = functools.partial(gym.make, "CartPole-v1")
    jmodule, jweights = _reference_dqn_runner_module(monkeypatch,
                                                     env_creator)
    assert "__epsilon__" in jweights
    algo = _port_dqn(monkeypatch, env_creator)
    tweights = algo.runner_weights()
    assert set(tweights) == set(jweights)
    for k in jweights:
        assert np.asarray(tweights[k]).dtype == np.asarray(jweights[k]).dtype
        assert np.shape(tweights[k]) == np.shape(jweights[k])
    module = tdqn.EpsilonGreedyModule(functools.partial(
        trm.DiscreteMLPModule, obs_dim=4, num_actions=2, hiddens=(16,)))
    obs = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    for source in (jweights, tweights):
        for eps in (0.0, 0.05, 0.3, 1.0):
            w = {k: np.asarray(v) for k, v in source.items()}
            # Q at a scale where the greedy action depends on the weights.
            w["pi_w_out"] = w["pi_w_out"] * 30
            w["__epsilon__"] = np.asarray(eps, np.float32)
            want, want_v = jmodule.apply(
                {k: jax.numpy.asarray(v) for k, v in w.items()}, obs)
            module.set_weights(w)
            with torch.no_grad():
                got, got_v = module(torch.from_numpy(obs))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                       **FWD_TOL)
            back = module.get_weights()
            assert set(back) == set(w)
            for k in w:
                np.testing.assert_array_equal(back[k], w[k])
    with pytest.raises(ValueError, match="do not match"):
        module.set_weights(dict(tweights, extra=np.zeros(1, np.float32)))


def test_dqn_refuses_a_lambda_env_creator():
    with pytest.raises(TypeError, match="module-level"):
        tdqn.DQN(tdqn.DQNConfig(env_creator=lambda: None, device="cpu"))


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


def test_dqn_iteration_end_to_end(port_cluster):
    """The reference's test (test_rllib_dqn.py): the first iteration
    fills the buffer, the second updates past `learning_starts`."""
    algo = tdqn.DQNConfig(num_env_runners=2, num_envs_per_runner=2,
                          rollout_fragment_length=8, learning_starts=32,
                          updates_per_iteration=4, train_batch_size=16,
                          device="cpu").build()
    try:
        m1 = algo.train()
        assert m1["training_iteration"] == 1
        assert m1["buffer_size"] == 2 * 2 * 8
        m2 = algo.train()
        assert m2["num_updates"] == 4
        assert np.isfinite(m2["learner/total_loss"])
        assert 0.0 <= m2["epsilon"] <= 1.0
        assert "learner/td_abs" not in m2
    finally:
        algo.stop()


def test_prioritized_dqn_iteration(port_cluster):
    algo = tdqn.DQNConfig(num_env_runners=2, num_envs_per_runner=2,
                          rollout_fragment_length=8, learning_starts=32,
                          updates_per_iteration=4, train_batch_size=16,
                          prioritized_replay=True, device="cpu").build()
    try:
        algo.train()
        m = algo.train()
        assert m["num_updates"] == 4
        assert isinstance(algo.buffer, trb.PrioritizedReplayBuffer)
        assert algo.buffer._max_prio != 1.0
        assert np.isfinite(m["learner/td_error_mean"])
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_cartpole_learns(port_cluster):
    """The reference's learning test (test_rllib_dqn.py)."""
    algo = tdqn.DQNConfig(num_env_runners=2, num_envs_per_runner=8,
                          rollout_fragment_length=16, lr=1e-3,
                          learning_starts=500, train_batch_size=64,
                          updates_per_iteration=40,
                          target_network_update_freq=100,
                          epsilon_decay_steps=4000, device="cpu").build()
    try:
        best = 0.0
        for _ in range(80):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
            if best >= 150:
                break
        assert best >= 150, f"DQN failed to learn: best={best}"
    finally:
        algo.stop()
