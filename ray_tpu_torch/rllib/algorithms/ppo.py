"""PPO: the new-stack algorithm loop, the port of
`ray_tpu/rllib/algorithms/ppo.py`.

Reference equivalent: `rllib/algorithms/ppo/ppo.py:423` training_step —
parallel EnvRunner sampling -> GAE -> LearnerGroup minibatch SGD ->
weight sync. Env runners are CPU actors of the port's runtime; the
learner group is local or a gang on Train's backend.

What goes to the runner actors goes by reference (the port has no
cloudpickle): the env creator must be a module-level function or class,
or a `functools.partial` of one, and the module factory is a
`functools.partial` of the module class.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

# The runners' actor options, as the reference's: one CPU each (so one
# torch thread each), and a second slot so that a weight push can land
# while a fragment is being sampled.
RUNNER_OPTIONS = dict(num_cpus=1, max_concurrency=2)
RUNNER_THREADS = 1


@dataclass
class PPOConfig:
    """Reference: algorithm_config.py + PPOConfig — the subset that
    matters for this stack. `device` is the learner's: None means
    `cuda:0` and raises without a card (the tests pass "cpu")."""

    env: str = "CartPole-v1"
    env_creator: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64
    num_learners: int = 0          # 0 = a local learner in this process
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    vf_clip: float = 10.0
    entropy_coeff: float = 0.0
    num_epochs: int = 8
    minibatch_size: int = 128
    hiddens: tuple = (64, 64)
    seed: int = 0
    device: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def learner_config(self) -> Dict[str, Any]:
        return {"lr": self.lr, "clip_param": self.clip_param,
                "vf_coeff": self.vf_coeff, "vf_clip": self.vf_clip,
                "entropy_coeff": self.entropy_coeff,
                "num_epochs": self.num_epochs,
                "minibatch_size": self.minibatch_size,
                "seed": self.seed, "device": self.device}

    def build(self) -> "PPO":
        return PPO(self)


def _make_gym_env(env_name: str):
    try:
        import gymnasium as gym
    except ImportError as e:
        raise ImportError(
            f"the env {env_name!r} is made with gymnasium, which is not "
            f"installed; install gymnasium or pass env_creator=") from e
    return gym.make(env_name)


def _default_env_creator(env_name: str):
    return functools.partial(_make_gym_env, env_name)


def _probe_env(env_creator) -> tuple:
    """(obs_shape, num_actions) — shape preserved so the module catalog
    can route image observations to the conv trunk."""
    env = env_creator()
    shape = tuple(int(s) for s in env.observation_space.shape)
    num_actions = int(env.action_space.n)
    env.close()
    return shape, num_actions


def _probe_spaces(env_creator) -> tuple:
    """(flat observation size, num_actions)."""
    shape, num_actions = _probe_env(env_creator)
    return int(np.prod(shape)), num_actions


def _runner_actors(env_creator, module_factory, config) -> list:
    import ray_tpu_torch
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    runner_cls = ray_tpu_torch.remote(**RUNNER_OPTIONS)(SingleAgentEnvRunner)
    runner_conf = {"num_envs_per_runner": config.num_envs_per_runner,
                   "num_threads": RUNNER_THREADS}
    return [runner_cls.remote(env_creator, module_factory, runner_conf,
                              seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)]


def _kill_all(actors) -> None:
    import ray_tpu_torch

    for actor in actors:
        try:
            ray_tpu_torch.kill(actor)
        except Exception:  # noqa: BLE001 - already gone
            pass


class PPO:
    """Reference: Algorithm (a Tune Trainable): `.train()` runs one
    iteration and returns metrics."""

    def __init__(self, config: PPOConfig):
        from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
        from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

        self.config = config
        env_creator = config.env_creator or _default_env_creator(config.env)
        obs_shape, num_actions = _probe_env(env_creator)
        module_factory = functools.partial(
            DiscreteMLPModule, obs_dim=int(np.prod(obs_shape)),
            num_actions=num_actions, hiddens=tuple(config.hiddens))
        self.learner_group = LearnerGroup(
            module_factory, config.learner_config(),
            num_learners=config.num_learners)
        self._runners = _runner_actors(env_creator, module_factory, config)
        self._sync_weights()
        self.iteration = 0
        self._total_steps = 0

    # ------------------------------------------------------------------
    def _sync_weights(self) -> None:
        import ray_tpu_torch

        weights = self.learner_group.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners], timeout=120)

    def train(self) -> Dict[str, Any]:
        """One iteration: sample -> GAE -> update -> sync."""
        import ray_tpu_torch
        from ray_tpu_torch.rllib.env.env_runner import (compute_gae,
                                                        concat_batches)

        t0 = time.monotonic()
        cfg = self.config
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self._runners], timeout=600)
        batch = concat_batches(
            [compute_gae(r, cfg.gamma, cfg.lam) for r in rollouts])
        sample_time = time.monotonic() - t0

        t1 = time.monotonic()
        stats = self.learner_group.update(batch)
        self._sync_weights()
        learn_time = time.monotonic() - t1

        self.iteration += 1
        self._total_steps += len(batch["obs"])
        episode_returns = np.concatenate(
            [r["episode_returns"] for r in rollouts]) \
            if any(len(r["episode_returns"]) for r in rollouts) \
            else np.array([0.0])
        wall = time.monotonic() - t0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(episode_returns.mean()),
            "episode_return_max": float(episode_returns.max()),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "env_steps_per_sec": len(batch["obs"]) / max(wall, 1e-9),
            "time_sample_s": sample_time,
            "time_learn_s": learn_time,
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def stop(self) -> None:
        _kill_all(self._runners)
        self._runners = []
        self.learner_group.shutdown()
