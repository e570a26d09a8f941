"""IMPALA / APPO: the async rollout -> learner pipeline, the port of
`ray_tpu/rllib/algorithms/impala.py`.

Reference equivalent: `rllib/algorithms/impala/impala.py:692` — env-runner
actors sample continuously with in-flight request tracking; fragments are
consumed as they land (no sampling barrier), the learner applies V-trace
off-policy correction for the policy lag, and refreshed weights broadcast
to runners every `broadcast_interval` updates. APPO is the same pipeline
with the clipped-surrogate policy term (`rllib/algorithms/appo/`).
"""

from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.ppo import (_default_env_creator,
                                                _kill_all, _probe_env,
                                                _runner_actors)


@dataclass
class IMPALAConfig:
    """`device` is the learner's: None means `cuda:0` and raises without
    a card (the tests pass "cpu")."""

    env: str = "CartPole-v1"
    env_creator: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 32
    train_batch_fragments: int = 2   # fragments stacked per learner step
    broadcast_interval: int = 1      # learner updates between weight pushes
    updates_per_iteration: int = 20  # learner steps per .train() call
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hiddens: tuple = (64, 64)
    # "auto" routes 3-D (image) observations to the conv module,
    # flat ones to the MLP (reference: models/catalog.py).
    model: str = "auto"
    seed: int = 0
    device: Optional[str] = None
    # APPO switch: clipped-surrogate policy loss over v-trace advantages.
    use_clip_loss: bool = False
    clip_param: float = 0.2
    extra: Dict[str, Any] = field(default_factory=dict)

    def learner_config(self) -> Dict[str, Any]:
        return {"lr": self.lr, "gamma": self.gamma,
                "vtrace_rho_clip": self.vtrace_rho_clip,
                "vtrace_c_clip": self.vtrace_c_clip,
                "vf_coeff": self.vf_coeff,
                "entropy_coeff": self.entropy_coeff,
                "use_clip_loss": self.use_clip_loss,
                "clip_param": self.clip_param, "seed": self.seed,
                "device": self.device}

    def build(self) -> "IMPALA":
        return IMPALA(self)


@dataclass
class APPOConfig(IMPALAConfig):
    use_clip_loss: bool = True
    entropy_coeff: float = 0.005

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """The async algorithm. `.train()` consumes fragments as runners
    finish them — a slow runner never blocks the learner (contrast PPO's
    synchronous sample barrier)."""

    def __init__(self, config: IMPALAConfig):
        import ray_tpu_torch
        from ray_tpu_torch.rllib.core.impala_learner import ImpalaLearner
        from ray_tpu_torch.rllib.core.rl_module import make_discrete_module

        self.config = config
        env_creator = config.env_creator or _default_env_creator(config.env)
        obs_shape, num_actions = _probe_env(env_creator)
        module_factory = functools.partial(
            make_discrete_module, obs_shape, num_actions,
            hiddens=tuple(config.hiddens), model=config.model)
        self.learner = ImpalaLearner(module_factory(),
                                     config.learner_config())
        self._runners = _runner_actors(env_creator, module_factory, config)
        weights = self.learner.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners], timeout=120)
        # One in-flight sample request per runner, continuously renewed.
        self._inflight: Dict[Any, Any] = {
            r.sample.remote(config.rollout_fragment_length): r
            for r in self._runners}
        self._fragment_queue: deque = deque()
        self._updates_since_broadcast = 0
        self.iteration = 0
        self._total_steps = 0
        self._recent_returns: deque = deque(maxlen=100)

    # ------------------------------------------------------------------
    def _pump(self, timeout: float = 60.0) -> None:
        """Harvest one finished fragment and immediately resubmit its
        runner (with fresh weights if the broadcast interval elapsed)."""
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()),
                                      num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no env-runner produced a fragment in "
                               f"{timeout}s")
        ref = ready[0]
        runner = self._inflight.pop(ref)
        rollout = ray_tpu_torch.get(ref, timeout=timeout)
        self._fragment_queue.append(rollout)
        self._recent_returns.extend(rollout["episode_returns"].tolist())
        if self._updates_since_broadcast >= self.config.broadcast_interval:
            # Fire-and-forget push to EVERY runner — staleness is bounded
            # by broadcast_interval, not by how often each runner happens
            # to be the first harvest; the learner never waits on it.
            weights = self.learner.get_weights()
            for r in self._runners:
                r.set_weights.remote(weights)
            self._updates_since_broadcast = 0
        self._inflight[
            runner.sample.remote(self.config.rollout_fragment_length)
        ] = runner

    def _next_batch(self) -> Dict[str, np.ndarray]:
        while len(self._fragment_queue) < self.config.train_batch_fragments:
            self._pump()
        frags = [self._fragment_queue.popleft()
                 for _ in range(self.config.train_batch_fragments)]
        # Stack along the env/batch axis; fold timeout bootstrap into
        # rewards (same trick as PPO's GAE path).
        batch = {}
        for key in ("obs", "actions", "rewards", "dones", "logp_old"):
            batch[key] = np.concatenate([f[key] for f in frags], axis=1)
        batch["rewards"] = batch["rewards"] + self.config.gamma * \
            np.concatenate([f["trunc_values"] for f in frags], axis=1)
        batch["final_obs"] = np.concatenate(
            [f["final_obs"] for f in frags], axis=0)
        return batch

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        stats: Dict[str, float] = {}
        steps_this_iter = 0
        for _ in range(self.config.updates_per_iteration):
            batch = self._next_batch()
            stats = self.learner.update(batch)
            self._updates_since_broadcast += 1
            steps_this_iter += batch["actions"].size
        self.iteration += 1
        self._total_steps += steps_this_iter
        wall = time.monotonic() - t0
        returns = (np.array(self._recent_returns)
                   if self._recent_returns else np.array([0.0]))
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(returns.mean()),
            "episode_return_max": float(returns.max()),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "env_steps_per_sec": steps_this_iter / max(wall, 1e-9),
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        _kill_all(self._runners)
        self._runners = []
        self._inflight = {}


class APPO(IMPALA):
    """APPO = the IMPALA pipeline with PPO's clipped surrogate."""
