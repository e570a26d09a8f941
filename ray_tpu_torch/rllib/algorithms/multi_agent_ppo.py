"""Multi-agent PPO: per-policy learners over dict-keyed environments, the
port of `ray_tpu/rllib/algorithms/multi_agent_ppo.py`.

Reference equivalent: `rllib/algorithms/ppo` with
`config.multi_agent(policies=..., policy_mapping_fn=...)` — each policy
gets its own module + optimizer; rollout experience routes to policies by
the mapping fn. Parameter sharing = several agents mapped to one policy
id; independent learning = one policy per agent. Each policy has a
single-agent `PPOLearner` of its own on `config.device` (None: `cuda:0`,
raising without a card); the env runners are CPU actors.

What goes to the runner actors goes by reference (the port has no
cloudpickle): the env creator, the policies' module factories and the
mapping function must be module-level functions or classes, or
`functools.partial`s of them. The build checks them before any actor
starts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.ppo import (RUNNER_OPTIONS,
                                                RUNNER_THREADS, _kill_all)
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnvRunner


def shared_policy(agent_id) -> str:
    """The default mapping: every agent acts with the policy "shared"."""
    return "shared"


@dataclass
class MultiAgentPPOConfig:
    env_creator: Optional[Callable[[], Any]] = None
    # {policy_id: module_factory} — a factory returns an RLModule (an
    # nn.Module with the flat-dict weights API). Agents map to policies
    # via policy_mapping_fn.
    policies: Dict[str, Callable[[], Any]] = field(default_factory=dict)
    policy_mapping_fn: Callable[[Any], str] = shared_policy
    num_env_runners: int = 2
    rollout_fragment_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    vf_clip: float = 10.0
    entropy_coeff: float = 0.0
    num_epochs: int = 4
    minibatch_size: int = 128
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

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    def __init__(self, config: MultiAgentPPOConfig):
        import ray_tpu_torch
        from ray_tpu_torch.core.serialization import check_sendable
        from ray_tpu_torch.rllib.core.learner import PPOLearner

        if not config.policies:
            raise ValueError("MultiAgentPPOConfig.policies is empty — "
                             "pass {policy_id: module_factory}")
        if config.env_creator is None:
            raise ValueError("env_creator is required")
        check_sendable("MultiAgentPPOConfig.env_creator", config.env_creator)
        for pid, factory in config.policies.items():
            check_sendable(f"MultiAgentPPOConfig.policies[{pid!r}]", factory)
        check_sendable("MultiAgentPPOConfig.policy_mapping_fn",
                       config.policy_mapping_fn)
        self.config = config
        self.learners = {
            pid: PPOLearner(factory(), config.learner_config())
            for pid, factory in config.policies.items()}

        runner_cls = ray_tpu_torch.remote(**RUNNER_OPTIONS)(
            MultiAgentEnvRunner)
        runner_conf = {"gamma": config.gamma, "lam": config.lam,
                       "num_threads": RUNNER_THREADS}
        self._runners = [
            runner_cls.remote(config.env_creator, config.policies,
                              config.policy_mapping_fn, runner_conf,
                              seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)]
        self._sync_weights()
        self.iteration = 0
        self._total_steps = 0

    def _sync_weights(self) -> None:
        import ray_tpu_torch

        weights = {pid: learner.get_weights()
                   for pid, learner in self.learners.items()}
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners], timeout=120)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.monotonic()
        cfg = self.config
        samples = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self._runners], timeout=600)

        stats: Dict[str, Dict[str, float]] = {}
        steps = 0
        for pid, learner in self.learners.items():
            parts = [s["batches"][pid] for s in samples
                     if pid in s["batches"]]
            if not parts:
                continue
            batch = {k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}
            steps += len(batch["obs"])
            stats[pid] = learner.update(batch)
        self._sync_weights()

        self.iteration += 1
        self._total_steps += steps
        returns = np.concatenate(
            [s["episode_returns"] for s in samples
             if len(s["episode_returns"])]) \
            if any(len(s["episode_returns"]) for s in samples) \
            else np.array([0.0])
        wall = time.monotonic() - t0
        out: Dict[str, Any] = {
            "training_iteration": self.iteration,
            "episode_return_mean": float(returns.mean()),
            "episode_return_max": float(returns.max()),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "env_steps_per_sec": steps / max(wall, 1e-9),
        }
        for pid, s in stats.items():
            out.update({f"learner/{pid}/{k}": v for k, v in s.items()})
        return out

    def stop(self) -> None:
        _kill_all(self._runners)
        self._runners = []
