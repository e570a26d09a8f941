"""DQN: off-policy Q-learning on the new API stack, the port of
`ray_tpu/rllib/algorithms/dqn.py`.

Reference equivalent: `rllib/algorithms/dqn/` — epsilon-greedy rollout
actors feed a replay buffer; the learner samples minibatches, regresses
Q(s,a) onto r + gamma * max_a' Q_target(s',a'), and the target network
refreshes every `target_network_update_freq` updates (double-DQN argmax
by the online net). The learner runs on `config.device` (None: `cuda:0`,
raising without a card); the replay buffer is plain numpy on the driver
and the env runners are CPU actors.

The target network is a module of its own with gradients off, loaded
from the online weights at start-up and at every sync: torch's Adam
updates the online parameters in place, so a target that shared their
storage would silently follow them.

What goes to the runner actors goes by reference (the port has no
cloudpickle): the runners' module is `EpsilonGreedyModule`, built by a
`functools.partial`, and the env creator must be a module-level function
or class, or a `functools.partial` of one.
"""

from __future__ import annotations

import copy
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ray_tpu_torch.rllib.algorithms.ppo import (_default_env_creator,
                                                _kill_all, _probe_spaces,
                                                _runner_actors)
from ray_tpu_torch.rllib.core.learner import learner_device, to_device
# Buffer library lives in rllib/utils/replay_buffers.py (uniform,
# prioritized sum-tree, reservoir); re-exported here as the reference does.
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)


@dataclass
class DQNConfig:
    """`device` is the learner's: None means `cuda:0` and raises without a
    card (the tests pass "cpu")."""

    env: str = "CartPole-v1"
    env_creator: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 16
    lr: float = 5e-4
    gamma: float = 0.99
    buffer_size: int = 50_000
    learning_starts: int = 500      # env steps before the first update
    train_batch_size: int = 64
    updates_per_iteration: int = 50
    target_network_update_freq: int = 200   # learner updates
    double_q: bool = True
    # Prioritized replay (Schaul et al.; reference
    # prioritized_replay_buffer.py): sample ∝ |td|^alpha with
    # importance weights annealing via beta.
    prioritized_replay: bool = False
    prioritized_replay_alpha: float = 0.6
    prioritized_replay_beta: float = 0.4
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 5_000        # env steps
    hiddens: tuple = (64, 64)
    seed: int = 0
    device: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def learner_config(self) -> Dict[str, Any]:
        return {"lr": self.lr, "gamma": self.gamma,
                "double_q": self.double_q,
                "target_network_update_freq":
                    self.target_network_update_freq,
                "seed": self.seed, "device": self.device}

    def build(self) -> "DQN":
        return DQN(self)


def dqn_loss(module, target_module, batch: Dict[str, torch.Tensor], *,
             gamma: float, double_q: bool):
    """Huber TD loss weighted by `batch["weights"]` (all ones where the
    batch has none), and `td_abs` per sample. The bootstrap target,
    the double-Q argmax by the online net included, carries no gradient
    (the reference's `stop_gradient`)."""
    q, _ = module(batch["obs"])                                  # [B, A]
    q_sel = torch.gather(q, 1, batch["actions"][:, None].long())[:, 0]
    with torch.no_grad():
        q_next_target, _ = target_module(batch["next_obs"])
        if double_q:
            # Double DQN: the ONLINE net picks a', the target net rates it.
            q_next_online, _ = module(batch["next_obs"])
            best = torch.argmax(q_next_online, dim=1)
            q_next = torch.gather(q_next_target, 1, best[:, None])[:, 0]
        else:
            q_next = torch.max(q_next_target, dim=1).values
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = q_sel - target
    # Huber: robust to the reward spikes of freshly-exploring policies.
    # Per-sample importance weights (all-ones for uniform replay) keep
    # the prioritized sampling bias corrected.
    w = batch.get("weights")
    if w is None:
        w = torch.ones_like(td)
    td_abs = torch.abs(td)
    huber = torch.where(td_abs < 1.0, 0.5 * td ** 2, td_abs - 0.5)
    loss = torch.mean(w * huber)
    return loss, {"td_error_mean": torch.mean(td_abs),
                  "q_mean": torch.mean(q_sel), "total_loss": loss,
                  "td_abs": td_abs}


class DQNLearner:
    """One Q-learning step (loss, gradient, Adam) with a periodically
    synced target net."""

    def __init__(self, module, config: Dict[str, Any]):
        self.config = config
        self.device = learner_device(config)
        module.reset_parameters(
            torch.Generator().manual_seed(config.get("seed", 0)))
        self.module = module.to(self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.module.parameters(),
                                          lr=config.get("lr", 5e-4),
                                          eps=1e-8)
        self._updates = 0
        self._target_freq = config.get("target_network_update_freq", 200)
        self._loss_kwargs = dict(gamma=config.get("gamma", 0.99),
                                 double_q=config.get("double_q", True))

    def sync_target(self) -> None:
        """Copies the online weights into the target's own storage."""
        with torch.no_grad():
            for t, p in zip(self.target.parameters(),
                            self.module.parameters()):
                t.copy_(p)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        mb = to_device({k: v for k, v in batch.items() if k != "idx"},
                       self.device)
        self.optimizer.zero_grad()
        loss, stats = dqn_loss(self.module, self.target, mb,
                               **self._loss_kwargs)
        loss.backward()
        self.optimizer.step()
        self._updates += 1
        if self._updates % self._target_freq == 0:
            self.sync_target()
        td_abs = stats.pop("td_abs").detach()
        # One copy to the host an update: the statistics and the
        # per-sample |td| that the prioritized buffer's feedback needs.
        host = torch.cat([torch.stack([v.detach() for v in stats.values()]),
                          td_abs]).cpu().numpy()
        out: Dict[str, Any] = {k: float(v)
                               for k, v in zip(stats, host[:len(stats)])}
        out["td_abs"] = host[len(stats):]  # per-sample |td| for PER updates
        return out

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.module.get_weights()

    def get_target_weights(self) -> Dict[str, np.ndarray]:
        return self.target.get_weights()

    def set_weights(self, weights: Dict[str, np.ndarray],
                    target: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Loads the online weights and the target's: `target`, or a copy
        of the online weights where it is None (as at start-up)."""
        self.module.set_weights(weights)
        if target is None:
            self.sync_target()
        else:
            self.target.set_weights(target)


class EpsilonGreedyModule(nn.Module):
    """The runners' greedy-ified view of the Q-module: the logits of
    softmax(Q * 20) mixed with uniform mass epsilon, so that the runner's
    softmax sampling acts epsilon-greedily. Epsilon arrives with the
    weights under `__epsilon__` (0.05 until it does), the rest goes to
    the inner module."""

    def __init__(self, inner_factory: Callable[[], nn.Module]):
        super().__init__()
        self.inner = inner_factory()
        self.epsilon = torch.tensor(0.05, dtype=torch.float32)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return dict(self.inner.get_weights(),
                    __epsilon__=np.asarray(self.epsilon.numpy(),
                                           np.float32))

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        weights = dict(weights)
        if "__epsilon__" in weights:
            self.epsilon = torch.tensor(
                np.asarray(weights.pop("__epsilon__"), np.float32))
        self.inner.set_weights(weights)

    def forward(self, obs: torch.Tensor):
        q, v = self.inner(obs)
        # Sharpen toward greedy, then mix in uniform mass eps:
        # log(softmax(q/tau)*(1-eps) + eps/A) as logits.
        z = q * 20.0
        probs = torch.exp(z - torch.max(z, dim=-1, keepdim=True).values)
        probs = probs / torch.sum(probs, dim=-1, keepdim=True)
        eps = self.epsilon.to(q.device)
        mixed = probs * (1.0 - eps) + eps / q.shape[-1]
        return torch.log(mixed), v


class DQN:
    """Algorithm driver: epsilon-greedy sampling -> replay -> Q updates.

    The env runners are `SingleAgentEnvRunner`s whose module is
    `EpsilonGreedyModule`: it turns Q-values into an epsilon-greedy
    distribution, with epsilon pushed with every weight sync."""

    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.core.serialization import check_sendable
        from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

        self.config = config
        env_creator = config.env_creator or _default_env_creator(config.env)
        check_sendable("DQNConfig.env_creator", env_creator)
        obs_dim, num_actions = _probe_spaces(env_creator)
        module_factory = functools.partial(
            DiscreteMLPModule, obs_dim=obs_dim, num_actions=num_actions,
            hiddens=tuple(config.hiddens))
        self.learner = DQNLearner(module_factory(), config.learner_config())
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_size, seed=config.seed,
                alpha=config.prioritized_replay_alpha)
        else:
            self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self._runners = _runner_actors(
            env_creator, functools.partial(EpsilonGreedyModule,
                                           module_factory), config)
        self._total_steps = 0
        self.iteration = 0
        self._sync_weights()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._total_steps / max(cfg.epsilon_decay_steps, 1))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def runner_weights(self) -> Dict[str, np.ndarray]:
        """What the runners get: the learner's weights and `__epsilon__`,
        the reference's dict."""
        return dict(self.learner.get_weights(),
                    __epsilon__=np.asarray(self._epsilon(), np.float32))

    def _sync_weights(self) -> None:
        import ray_tpu_torch

        weights = self.runner_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights)
                           for r in self._runners], timeout=120)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.monotonic()
        cfg = self.config
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length)
             for r in self._runners], timeout=600)
        for r in rollouts:
            self._total_steps += self.buffer.add_fragment(r)

        stats: Dict[str, Any] = {}
        updates = 0
        if self._total_steps >= cfg.learning_starts:
            prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
            for _ in range(cfg.updates_per_iteration):
                if prioritized:
                    batch = self.buffer.sample(
                        cfg.train_batch_size,
                        beta=cfg.prioritized_replay_beta)
                else:
                    batch = self.buffer.sample(cfg.train_batch_size)
                stats = self.learner.update(batch)
                # Refresh sampled transitions' priorities with their
                # fresh |td| (the PER feedback loop).
                self.buffer.update_priorities(batch["idx"],
                                              stats.pop("td_abs"))
                updates += 1
        self._sync_weights()
        self.iteration += 1
        wall = time.monotonic() - t0
        # Per-iteration view of the runners' rolling windows (the PPO
        # driver's accounting).
        returns = (np.concatenate([r["episode_returns"] for r in rollouts])
                   if any(len(r["episode_returns"]) for r in rollouts)
                   else np.array([0.0]))
        sampled = sum(r["actions"].size for r in rollouts)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(returns.mean()),
            "episode_return_max": float(returns.max()),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "env_steps_per_sec": sampled / max(wall, 1e-9),
            "num_updates": updates,
            "epsilon": self._epsilon(),
            "buffer_size": len(self.buffer),
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def stop(self) -> None:
        _kill_all(self._runners)
        self._runners = []
