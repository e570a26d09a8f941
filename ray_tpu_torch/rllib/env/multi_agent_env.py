"""Multi-agent environment contract + rollout runner + policy mapping, the
port of `ray_tpu/rllib/env/multi_agent_env.py`.

Reference equivalent: `rllib/env/multi_agent_env.py` (the dict-keyed
Gymnasium-style API with the `"__all__"` done signal) and the policy
mapping of `rllib/algorithms/algorithm_config.py multi_agent()` —
`policy_mapping_fn(agent_id, ...) -> policy_id` routes each agent's
experience to its policy; several agents may SHARE one policy (parameter
sharing) or train independently.

The runner keeps one trajectory stream per (env, agent), computes GAE
per stream in numpy when a fragment closes, and emits one flat PPO train
batch PER POLICY — so each policy's learner takes one dense update
regardless of which agents fed it. Sampling is the reference's numpy:
softmax of the logits, `rng.choice`, `log(p + 1e-12)`.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


class MultiAgentEnv:
    """Subclass contract (mirrors the reference MultiAgentEnv):

    - `possible_agents`: list of agent ids.
    - `reset(seed=None) -> (obs_dict, info_dict)`
    - `step(action_dict) -> (obs, rewards, terminateds, truncateds,
      infos)` — all dicts keyed by agent id; `terminateds["__all__"]` /
      `truncateds["__all__"]` end the episode. Only agents present in
      the returned obs dict act next step.
    """

    possible_agents: List[Any] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, int]):
        raise NotImplementedError


class _Stream:
    """One (env, agent) trajectory accumulator."""

    __slots__ = ("obs", "actions", "rewards", "logps", "values", "done")

    def __init__(self):
        self.obs: list = []
        self.actions: list = []
        self.rewards: list = []
        self.logps: list = []
        self.values: list = []
        self.done = False


class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv with per-policy modules.

    `policies`: {policy_id: module_factory}; `policy_mapping_fn`:
    agent_id -> policy_id. `sample(n_steps)` returns
    {policy_id: flat PPO batch} plus episode metrics; agents mapped to
    the same policy batch together (parameter sharing).

    Rollout inference is CPU work: the runner builds its modules on the
    CPU by design, as the reference pins its runners' JAX to the CPU.
    `config["num_threads"]`, where given, sets the process's torch
    threads (`env_runner.SingleAgentEnvRunner`'s rule)."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 policies: Dict[str, Callable[[], Any]],
                 policy_mapping_fn: Callable[[Any], str],
                 config: Dict[str, Any], seed: int = 0):
        if config.get("num_threads"):
            torch.set_num_threads(config["num_threads"])
        self.env = env_creator()
        self.mapping = policy_mapping_fn
        self.modules = {pid: f().to("cpu") for pid, f in policies.items()}
        self.rng = np.random.default_rng(seed)
        self.gamma = config.get("gamma", 0.99)
        self.lam = config.get("lam", 0.95)
        self._seed = seed
        self.obs, _ = self.env.reset(seed=seed)
        self._streams: Dict[Any, _Stream] = {}
        self._episode_return = 0.0
        self._completed: deque = deque(maxlen=50)

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> bool:
        """`{policy_id: flat dict}`, the reference's form."""
        for pid, w in weights.items():
            self.modules[pid].set_weights(w)
        return True

    @torch.no_grad()
    def _apply(self, pid: str, obs: np.ndarray):
        logits, values = self.modules[pid](torch.from_numpy(obs))
        return logits.numpy(), values.numpy()

    def _act(self, obs_dict):
        """Batch per-policy inference over the agents present."""
        actions, logps, values = {}, {}, {}
        by_policy: Dict[str, list] = {}
        for aid, ob in obs_dict.items():
            by_policy.setdefault(self.mapping(aid), []).append(aid)
        for pid, aids in by_policy.items():
            obs = np.stack([np.asarray(obs_dict[a], np.float32)
                            for a in aids])
            logits, vals = self._apply(pid, obs)
            probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
            probs = probs / probs.sum(axis=-1, keepdims=True)
            for i, aid in enumerate(aids):
                a = int(self.rng.choice(len(probs[i]), p=probs[i]))
                actions[aid] = a
                logps[aid] = float(np.log(probs[i][a] + 1e-12))
                values[aid] = float(vals[i])
        return actions, logps, values

    def _bootstrap_value(self, aid, ob) -> float:
        """The agent's policy's value of one observation."""
        ob = np.asarray(ob, np.float32)
        _, v = self._apply(self.mapping(aid), ob[None])
        return float(v[0])

    def _close_stream(self, aid, stream: _Stream, last_value: float,
                      batches: Dict[str, list]) -> None:
        """GAE over one finished (or truncated-by-fragment) stream."""
        if not stream.actions:
            return
        rewards = np.asarray(stream.rewards, np.float32)
        values = np.asarray(stream.values, np.float32)
        T = len(rewards)
        adv = np.zeros(T, np.float32)
        last_adv = 0.0
        next_value = last_value
        for t in range(T - 1, -1, -1):
            nonterminal = 0.0 if (stream.done and t == T - 1) else 1.0
            delta = (rewards[t] + self.gamma * next_value * nonterminal
                     - values[t])
            last_adv = delta + self.gamma * self.lam * nonterminal \
                * last_adv
            adv[t] = last_adv
            next_value = values[t]
        batches.setdefault(self.mapping(aid), []).append({
            "obs": np.stack(stream.obs).astype(np.float32),
            "actions": np.asarray(stream.actions, np.int32),
            "logp_old": np.asarray(stream.logps, np.float32),
            "advantages": adv,
            "value_targets": adv + values,
        })

    def sample(self, n_steps: int) -> Dict[str, Any]:
        batches: Dict[str, list] = {}
        for _ in range(n_steps):
            actions, logps, values = self._act(self.obs)
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid, a in actions.items():
                s = self._streams.setdefault(aid, _Stream())
                s.obs.append(np.asarray(self.obs[aid], np.float32))
                s.actions.append(a)
                s.rewards.append(float(rewards.get(aid, 0.0)))
                s.logps.append(logps[aid])
                s.values.append(values[aid])
                self._episode_return += float(rewards.get(aid, 0.0))
            done_all = terms.get("__all__", False) or truncs.get(
                "__all__", False)
            if done_all:
                terminal = terms.get("__all__", False)
                for aid, s in self._streams.items():
                    s.done = terminal    # truncation bootstraps V(s')
                    if not terminal:
                        # Bootstrap from the agent's final obs.
                        v = self._bootstrap_value(
                            aid, next_obs.get(aid, s.obs[-1]))
                        self._close_stream(aid, s, v, batches)
                    else:
                        self._close_stream(aid, s, 0.0, batches)
                self._streams = {}
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                self.obs, _ = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
            else:
                self.obs = next_obs
        # Fragment end: close surviving streams with bootstrapped V.
        for aid, s in self._streams.items():
            if not s.actions:
                continue
            v = self._bootstrap_value(aid, self.obs.get(aid, s.obs[-1]))
            self._close_stream(aid, s, v, batches)
        self._streams = {}
        out = {}
        for pid, parts in batches.items():
            out[pid] = {k: np.concatenate([p[k] for p in parts])
                        for k in parts[0]}
        return {"batches": out,
                "episode_returns": np.asarray(self._completed,
                                              np.float32)}
