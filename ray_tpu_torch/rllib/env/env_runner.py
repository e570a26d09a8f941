"""SingleAgentEnvRunner: vectorized rollout collection, the port of
`ray_tpu/rllib/env/env_runner.py`.

An actor stepping N gymnasium-style envs with the current policy,
returning fixed-length time-major fragments with per-step values and
log-probabilities (what PPO's GAE needs), the truncation records and the
completed episodes' returns.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List

import numpy as np
import torch


class SingleAgentEnvRunner:
    """Rollout inference is CPU work: the runner builds its module on the
    CPU, by design and not as a fallback. The reference pins its runners'
    JAX to the CPU the same way (env runners are CPU actors; only the
    learner holds the card).

    `config["num_threads"]`, where given, sets the process's torch
    threads: the algorithms give their runner actors, which lease one CPU
    each, one thread, so that several runners and the learner on one host
    do not oversubscribe its cores with tiny batches."""

    def __init__(self, env_creator: Callable[[], Any], module_factory,
                 config: Dict[str, Any], seed: int = 0):
        if config.get("num_threads"):
            torch.set_num_threads(config["num_threads"])
        self.envs = [env_creator()
                     for _ in range(config.get("num_envs_per_runner", 1))]
        self.module = module_factory().to("cpu")
        self.rng = np.random.default_rng(seed)
        self.obs = np.stack([env.reset(seed=seed + i)[0]
                             for i, env in enumerate(self.envs)])
        self._episode_return = np.zeros(len(self.envs))
        self._completed: deque = deque(maxlen=50)

    def set_weights(self, weights) -> bool:
        self.module.set_weights(weights)
        return True

    @torch.no_grad()
    def _apply(self, obs: np.ndarray):
        logits, values = self.module(torch.from_numpy(obs))
        return logits.numpy(), values.numpy()

    def sample(self, fragment_length: int) -> Dict[str, np.ndarray]:
        """Collect `fragment_length` steps from every env (time-major
        rollout flattened env-by-env, with GAE inputs)."""
        n_envs = len(self.envs)
        T = fragment_length
        obs_buf = np.zeros((T, n_envs) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, n_envs), np.int32)
        rew_buf = np.zeros((T, n_envs), np.float32)
        done_buf = np.zeros((T, n_envs), np.float32)
        term_buf = np.zeros((T, n_envs), np.float32)
        logp_buf = np.zeros((T, n_envs), np.float32)
        val_buf = np.zeros((T, n_envs), np.float32)
        # Time-limit truncations are NOT terminations: GAE must bootstrap
        # V(final_obs) there.
        trunc_events: list = []  # (t, env_idx, final_obs)

        for t in range(T):
            logits, values = self._apply(self.obs.astype(np.float32))
            probs = _softmax(logits)
            actions = np.array([self.rng.choice(len(p), p=p)
                                for p in probs])
            logp = np.log(probs[np.arange(n_envs), actions] + 1e-12)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            next_obs = []
            for i, env in enumerate(self.envs):
                o, r, term, trunc, _ = env.step(int(actions[i]))
                rew_buf[t, i] = r
                self._episode_return[i] += r
                done = term or trunc
                done_buf[t, i] = float(done)
                term_buf[t, i] = float(term)
                if done:
                    if trunc and not term:
                        trunc_events.append((t, i, np.asarray(o)))
                    self._completed.append(self._episode_return[i])
                    self._episode_return[i] = 0.0
                    o, _ = env.reset()
                next_obs.append(o)
            self.obs = np.stack(next_obs)

        # Bootstrap value for the state after the fragment.
        _, last_values = self._apply(self.obs.astype(np.float32))
        trunc_values = np.zeros((T, n_envs), np.float32)
        trunc_t = np.zeros((len(trunc_events),), np.int32)
        trunc_env = np.zeros((len(trunc_events),), np.int32)
        trunc_obs = (np.stack([o for _, _, o in trunc_events]
                              ).astype(np.float32) if trunc_events
                     else np.zeros((0,) + self.obs.shape[1:], np.float32))
        if trunc_events:
            _, v_final = self._apply(trunc_obs)
            for k, (t, i, _) in enumerate(trunc_events):
                trunc_values[t, i] = v_final[k]
                trunc_t[k] = t
                trunc_env[k] = i
        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "dones": done_buf,
            # Truncation is NOT termination: off-policy targets must
            # bootstrap through time limits (terminateds masks, dones
            # marks episode boundaries).
            "terminateds": term_buf,
            "logp_old": logp_buf, "values": val_buf,
            "last_values": last_values,
            # The raw post-fragment observation: off-policy learners
            # (IMPALA v-trace) bootstrap from the LEARNER's value of this
            # state, not the actor's stale `last_values`.
            "final_obs": self.obs.astype(np.float32),
            "trunc_values": trunc_values,
            # Sparse truncation records: step, env, and the true final
            # observation the time limit cut off (GAE uses trunc_values).
            "trunc_t": trunc_t, "trunc_env": trunc_env,
            "trunc_obs": trunc_obs,
            "episode_returns": np.array(list(self._completed)),
        }


def _softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def compute_gae(rollout: Dict[str, np.ndarray], gamma: float,
                lam: float) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over a time-major rollout; returns
    the flat train batch (reference: postprocessing/advantages)."""
    rewards, values, dones = (rollout["rewards"], rollout["values"],
                              rollout["dones"])
    # Timeout bootstrap: a truncated step's reward absorbs the discounted
    # value of the state the time limit cut off.
    trunc_values = rollout.get("trunc_values")
    if trunc_values is not None:
        rewards = rewards + gamma * trunc_values
    T, n_envs = rewards.shape
    adv = np.zeros_like(rewards)
    last_adv = np.zeros(n_envs, np.float32)
    next_value = rollout["last_values"]
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        adv[t] = last_adv
        next_value = values[t]
    targets = adv + values
    flat = lambda a: a.reshape((T * n_envs,) + a.shape[2:])  # noqa: E731
    return {
        "obs": flat(rollout["obs"]),
        "actions": flat(rollout["actions"]),
        "logp_old": flat(rollout["logp_old"]),
        "advantages": flat(adv).astype(np.float32),
        "value_targets": flat(targets).astype(np.float32),
    }


def concat_batches(batches: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}
