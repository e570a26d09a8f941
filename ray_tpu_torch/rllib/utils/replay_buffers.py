"""Replay buffer library: uniform, prioritized (sum-tree), reservoir. The
port of `ray_tpu/rllib/utils/replay_buffers.py`, kept as its own numpy
copy: the same seed gives the same sampled indices, importance weights
and priorities, bit for bit.

Reference equivalent: `rllib/utils/replay_buffers/` —
`replay_buffer.py` (uniform), `prioritized_replay_buffer.py` (+
`segment_tree.py`), `reservoir_replay_buffer.py`. Numpy on the driver:
host RAM is the right home for a million transitions, not the card's
memory; only the sampled minibatch crosses to the learner's device.
`add_fragment` reads the truncation records that the env runner returns
(`env/env_runner.py SingleAgentEnvRunner.sample`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SumTree:
    """Array-backed binary sum tree: O(log n) priority update and
    prefix-sum sampling (reference: rllib segment_tree.py SumSegmentTree).
    Leaves live at [capacity-1, 2*capacity-1)."""

    def __init__(self, capacity: int):
        # Round up to a power of two so the tree stays complete.
        size = 1
        while size < capacity:
            size *= 2
        self.capacity = size
        self.tree = np.zeros(2 * size - 1, np.float64)

    def total(self) -> float:
        return float(self.tree[0])

    def set(self, idx: int, value: float) -> None:
        node = idx + self.capacity - 1
        delta = value - self.tree[node]
        while node >= 0:
            self.tree[node] += delta
            if node == 0:
                break
            node = (node - 1) // 2

    def get(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity - 1])

    def find_prefix(self, mass: float) -> int:
        """Leaf index whose cumulative-sum bucket contains `mass`."""
        node = 0
        while node < self.capacity - 1:
            left = 2 * node + 1
            if mass <= self.tree[left]:
                node = left
            else:
                mass -= self.tree[left]
                node = left + 1
        return node - (self.capacity - 1)


class ReplayBuffer:
    """Uniform FIFO replay (reference:
    `rllib/utils/replay_buffers/replay_buffer.py`). Ring-buffer list:
    O(1) random access (a deque indexes in O(n), which would dominate
    the learner's step at 50k capacity)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: list = []
        self._insert = 0
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._storage)

    def _append(self, row) -> int:
        """Returns the slot index the row landed in."""
        if len(self._storage) < self.capacity:
            self._storage.append(row)
            return len(self._storage) - 1
        slot = self._insert
        self._storage[slot] = row
        self._insert = (slot + 1) % self.capacity
        return slot

    def add_fragment(self, rollout: Dict[str, np.ndarray]) -> int:
        """Flatten a time-major [T, n_envs] fragment into transitions.

        Bootstrap mask = `terminateds` ONLY: a time-limit truncation is
        not a terminal state, so its target must bootstrap — from the
        TRUE final observation the limit cut off (`trunc_obs`), not the
        post-reset obs that follows it in the fragment."""
        obs, actions = rollout["obs"], rollout["actions"]
        rewards = rollout["rewards"]
        terms = rollout.get("terminateds", rollout["dones"])
        T, n_envs = actions.shape
        next_obs = np.concatenate(
            [obs[1:], rollout["final_obs"][None]], axis=0).copy()
        for k in range(len(rollout.get("trunc_t", ()))):
            next_obs[rollout["trunc_t"][k], rollout["trunc_env"][k]] = \
                rollout["trunc_obs"][k]
        n = 0
        for t in range(T):
            for e in range(n_envs):
                self._append(
                    (obs[t, e], int(actions[t, e]),
                     float(rewards[t, e]), next_obs[t, e],
                     float(terms[t, e])))
                n += 1
        return n

    def _rows_to_batch(self, rows, idx) -> Dict[str, np.ndarray]:
        obs, actions, rewards, next_obs, dones = zip(*rows)
        return {
            "obs": np.stack(obs).astype(np.float32),
            "actions": np.asarray(actions, np.int32),
            "rewards": np.asarray(rewards, np.float32),
            "next_obs": np.stack(next_obs).astype(np.float32),
            "dones": np.asarray(dones, np.float32),
            "idx": np.asarray(idx, np.int64),
            "weights": np.ones(len(rows), np.float32),
        }

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self._storage), size=batch_size)
        return self._rows_to_batch([self._storage[i] for i in idx], idx)

    def update_priorities(self, idx, priorities) -> None:
        """No-op for uniform replay (API parity with prioritized)."""


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al. 2016; reference:
    `rllib/utils/replay_buffers/prioritized_replay_buffer.py`).

    P(i) ∝ p_i^alpha with p_i = |td_i| + eps; importance-sampling weights
    w_i = (N * P(i))^-beta / max_j w_j correct the sampling bias. New
    transitions enter at the current max priority so every transition is
    seen at least once before its priority is trusted.
    """

    def __init__(self, capacity: int, seed: int = 0, *,
                 alpha: float = 0.6, eps: float = 1e-6):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.eps = eps
        self._tree = SumTree(capacity)
        self._max_prio = 1.0

    def _append(self, row) -> int:
        slot = super()._append(row)
        self._tree.set(slot, self._max_prio ** self.alpha)
        return slot

    def sample(self, batch_size: int,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        n = len(self._storage)
        total = self._tree.total()
        # Stratified: one draw per equal-mass segment (lower variance
        # than i.i.d. draws; what the reference's stratified loop does).
        seg = total / batch_size
        idx = np.empty(batch_size, np.int64)
        for k in range(batch_size):
            mass = self.rng.uniform(seg * k, seg * (k + 1))
            i = self._tree.find_prefix(mass)
            idx[k] = min(i, n - 1)
        probs = np.array([self._tree.get(int(i)) for i in idx]) / total
        weights = (n * probs) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        batch = self._rows_to_batch(
            [self._storage[int(i)] for i in idx], idx)
        batch["weights"] = weights
        return batch

    def update_priorities(self, idx, td_errors) -> None:
        for i, td in zip(np.asarray(idx), np.asarray(td_errors)):
            prio = abs(float(td)) + self.eps
            self._max_prio = max(self._max_prio, prio)
            self._tree.set(int(i), prio ** self.alpha)


class ReservoirReplayBuffer(ReplayBuffer):
    """Uniform-over-stream reservoir sampling (reference:
    `rllib/utils/replay_buffers/reservoir_replay_buffer.py`) — keeps an
    unbiased sample of ALL transitions ever seen, not the most recent
    window. The buffer of choice for average-policy nets (NFSP-style)."""

    def __init__(self, capacity: int, seed: int = 0):
        super().__init__(capacity, seed)
        self._seen = 0

    def _append(self, row) -> int:
        self._seen += 1
        if len(self._storage) < self.capacity:
            self._storage.append(row)
            return len(self._storage) - 1
        slot = int(self.rng.integers(0, self._seen))
        if slot < self.capacity:
            self._storage[slot] = row
            return slot
        return -1  # dropped (still counted in _seen)
