"""What the port's RLlib and utility tests send to workers: the multi-agent
env, its policy mapping functions, the module factories, the `Pool`
functions and the state API's tasks and actors. The port exports
functions and classes by reference (it has no cloudpickle), so they live
at this module's top level, where worker processes import them; the
reference's tests pass lambdas and test-local classes instead.

This module imports neither jax nor torch at its top: the reference's
runner uses `TargetMatch` in the test process too.
"""

import functools
import time

import numpy as np


class TargetMatch:
    """The reference test's 2-agent cooperative env
    (`tests/test_rllib_multiagent.py TargetMatch`): each agent observes a
    one-hot target and earns +1 for choosing it (agent_1's target is
    shifted by 1 — so a SHARED policy must read the obs, and INDEPENDENT
    policies learn different mappings). Episodes last `episode_len`
    steps (8); with `truncate=True` they end by truncation instead of
    termination, so the runner bootstraps V of the final observation."""

    possible_agents = ["agent_0", "agent_1"]
    N = 4

    def __init__(self, episode_len: int = 8, truncate: bool = False):
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._targets = {}
        self._episode_len = episode_len
        self._truncate = truncate

    def _obs(self):
        out = {}
        for aid in self.possible_agents:
            onehot = np.zeros(self.N, np.float32)
            onehot[self._targets[aid]] = 1.0
            out[aid] = onehot
        return out

    def _resample(self):
        base = int(self._rng.integers(0, self.N))
        self._targets = {"agent_0": base,
                         "agent_1": (base + 1) % self.N}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._resample()
        return self._obs(), {}

    def step(self, action_dict):
        rewards = {}
        for aid in self.possible_agents:
            want = self._targets[aid]
            got = action_dict.get(aid)
            rewards[aid] = 1.0 if got == want else 0.0
        self._t += 1
        self._resample()
        done = self._t >= self._episode_len
        terms = {"__all__": done and not self._truncate}
        truncs = {"__all__": done and self._truncate}
        return self._obs(), rewards, terms, truncs, {}


def shared(agent_id) -> str:
    return "shared"


def by_agent(agent_id) -> str:
    return "p0" if agent_id == "agent_0" else "p1"


def port_module_factory(hiddens=(32,)):
    """The reference test's `_module_factory`, the port's module."""
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

    return DiscreteMLPModule(obs_dim=TargetMatch.N,
                             num_actions=TargetMatch.N, hiddens=hiddens)


def jax_module_factory(hiddens=(32,)):
    from ray_tpu.rllib.core.rl_module import DiscreteMLPModule

    return DiscreteMLPModule(obs_dim=TargetMatch.N,
                             num_actions=TargetMatch.N, hiddens=hiddens)


truncating_target_match = functools.partial(TargetMatch, episode_len=6,
                                            truncate=True)


# -- Pool's functions ---------------------------------------------------------
def square(x):
    return x * x


def add(a, b):
    return a + b


def mul(a, b):
    return a * b


def plus_one(x):
    return x + 1


def identity(x):
    return x


def ninety_nine():
    return 99


# -- the state API's tasks and actors ---------------------------------------
def work(x):
    time.sleep(0.01)
    return x * 2


def fail():
    raise ValueError("boom")


class Pinger:
    def ping(self):
        return "pong"


class Hitter:
    def hit(self):
        return 1

