"""Synthetic Atari-class image environment + preprocessing wrappers, a
copy of `ray_tpu/rllib/env/synthetic_atari.py` (numpy only): the same
seed gives the same frames, bit for bit.

The substitute for ALE, which the project does not depend on: an 84x84
pixel control task with the same observation contract as wrapped Atari
(uint8, frame-stacked), learnable from pixels only. Reference
equivalents: the wrapper stack in `rllib/env/wrappers/atari_wrappers.py`
(grayscale, resize, frame stack, reward clip) and the tuned Atari configs
(`rllib/tuned_examples/ppo/atari-ppo.yaml:1-35`).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional, Tuple

import numpy as np


class _Box:
    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


class _Discrete:
    def __init__(self, n):
        self.n = n


class SyntheticAtariEnv:
    """A bright paddle and a falling block, pixels only.

    The block falls one row per step in a random column; the paddle sits
    on the bottom row and moves left/right/stay (3 actions). Catching the
    block scores +1, missing scores -1, then a new block drops. The
    optimal policy must LOCATE both sprites in the frame — a pure
    pixel->control task with the same interface and observation dtype as
    wrapped ALE. Episode ends after `max_blocks` drops.
    """

    H = W = 84
    PADDLE_HALF = 4      # paddle is 9 px wide, 2 px tall
    BLOCK = 4            # block is 4x4 px

    def __init__(self, max_blocks: int = 8, frame_stack: int = 4,
                 seed: Optional[int] = None):
        self.max_blocks = max_blocks
        self.frame_stack = frame_stack
        self.observation_space = _Box((self.H, self.W, frame_stack),
                                      np.uint8)
        self.action_space = _Discrete(3)
        self._rng = np.random.default_rng(seed)
        self._frames: deque = deque(maxlen=frame_stack)

    # gymnasium-compatible API ------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options: Any = None
              ) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle = self.W // 2
        self._blocks_done = 0
        self._new_block()
        frame = self._render()
        self._frames.clear()
        for _ in range(self.frame_stack):
            self._frames.append(frame)
        return self._obs(), {}

    def step(self, action: int):
        if action == 0:
            self._paddle = max(self.PADDLE_HALF, self._paddle - 3)
        elif action == 2:
            self._paddle = min(self.W - 1 - self.PADDLE_HALF,
                               self._paddle + 3)
        self._block_y += 2
        reward = 0.0
        if self._block_y >= self.H - 3:  # reached the paddle row
            caught = abs(self._block_x - self._paddle) <= (
                self.PADDLE_HALF + self.BLOCK // 2)
            reward = 1.0 if caught else -1.0
            self._blocks_done += 1
            self._new_block()
        terminated = self._blocks_done >= self.max_blocks
        self._frames.append(self._render())
        return self._obs(), reward, terminated, False, {}

    def close(self) -> None:
        pass

    # internals ---------------------------------------------------------
    def _new_block(self) -> None:
        self._block_x = int(self._rng.integers(
            self.BLOCK, self.W - self.BLOCK))
        self._block_y = 4

    def _render(self) -> np.ndarray:
        frame = np.zeros((self.H, self.W), np.uint8)
        y, x = self._block_y, self._block_x
        frame[max(0, y - self.BLOCK):y, x - self.BLOCK // 2:
              x + self.BLOCK // 2] = 255
        frame[self.H - 2:, self._paddle - self.PADDLE_HALF:
              self._paddle + self.PADDLE_HALF + 1] = 180
        return frame

    def _obs(self) -> np.ndarray:
        return np.stack(list(self._frames), axis=-1)


# -- generic preprocessing wrappers (for real ALE when available) --------

class GrayscaleResize:
    """RGB frames -> grayscale 84x84 uint8 (reference: WarpFrame).
    Pure-numpy resize (area averaging) — no cv2 dependency."""

    def __init__(self, env, size: int = 84):
        self.env = env
        self.size = size
        self.action_space = env.action_space
        self.observation_space = _Box((size, size), np.uint8)

    def _transform(self, frame: np.ndarray) -> np.ndarray:
        if frame.ndim == 3:
            frame = (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
                     + 0.114 * frame[..., 2])
        h, w = frame.shape
        ys = np.linspace(0, h, self.size + 1).astype(int)
        xs = np.linspace(0, w, self.size + 1).astype(int)
        out = np.zeros((self.size, self.size), np.float32)
        for i in range(self.size):
            rows = frame[ys[i]:max(ys[i + 1], ys[i] + 1)]
            for j in range(self.size):
                out[i, j] = rows[:, xs[j]:max(xs[j + 1], xs[j] + 1)].mean()
        return out.astype(np.uint8)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return self._transform(np.asarray(obs)), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return self._transform(np.asarray(obs)), r, term, trunc, info

    def close(self):
        self.env.close()


class FrameStack:
    """Stack the last k grayscale frames along a channel axis
    (reference: FrameStack in atari_wrappers)."""

    def __init__(self, env, k: int = 4):
        self.env = env
        self.k = k
        h, w = env.observation_space.shape[:2]
        self.observation_space = _Box((h, w, k), np.uint8)
        self.action_space = env.action_space
        self._frames: deque = deque(maxlen=k)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        for _ in range(self.k):
            self._frames.append(obs)
        return np.stack(list(self._frames), axis=-1), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        self._frames.append(obs)
        return (np.stack(list(self._frames), axis=-1), r, term, trunc,
                info)

    def close(self):
        self.env.close()


class ClipReward:
    """Sign-clip rewards (reference: ClipRewardEnv)."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return obs, float(np.sign(r)), term, trunc, info

    def close(self):
        self.env.close()


def wrap_atari(env, frame_stack: int = 4):
    """The standard preprocessing pipeline for a raw RGB Atari env."""
    return FrameStack(ClipReward(GrayscaleResize(env)), k=frame_stack)
