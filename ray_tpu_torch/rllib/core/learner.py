"""PPOLearner: clipped-surrogate minibatch SGD, the port of
`ray_tpu/rllib/core/learner.py`.

The reference jits loss, gradient and `optax.adam` into one step, and
under a multi-learner group shards the batch over a `dp` mesh so that XLA
inserts the gradient psum. Here the step is eager PyTorch with
`torch.optim.Adam` (the same bias-corrected update, eps 1e-8 outside the
square root), and a learner inside a group (`distributed=True`, the
process group joined by `train/backend.py TorchConfig`) all-reduces its
gradients after `backward()` and averages them over the gang before its
Adam step: the gradient of the mean over the global minibatch, which is
what the reference's psum gives.

`config["device"]`: None means `cuda:0` and raises without a card. On a
card the learner turns TF32 off for matmuls and cuDNN, as the serving
engine does, so its float32 math stays float32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.core.rl_module import (categorical_entropy,
                                                categorical_logp)


def ppo_loss(module, batch: Dict[str, torch.Tensor], *, clip_param: float,
             vf_coeff: float, entropy_coeff: float, vf_clip: float):
    logits, value = module(batch["obs"])
    logp = categorical_logp(logits, batch["actions"])
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * adv)
    policy_loss = -torch.mean(surr)
    # Reference vf-clip semantics (ppo_torch_learner.py): cap the squared
    # error at vf_clip.
    vf_loss = torch.mean(torch.clamp(
        (value - batch["value_targets"]) ** 2, max=vf_clip))
    entropy = torch.mean(categorical_entropy(logits))
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    stats = {"policy_loss": policy_loss, "vf_loss": vf_loss,
             "entropy": entropy, "total_loss": total,
             "mean_kl": torch.mean(batch["logp_old"] - logp)}
    return total, stats


def learner_device(config: Dict[str, Any]) -> torch.device:
    """The learner's device from its config; TF32 off on a card."""
    device = resolve_device(config.get("device"))
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def average_over_gang(tensors) -> None:
    """All-reduces `tensors` in place, as one flat buffer, and divides by
    the world size."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class PPOLearner:
    def __init__(self, module, config: Dict[str, Any],
                 distributed: bool = False):
        self.config = config
        self.device = learner_device(config)
        module.reset_parameters(
            torch.Generator().manual_seed(config.get("seed", 0)))
        self.module = module.to(self.device)
        self.optimizer = torch.optim.Adam(self.module.parameters(),
                                          lr=config.get("lr", 3e-4),
                                          eps=1e-8)
        self._distributed = distributed
        self._loss_kwargs = dict(
            clip_param=config.get("clip_param", 0.2),
            vf_coeff=config.get("vf_coeff", 0.5),
            entropy_coeff=config.get("entropy_coeff", 0.0),
            vf_clip=config.get("vf_clip", 10.0))

    def _step(self, mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad()
        total, stats = ppo_loss(self.module, mb, **self._loss_kwargs)
        total.backward()
        if self._distributed:
            average_over_gang([p.grad for p in self.module.parameters()])
        self.optimizer.step()
        return stats

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Minibatch SGD over the (local shard of the) train batch."""
        n = len(batch["obs"])
        minibatch = self.config.get("minibatch_size", n) or n
        epochs = self.config.get("num_epochs", 1)
        # Advantage normalization over the local shard.
        adv = batch["advantages"]
        batch = dict(batch,
                     advantages=(adv - adv.mean()) / (adv.std() + 1e-8))
        # The reference's permutation, so the minibatches match its own.
        rng = np.random.default_rng(self.config.get("seed", 0))
        stats = {}
        for _ in range(epochs):
            perm = rng.permutation(n)
            for lo in range(0, n, minibatch):
                idx = perm[lo:lo + minibatch]
                stats = self._step(to_device(
                    {k: v[idx] for k, v in batch.items()}, self.device))
        values = torch.stack([v.detach() for v in stats.values()])
        if self._distributed:
            # The reference's stats are over the global minibatch: the
            # mean of the gang's equal shards' means.
            average_over_gang([values])
        return dict(zip(stats, values.tolist()))

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.module.get_weights()

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self.module.set_weights(weights)
