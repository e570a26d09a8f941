"""IMPALA/APPO learner: V-trace off-policy correction, the port of
`ray_tpu/rllib/core/impala_learner.py`.

One optimizer step per arriving time-major [T, B] batch (no epoch
replay, the IMPALA contract). The reference's reverse `lax.scan` over T
is a reverse loop over T on the learner's device under
`torch.no_grad()`: V-trace's targets and advantages carry no gradient
(the reference's `stop_gradient` on `vs`, `pg_adv` and `rhos`), so the
bootstrap value of `final_obs` is computed without one too.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.core.learner import learner_device, to_device
from ray_tpu_torch.rllib.core.rl_module import (categorical_entropy,
                                                categorical_logp)


@torch.no_grad()
def vtrace_returns(values, bootstrap, rewards, nonterminal, rhos, *,
                   gamma: float, rho_clip: float, c_clip: float):
    """V-trace targets vs_t and policy-gradient advantages
    (Espeholt et al. 2018, eqs. 1-2). All inputs time-major [T, B];
    `rhos` are the raw importance ratios pi/mu."""
    clipped_rho = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    values_tp1 = torch.cat([values[1:], bootstrap[None]], dim=0)
    deltas = clipped_rho * (
        rewards + gamma * nonterminal * values_tp1 - values)
    vs_minus_v = torch.empty_like(values)
    carry = torch.zeros_like(bootstrap)
    for t in range(values.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * nonterminal[t] * cs[t] * carry
        vs_minus_v[t] = carry
    vs = values + vs_minus_v
    vs_tp1 = torch.cat([vs[1:], bootstrap[None]], dim=0)
    pg_adv = clipped_rho * (
        rewards + gamma * nonterminal * vs_tp1 - values)
    return vs, pg_adv


def impala_loss(module, batch: Dict[str, torch.Tensor], *, gamma: float,
                rho_clip: float, c_clip: float, vf_coeff: float,
                entropy_coeff: float, use_clip_loss: bool,
                clip_param: float):
    """V-trace actor-critic loss; `use_clip_loss` switches the policy term
    to APPO's clipped surrogate over the same v-trace advantages."""
    T, B = batch["actions"].shape
    obs = batch["obs"]
    logits, values = module(obs.reshape((T * B,) + tuple(obs.shape[2:])))
    values = values.reshape(T, B)
    with torch.no_grad():
        _, bootstrap = module(batch["final_obs"])

    logp = categorical_logp(
        logits, batch["actions"].reshape(T * B)).reshape(T, B)
    log_rhos = logp - batch["logp_old"]
    rhos = torch.exp(log_rhos)
    nonterminal = 1.0 - batch["dones"]
    vs, pg_adv = vtrace_returns(
        values.detach(), bootstrap, batch["rewards"], nonterminal,
        rhos.detach(), gamma=gamma, rho_clip=rho_clip, c_clip=c_clip)

    if use_clip_loss:
        # APPO: PPO's clipped surrogate with v-trace advantages.
        surr = torch.minimum(
            rhos * pg_adv,
            torch.clamp(rhos, 1.0 - clip_param, 1.0 + clip_param) * pg_adv)
        policy_loss = -torch.mean(surr)
    else:
        policy_loss = -torch.mean(logp * pg_adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy = torch.mean(categorical_entropy(logits))
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    stats = {"policy_loss": policy_loss, "vf_loss": vf_loss,
             "entropy": entropy, "total_loss": total,
             "mean_rho": torch.mean(rhos)}
    return total, stats


class ImpalaLearner:
    """One optimizer step per arriving time-major batch.
    `config["device"]`: None means `cuda:0` and raises without a card."""

    def __init__(self, module, config: Dict[str, Any]):
        self.config = config
        self.device = learner_device(config)
        module.reset_parameters(
            torch.Generator().manual_seed(config.get("seed", 0)))
        self.module = module.to(self.device)
        self.optimizer = torch.optim.Adam(self.module.parameters(),
                                          lr=config.get("lr", 5e-4),
                                          eps=1e-8)
        self._loss_kwargs = dict(
            gamma=config.get("gamma", 0.99),
            rho_clip=config.get("vtrace_rho_clip", 1.0),
            c_clip=config.get("vtrace_c_clip", 1.0),
            vf_coeff=config.get("vf_coeff", 0.5),
            entropy_coeff=config.get("entropy_coeff", 0.01),
            use_clip_loss=config.get("use_clip_loss", False),
            clip_param=config.get("clip_param", 0.2))

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        self.optimizer.zero_grad()
        total, stats = impala_loss(self.module,
                                   to_device(batch, self.device),
                                   **self._loss_kwargs)
        total.backward()
        self.optimizer.step()
        values = torch.stack([v.detach() for v in stats.values()])
        return dict(zip(stats, values.tolist()))

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.module.get_weights()

    def set_weights(self, weights) -> None:
        self.module.set_weights(weights)
