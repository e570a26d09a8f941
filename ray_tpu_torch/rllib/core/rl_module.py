"""RLModule: the neural-net policy, the port of
`ray_tpu/rllib/core/rl_module.py`.

A module is an `nn.Module` whose parameters carry the JAX package's
names and layouts (`pi_w0`, `vf_b_out`, `conv0_w` HWIO, `dense_w`
[in, out], ...), so `get_weights()` and `set_weights()` speak the
reference's flat dict of numpy arrays and weights cross between a JAX
learner and a port runner in both directions. Any layout conversion
happens inside `forward` (`models/cnn.py cnn_apply`). Parameters are
drawn from an explicit CPU `torch.Generator` (`reset_parameters`), at the
reference's scales: He normal (`sqrt(2 / fan_in)`) for trunks, 0.01 for
the policy head, 1.0 for the separate value MLP's head and
`sqrt(1 / trunk)` for a value head on a shared trunk.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ray_tpu_torch.models.cnn import CNNConfig, cnn_apply, cnn_init


class _FlatParamsModule(nn.Module):
    """Parameters registered under the reference's flat names."""

    def _draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _build(self, generator: Optional[torch.Generator]) -> None:
        """Registers the parameters, drawn from `generator` (None: a CPU
        generator seeded with 0)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, value in self._draw(generator).items():
            self.register_parameter(name, nn.Parameter(value))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draws every parameter anew from `generator` (a CPU generator)
        in place, on the module's device."""
        with torch.no_grad():
            for name, value in self._draw(generator).items():
                getattr(self, name).copy_(value)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def get_weights(self) -> Dict[str, np.ndarray]:
        """The reference's flat dict: float32 numpy arrays on the host."""
        return {name: p.detach().cpu().numpy().copy()
                for name, p in self.named_parameters()}

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        """Copies the reference's flat dict into the parameters in place
        (an optimizer holding them keeps its state)."""
        own = self.params()
        if set(weights) != set(own):
            raise ValueError(
                f"weights {sorted(weights)} do not match the module's "
                f"parameters {sorted(own)}")
        with torch.no_grad():
            for name, p in own.items():
                value = np.asarray(weights[name], np.float32)
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {value.shape}, the "
                                     f"module's is {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(value)))


def _normal(generator, shape, scale):
    return torch.randn(shape, generator=generator) * scale


class DiscreteMLPModule(_FlatParamsModule):
    """obs -> (logits [B, A], value [B]).

    Separate policy and value MLPs by default, the reference's fcnet
    Catalog default (`vf_share_layers=False`): a shared trunk lets large
    early value errors push gradients through the policy body and stall
    learning on dense-reward envs like CartPole."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64),
                 vf_share_layers: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.vf_share_layers = vf_share_layers
        self._build(generator)

    def _mlp(self, generator, prefix, out_dim, out_scale, params):
        sizes = [self.obs_dim, *self.hiddens]
        for i in range(len(sizes) - 1):
            params[f"{prefix}w{i}"] = _normal(generator, (sizes[i], sizes[i + 1]),
                                          (2.0 / sizes[i]) ** 0.5)
            params[f"{prefix}b{i}"] = torch.zeros((sizes[i + 1],))
        params[f"{prefix}w_out"] = _normal(generator, (sizes[-1], out_dim),
                                       out_scale)
        params[f"{prefix}b_out"] = torch.zeros((out_dim,))

    def _draw(self, generator):
        params: Dict[str, torch.Tensor] = {}
        # Small-init policy head: near-uniform initial policy.
        self._mlp(generator, "pi_", self.num_actions, 0.01, params)
        if not self.vf_share_layers:
            self._mlp(generator, "vf_", 1, 1.0, params)
        else:
            trunk = self.hiddens[-1] if self.hiddens else self.obs_dim
            params["vf_w_out"] = _normal(generator, (trunk, 1),
                                     (1.0 / trunk) ** 0.5)
            params["vf_b_out"] = torch.zeros((1,))
        return params

    def _trunk(self, prefix, obs):
        x = obs
        for i in range(len(self.hiddens)):
            x = torch.tanh(x @ getattr(self, f"{prefix}w{i}")
                           + getattr(self, f"{prefix}b{i}"))
        return x

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._trunk("pi_", obs)
        logits = x @ self.pi_w_out + self.pi_b_out
        if not self.vf_share_layers:
            x = self._trunk("vf_", obs)
        value = (x @ self.vf_w_out + self.vf_b_out)[..., 0]
        return logits, value


class DiscreteConvModule(_FlatParamsModule):
    """Image obs (B, H, W, C) -> (logits [B, A], value [B]): the
    Nature-CNN trunk shared by the policy and value heads (the
    reference's VisionNetwork default for Atari)."""

    def __init__(self, obs_shape: Tuple[int, int, int], num_actions: int,
                 dense: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = obs_shape
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.dense = dense
        self._cfg = CNNConfig(input_hw=(h, w), input_channels=c,
                              dense=dense)
        self._build(generator)

    def _draw(self, generator):
        params = cnn_init(generator, self._cfg, device="cpu")
        params["pi_w_out"] = _normal(generator, (self.dense, self.num_actions),
                                 0.01)
        params["pi_b_out"] = torch.zeros((self.num_actions,))
        params["vf_w_out"] = _normal(generator, (self.dense, 1),
                                 (1.0 / self.dense) ** 0.5)
        params["vf_b_out"] = torch.zeros((1,))
        return params

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = cnn_apply(self.params(), self._cfg, obs)
        logits = feat @ self.pi_w_out + self.pi_b_out
        value = (feat @ self.vf_w_out + self.vf_b_out)[..., 0]
        return logits, value


def make_discrete_module(obs_shape, num_actions: int,
                         hiddens: Sequence[int] = (64, 64),
                         model: str = "auto"):
    """Catalog entry point (reference: models/catalog.py get_model_v2):
    image-shaped observations (3-D) get the conv module, flat ones the
    MLP. The module is built on the CPU; its owner moves it."""
    shape = tuple(int(s) for s in np.atleast_1d(obs_shape))
    use_conv = (model == "conv"
                or (model == "auto" and len(shape) == 3))
    if use_conv:
        if len(shape) != 3:
            raise ValueError(
                f"conv model needs (H, W, C) observations, got {shape}")
        return DiscreteConvModule(obs_shape=shape, num_actions=num_actions)
    return DiscreteMLPModule(obs_dim=int(np.prod(shape)),
                             num_actions=num_actions,
                             hiddens=tuple(hiddens))


def module_params_from_jax(jax_params, module: _FlatParamsModule):
    """Loads the JAX module's parameter dict (leaves as numpy arrays or
    jax arrays) into `module`'s parameters; returns the module."""
    module.set_weights({k: np.asarray(v) for k, v in jax_params.items()})
    return module


def categorical_logp(logits: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp_all, 1, actions[:, None].long())[:, 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)
