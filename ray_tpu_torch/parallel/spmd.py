"""Training-step construction: the single-device half of
`ray_tpu/parallel/spmd.py`.

`make_train_step` keeps JAX's call shape, `step(params, opt_state, batch)
-> (params, opt_state, loss)`, so the port's training loop reads like the
JAX package's. The difference is ownership: JAX returns new params and
optimizer state, while here the params dict's leaves are updated in place
by a `torch.optim.AdamW`, which is the optimizer state; the same objects
are returned.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

Params = Dict[str, Any]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    raise TypeError(f"params hold a {type(tree).__name__}, not tensors")


class adamw:
    """`optax.adamw(learning_rate)` with optax's defaults pinned onto
    `torch.optim.AdamW`: b1 0.9, b2 0.999, eps 1e-8 (added to sqrt(v),
    as optax does), and weight decay 1e-4 decoupled and scaled by the
    learning rate (torch's default would be 0.01). As in optax, the
    settings live here and the state holds the moments: `update` applies
    this optimizer's settings whichever `adamw` made the state."""

    def __init__(self, learning_rate: float):
        self.settings = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)

    def init(self, params: Params) -> torch.optim.AdamW:
        """The optimizer state: an AdamW over every leaf of `params`, each
        leaf made a leaf of autograd (`requires_grad`)."""
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, **self.settings)

    def update(self, opt_state: torch.optim.AdamW) -> None:
        """One AdamW step of the leaves' `.grad`, in place."""
        for group in opt_state.param_groups:
            group.update(self.settings)
        opt_state.step()


def make_train_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                    optimizer: adamw) -> Callable:
    """loss_fn(params, batch) -> scalar. Returns
    step(params, opt_state, batch) -> (params, opt_state, loss): the
    gradient of loss_fn, then one `optimizer` update of the params in
    place; `opt_state` comes from an `adamw(...).init(params)`. loss is
    detached."""

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.update(opt_state)
        return params, opt_state, loss.detach()

    return step


def make_eval_step(loss_fn: Callable[[Params, Any], torch.Tensor]
                   ) -> Callable:
    """loss_fn without gradients."""

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return step
