"""SPMD training: sharded params and the train step, the port of
`ray_tpu/parallel/spmd.py`.

Sharding. A spec (`PartitionSpec`, `P`) names, for each dim of a tensor, the
mesh axis that shards it or None, as JAX's does; on a mesh it becomes
DTensor placements (`placements`). `shard_pytree` and `init_sharded` give
params as DTensors, each rank holding its share of every leaf;
`batch_sharding` gives a token batch's placements.

Manual regions. The sharded model (`models/transformer.py`), the pipeline
(`parallel/pipeline.py`) and the ring (`ops/attention.py`) run on each
rank's local blocks, as JAX's `shard_map` bodies do, with the collectives of
`parallel/collectives.py`. `to_local` and `from_local` are the region's
edges: a value entering it replicated over some axes sums its copies'
gradients there (a param's all-reduce or reduce-scatter), and a value
leaving it replicated hands each copy its share, so the gradients are those
of the unsharded program.

The step. `make_train_step` keeps JAX's call shape, `step(params,
opt_state, batch) -> (params, opt_state, loss)`, so the port's training
loop reads like the JAX package's. The difference is ownership: JAX
returns new params and optimizer state, while here the params dict's
leaves (plain tensors or DTensors) are updated in place by a
`torch.optim.AdamW`, which is the optimizer state; the same objects are
returned.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from ray_tpu_torch.parallel.collectives import scale_grad

Params = Dict[str, Any]


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: entry i is the mesh axis that shards
    dim i of a tensor, a tuple of axes (in mesh order), or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def placements(mesh: DeviceMesh, spec: Sequence) -> Tuple[Placement, ...]:
    """The spec as DTensor placements on `mesh`, one a mesh axis: Shard(i)
    on the axis that shards dim i, Replicate on the others."""
    names = mesh.mesh_dim_names
    out: List[Placement] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: the axes sharding one dim must come "
                             f"in mesh order {names}")
        for axis in axes:
            i = names.index(axis)
            if out[i] != Replicate():
                raise ValueError(f"{spec} uses mesh axis {axis!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts, lists and tuples (and the
    matching leaves of `rest`, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def local_block(t: torch.Tensor, mesh: DeviceMesh,
                place: Sequence[Placement]) -> torch.Tensor:
    """This rank's block of a tensor that every rank holds whole, under
    `place`; each sharded dim must divide by its axes' sizes."""
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of {tuple(t.shape)} does not divide over "
                    f"mesh axis {mesh.mesh_dim_names[i]!r} of size {n}")
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return t


def shard_pytree(tree, specs, mesh: DeviceMesh):
    """Every leaf as a DTensor on `mesh` placed by its spec (None:
    replicated). A plain leaf, which every rank holds whole, leaves each
    rank a copy of its own block; a DTensor leaf is redistributed."""

    def shard(t, spec):
        place = placements(mesh, spec or ())
        if isinstance(t, DTensor):
            return t.redistribute(mesh, place)
        local = local_block(t.detach(), mesh, place).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_map(shard, tree, specs)


def init_sharded(init_fn: Callable, specs, mesh: DeviceMesh, *args):
    """init_fn(*args)'s tree, sharded by `specs`: the same values as the
    unsharded call (same generator, same seed). The whole tree exists on
    each rank until it is sharded; each rank then keeps its share."""
    return shard_pytree(init_fn(*args), specs, mesh)


def batch_sharding(mesh: DeviceMesh, *, batch_axis: str = "dp",
                   seq_axis: Optional[str] = None
                   ) -> Tuple[Placement, ...]:
    """Placements for a [B, S(+1)] token batch: rows over `batch_axis`; the
    sequence dim over `seq_axis` if given (default: replicated, since the
    +1 of next-token targets rarely divides the sp axis; the model takes its
    sequence block itself)."""
    names = mesh.mesh_dim_names
    seq = seq_axis if (seq_axis and seq_axis in names) else None
    return placements(mesh, P(batch_axis, seq))


def _stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """A contiguous tensor's strides for `shape`."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def _copies(mesh: DeviceMesh, place: Sequence[Placement]) -> int:
    return math.prod(mesh.size(i) for i, p in enumerate(place)
                     if not isinstance(p, Shard))


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, place):
        ctx.mesh, ctx.place = t.device_mesh, tuple(place)
        ctx.orig = tuple(Replicate() if p.is_partial() else p
                         for p in t.placements)
        ctx.shape = t.shape
        if tuple(t.placements) != ctx.place:
            t = t.redistribute(ctx.mesh, ctx.place)
        return t.to_local().view_as(t.to_local())

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        # Every copy's gradient counts: the axes that replicate the local
        # block sum them (size-1 axes hold one copy and need no sum).
        grad_place = [Partial() if p.is_replicate() and mesh.size(i) > 1
                      else p for i, p in enumerate(ctx.place)]
        grad = DTensor.from_local(g.contiguous(), mesh, grad_place,
                                  run_check=False, shape=ctx.shape,
                                  stride=_stride(ctx.shape))
        return grad.redistribute(mesh, ctx.orig), None


class _FromLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, place, shape):
        ctx.mesh, ctx.place = mesh, tuple(place)
        return DTensor.from_local(
            x, mesh, place, run_check=False, shape=shape,
            stride=None if shape is None else _stride(shape))

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = g.redistribute(ctx.mesh, ctx.place).to_local()
        return g, None, None, None


def to_local(t: torch.Tensor, place: Optional[Sequence[Placement]] = None
             ) -> torch.Tensor:
    """A DTensor's local block under `place` (default: its own placements),
    entering a manual region: its gradient is summed over the axes that
    replicate the block, then brought back to the DTensor's placements. A
    plain tensor passes as it is."""
    if not isinstance(t, DTensor):
        return t
    return _ToLocal.apply(t, tuple(place or t.placements))


def from_local(x: torch.Tensor, mesh: DeviceMesh,
               place: Sequence[Placement],
               shape: Optional[torch.Size] = None) -> DTensor:
    """This rank's block x as a DTensor, leaving a manual region: each of
    the block's copies (over the axes `place` replicates) gets 1/copies of
    the gradient, since `to_local` sums the copies again."""
    x = scale_grad(x, 1.0 / _copies(mesh, place))
    return _FromLocal.apply(x, mesh, tuple(place), shape)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    raise TypeError(f"params hold a {type(tree).__name__}, not tensors")


class _AdamW(torch.optim.AdamW):
    """`torch.optim.AdamW` over the leaves' local blocks: a DTensor leaf's
    update runs on its local tensor (AdamW is elementwise, so that is the
    DTensor's update, with no DTensor dispatch), its gradient taken from
    the DTensor's `.grad`, which autograd leaves in the leaf's placements.
    Plain leaves are their own blocks."""

    def __init__(self, leaves: List[torch.Tensor], **settings):
        self.leaves = leaves
        with torch.no_grad():
            blocks = [t.to_local() if isinstance(t, DTensor) else t
                      for t in leaves]
        super().__init__(blocks, **settings)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in self.leaves:
            t.grad = None
        super().zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        for t, block in zip(self.leaves, self.param_groups[0]["params"]):
            if t is not block:
                block.grad = None if t.grad is None else t.grad.to_local()
        return super().step(closure)


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
        """The optimizer state: an AdamW over every leaf of `params` (plain
        tensors or DTensors), each leaf made a leaf of autograd
        (`requires_grad`)."""
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return _AdamW(leaves, **self.settings)

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
