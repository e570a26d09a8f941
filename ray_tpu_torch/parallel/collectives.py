"""Collectives over one named mesh axis, differentiable: the parts of
`jax.lax` (`axis_size`, `axis_index`, `psum`, `ppermute`, `all_gather`,
`psum_scatter`) that the parallel layer uses inside its manual regions.

A manual region (the model's sharded body, a pipeline stage, the ring) runs
on each rank's local blocks, as a JAX `shard_map` body does. Its gradients
follow JAX's convention for such bodies (`check_vma=False`): every rank's
value is its own variable and each collective's backward is its transpose:

- `psum` (all-reduce sum) transposes to `psum`;
- `all_gather` to `psum_scatter` (reduce-scatter), and back;
- `ppermute` to the reverse permutation.

A value that leaves the region replicated over some axes hands each copy
1/n of its gradient (`spmd.from_local`), and a value that enters it
replicated sums its copies' gradients (`spmd.to_local`), so the result is
the gradient of the unsharded program. Every function is the identity on a
group of one rank and then issues no collective.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup


def axis_size(group: ProcessGroup) -> int:
    return dist.get_world_size(group)


def axis_index(group: ProcessGroup) -> int:
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = axis_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """Each (src, dst) pair of group ranks sends src's x to dst; a rank that
    no pair sends to gets zeros, as `lax.ppermute` gives."""
    me = axis_index(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops: List[dist.P2POp] = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group,
                        [(dst, src) for src, dst in ctx.perm]), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _on_graph(x: torch.Tensor) -> torch.Tensor:
    """x as an input that makes the collective a node of the autograd graph
    whenever gradients are on. Each rank's backward must run the same
    collectives; one rank's input can be a constant (zeros, a pipeline
    stage's unused slot) where another's has a gradient."""
    if torch.is_grad_enabled() and not x.requires_grad:
        return x.detach().requires_grad_()
    return x


def psum(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Sum of x over the group's ranks, on every rank."""
    if axis_size(group) == 1:
        return x
    return _Psum.apply(_on_graph(x), group)


def all_gather(x: torch.Tensor, group: ProcessGroup,
               dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along `dim`, in rank order."""
    if axis_size(group) == 1:
        return x
    return _AllGather.apply(_on_graph(x), group, dim)


def psum_scatter(x: torch.Tensor, group: ProcessGroup,
                 dim: int = 0) -> torch.Tensor:
    """This rank's block (along `dim`) of x summed over the group."""
    if axis_size(group) == 1:
        return x
    return _PsumScatter.apply(_on_graph(x), group, dim)


def ppermute(x: torch.Tensor, group: ProcessGroup,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`lax.ppermute`: (src, dst) pairs of group ranks; a rank that
    receives nothing gets zeros. Integer tensors pass too (no gradient)."""
    perm = [tuple(p) for p in perm]
    if axis_size(group) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    if not x.is_floating_point():
        return _permute(x, group, perm)
    return _Ppermute.apply(_on_graph(x), group, perm)


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x, with its gradient multiplied by `factor` on the way back."""
    if factor == 1.0:
        return x
    return _ScaleGrad.apply(x, factor)
