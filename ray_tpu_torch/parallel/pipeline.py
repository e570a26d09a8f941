"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis, the
port of `ray_tpu/parallel/pipeline.py`.

Stages live on ``pp`` ranks; microbatch activations flow between neighbours
through `ppermute` in a manual region that is manual over pp (and sp when
sp > 1). The schedule has n_micro + n_stages - 1 slots, as JAX's scan does;
stage r computes microbatch t - r at slot t, and a slot outside that window
(the bubble) computes nothing here, where JAX computes a result it throws
away. Only the last stage's outputs count: they are summed over pp, so
every pp rank holds them. Backward runs through the same schedule in
reverse (each `ppermute`'s transpose is the reverse hop).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ray_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                axis_size, ppermute, psum)
from ray_tpu_torch.parallel.spmd import shard_pytree, to_local, tree_map


def _micro_rows(r: int, b_loc: int, n_micro: int, n: int) -> torch.Tensor:
    """Microbatch i is the global rows [i mb, (i + 1) mb), as JAX's reshape
    of the global batch makes it, and `n` data-parallel ranks hold b_loc
    contiguous rows each. The global rows that rank r takes instead, 1/n of
    every microbatch, microbatch-major: its row i mb_loc + j is global row
    i mb + r mb_loc + j."""
    mb = b_loc * n // n_micro
    if mb % n:
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"{n} data-parallel ranks")
    mb_loc = mb // n
    return torch.tensor([i * mb + r * mb_loc + j for i in range(n_micro)
                         for j in range(mb_loc)])


class _Tie(torch.autograd.Function):
    """a, unchanged, with `b` made one of its inputs: the backward hands b a
    zero gradient, so b's own backward runs whenever a's does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b_shape = b.shape
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.b_shape)


def _schedule(stage_fn, stage_p, x_mb: List[torch.Tensor], positions,
              consts, group):
    """The GPipe slots on one pp rank: (outputs of every microbatch, held
    by the last stage and zeros elsewhere, summed over pp; this rank's aux
    summed over its window)."""
    n_stages, rank = axis_size(group), axis_index(group)
    n_micro = len(x_mb)
    outs = [torch.zeros_like(x) for x in x_mb]
    aux_sum = x_mb[0].new_zeros((), dtype=torch.float32)
    recv = None
    for t in range(n_micro + n_stages - 1):
        # Each rank's real compute window is rank <= t < rank + n_micro;
        # outside it JAX's stage chews bubble garbage, which counts nowhere.
        in_window = rank <= t < rank + n_micro
        y = None
        if in_window:
            y, aux = stage_fn(stage_p, x_mb[t] if rank == 0 else recv,
                              positions, consts)
            aux_sum = aux_sum + aux
            if rank == n_stages - 1:
                outs[t - rank] = y
        # Stage s sends its slot-t output to s + 1 while t is inside its
        # window; every rank knows the schedule, so all agree on the pairs.
        hops = [(s, s + 1) for s in range(n_stages - 1)
                if s <= t < s + n_micro]
        if hops:
            recv = ppermute(torch.zeros_like(x_mb[0]) if y is None else y,
                            group, hops)
            # The hop's backward returns the gradient of what this rank
            # sent; it must run on every rank, also where what this rank
            # received goes unused (a rank that only sends).
            if recv.requires_grad:
                aux_sum = _Tie.apply(aux_sum, recv)
    return psum(torch.stack(outs), group), aux_sum


def gpipe(stage_fn: Callable, stage_params, x: torch.Tensor,
          positions: torch.Tensor, consts=(), *, mesh,
          num_microbatches: int, pp_axis: str = "pp", sp_axis: str = "sp",
          param_specs=None):
    """Run `stage_fn(stage_p, x_micro, positions, consts) -> (y, aux)` as a
    pipeline, inside a manual region.

    stage_params: a pytree of DTensors with a leading [n_stages] dim
    sharded over `pp_axis` (redistributed to `param_specs` first when
    given); `stage_fn` gets this rank's stage, each leaf's local block with
    the stage dim dropped (dp and tp shards stay shards). x: this rank's
    activations [B/dp, S, D], its rows of the batch (every pp rank the
    same); positions [S] global. The region is manual over pp, and over
    `sp_axis` when that axis is > 1: then `stage_fn` sees this rank's
    sequence block and its positions, and its attention must run the ring
    body (`ops.attention.attention(manual_sp=True)`). Microbatch i is the
    global rows [i B/n, (i + 1) B/n), as in JAX, so a stage that mixes rows
    (MoE gating) sees JAX's microbatches. consts: tensors every rank holds
    whole (rotary tables), passed through.

    Returns (y: this rank's [B/dp, S/sp, D] block of the last stage's
    outputs, on every pp rank; aux: the stages' aux summed over pp and
    divided by num_microbatches, averaged over sp blocks, the same on
    every rank)."""
    names = mesh.mesh_dim_names
    group = mesh.get_group(pp_axis)
    sp_manual = sp_axis in names and mesh.size(names.index(sp_axis)) > 1
    if param_specs is not None:
        stage_params = shard_pytree(stage_params, param_specs, mesh)
    stage_p = tree_map(lambda p: to_local(p).squeeze(0), stage_params)

    xl = x
    if sp_manual:
        sp_group = mesh.get_group(sp_axis)
        n_sp = axis_size(sp_group)
        s_loc = x.shape[1] // n_sp
        start = axis_index(sp_group) * s_loc
        xl = x.narrow(1, start, s_loc)
        positions = positions.narrow(0, start, s_loc)

    n_micro = num_microbatches
    # Rows gathered over dp (rank order: global order) are regrouped so
    # that each rank holds its share of every microbatch.
    batch_group = mesh.get_group("dp") if "dp" in names else None
    n_dp = axis_size(batch_group) if batch_group is not None else 1
    b_loc = xl.shape[0]
    if b_loc * n_dp % n_micro:
        raise ValueError(f"batch {b_loc * n_dp} not divisible by {n_micro} "
                         f"microbatches")
    if n_dp > 1:
        r = axis_index(batch_group)
        rows = _micro_rows(r, b_loc, n_micro, n_dp).to(xl.device)
        xl = all_gather(xl, batch_group, 0)[rows]
    out, aux_sum = _schedule(stage_fn, stage_p, list(xl.chunk(n_micro)),
                             positions, consts, group)
    out = out.flatten(0, 1)
    if n_dp > 1:
        # Back to this rank's own contiguous rows.
        order = torch.cat([_micro_rows(q, b_loc, n_micro, n_dp)
                           for q in range(n_dp)])
        mine = torch.argsort(order)[r * b_loc:(r + 1) * b_loc]
        out = all_gather(out, batch_group, 0)[mine.to(out.device)]
    # One window per (stage, microbatch); the per-call aux formula is
    # token-count invariant, so divide by n_micro to match the
    # non-pipelined objective. Under sp each sequence block's calls have
    # their own aux: their mean is the objective JAX's gradient follows.
    aux = psum(aux_sum, group) / n_micro
    if sp_manual:
        aux = psum(aux, sp_group) / n_sp
    return out, aux
