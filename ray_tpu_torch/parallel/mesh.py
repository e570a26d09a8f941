"""Device meshes over the canonical parallelism axes, on
`torch.distributed.DeviceMesh`: the port of `ray_tpu/parallel/mesh.py`.

The axes (a copy of the JAX package's):

- ``dp``: data parallel; also the FSDP shard axis (a weight sharded over dp
  is all-gathered before its product and its gradient reduce-scattered)
  and the expert-parallel axis (experts sharded over dp).
- ``pp``: pipeline stages (`parallel/pipeline.py:gpipe`).
- ``sp``: sequence parallel (ring attention, `ops/attention.py`).
- ``tp``: tensor parallel (Megatron column/row sharding).

A mesh is a grid of ranks of the default process group, one rank a device.
`make_mesh` lays ranks out in order (the JAX package's CPU layout: device
ids in order); `make_hybrid_mesh` orders them slice-major so that dp's
outer blocks are whole slices (nodes) and the model axes stay inside one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.device import DeviceLike, resolve_device

AXES = ("dp", "pp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 on dp means 'absorb remaining devices'."""

    dp: int = -1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        fixed = self.pp * self.sp * self.tp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by pp*sp*tp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"Mesh {dp}x{self.pp}x{self.sp}x{self.tp} != {n_devices} devices")
        return (dp, self.pp, self.sp, self.tp)


def mesh_shape_for(n_devices: int) -> Tuple[int, int, int, int]:
    """Factorize n devices over (dp, pp, sp, tp), spreading across as many
    axes as possible so every parallelism mode is exercised: factors are dealt
    to tp, pp, sp, then dp absorbs the rest."""
    remaining = n_devices
    shape = {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    for axis in ("tp", "pp", "sp"):
        if remaining % 2 == 0 and remaining > 1:
            shape[axis] *= 2
            remaining //= 2
    shape["dp"] = remaining
    return (shape["dp"], shape["pp"], shape["sp"], shape["tp"])


def _device_type(device: DeviceLike) -> str:
    return resolve_device(device).type


def _ensure_process_group(device_type: str) -> None:
    """A single process with no process group gets a world of one (gloo on
    the CPU, NCCL on CUDA), as JAX's `make_mesh` works without
    `jax.distributed`. A multi-rank caller initialises its group first."""
    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(layout: np.ndarray, device_type: str,
          axis_names: Sequence[str]) -> DeviceMesh:
    return DeviceMesh(device_type, torch.as_tensor(layout, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def make_mesh(shape: Optional[Sequence[int]] = None, *,
              ranks: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = AXES,
              device: DeviceLike = None) -> DeviceMesh:
    """A `DeviceMesh` of `ranks` (default: every rank of the default group,
    in order) reshaped to `shape` (default `mesh_shape_for(len(ranks))`),
    with the canonical axis names. `device=None` means CUDA (one card a
    rank); the tests pass `device="cpu"` (gloo)."""
    device_type = _device_type(device)
    _ensure_process_group(device_type)
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    shape = mesh_shape_for(len(ranks)) if shape is None else tuple(shape)
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {shape} != {len(ranks)} devices")
    return _mesh(np.array(ranks).reshape(shape), device_type, axis_names)


def auto_mesh(n_devices: Optional[int] = None, *, device: DeviceLike = None,
              **axis_sizes) -> DeviceMesh:
    """`auto_mesh(8)` or `auto_mesh(dp=2, tp=4)`."""
    device_type = _device_type(device)
    _ensure_process_group(device_type)
    ranks = list(range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if axis_sizes:
        spec = MeshSpec(**axis_sizes)
        return make_mesh(spec.resolve(len(ranks)), ranks=ranks,
                         device=device)
    return make_mesh(ranks=ranks, device=device)


def slice_id_of(rank: int, device: DeviceLike = None) -> int:
    """Which slice (node: the domain of the fast interconnect) a rank
    belongs to. CPU ranks are processes, each its own slice, as the JAX
    package's `process_index` rule makes each host process one. CUDA ranks
    are numbered node by node (as `torchrun` does), LOCAL_WORLD_SIZE to a
    node (default: this node's card count)."""
    if _device_type(device) != "cuda":
        return rank
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE",
                                  torch.cuda.device_count()))
    return rank // per_node


def hybrid_layout(shape: Optional[Sequence[int]], ranks: Sequence[int],
                  slice_ids: Sequence[int]) -> np.ndarray:
    """The hybrid mesh's [dp, pp, sp, tp] grid of ranks: slice-major, each
    slice's ranks in order, dp split into (slice, dp within the slice) with
    the slice outermost. `shape` is global; dp must be a multiple of the
    slice count, every other axis must fit within one slice."""
    by_slice: dict = {}
    for r, sid in zip(ranks, slice_ids):
        by_slice.setdefault(sid, []).append(r)
    n_slices = len(by_slice)
    per_slice = len(ranks) // n_slices
    if any(len(v) != per_slice for v in by_slice.values()):
        raise ValueError(
            f"uneven slices: {[len(v) for v in by_slice.values()]}")
    if shape is None:
        inner = mesh_shape_for(per_slice)
        shape = (inner[0] * n_slices, *inner[1:])
    dp, pp, sp, tp = shape
    if dp % n_slices != 0:
        raise ValueError(
            f"dp={dp} must be a multiple of the slice count {n_slices}")
    if pp * sp * tp * (dp // n_slices) != per_slice:
        raise ValueError(
            f"per-slice shape dp/slices x pp x sp x tp = "
            f"{dp // n_slices}x{pp}x{sp}x{tp} != {per_slice} "
            f"devices per slice")
    ordered = [r for sid in sorted(by_slice) for r in sorted(by_slice[sid])]
    return np.array(ordered).reshape(
        n_slices, dp // n_slices, pp, sp, tp).reshape(dp, pp, sp, tp)


def make_hybrid_mesh(shape: Optional[Sequence[int]] = None, *,
                     ranks: Optional[Sequence[int]] = None,
                     slice_ids: Optional[Sequence[int]] = None,
                     axis_names: Sequence[str] = AXES,
                     device: DeviceLike = None) -> DeviceMesh:
    """Multi-slice mesh: ``dp`` spans slices over the slow fabric, the
    model axes (pp/sp/tp) stay inside a slice, so only the once-per-step
    gradient reduction crosses slices. `shape` is the GLOBAL (dp, pp, sp,
    tp) (default: `mesh_shape_for` of one slice, dp times the slice
    count); `slice_ids` gives each rank's slice (default `slice_id_of`)."""
    device_type = _device_type(device)
    _ensure_process_group(device_type)
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if slice_ids is None:
        slice_ids = [slice_id_of(r, device) for r in ranks]
    return _mesh(hybrid_layout(shape, ranks, slice_ids), device_type,
                 axis_names)
