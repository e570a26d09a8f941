"""Object store -> card bridge, the port of `ray_tpu/util/device_arrays.py`
(its ingest half: `to_jax` and `get_to_device`).

Reference equivalent: SURVEY §2.5 data-plane row (the reference moves
tensors between the object store and the device without host copies).
`ray_tpu_torch.get` of a numpy array already returns a view over the
object's shared-memory segment; this module covers the last hop:

- CPU: `torch.from_numpy` aliases a writable array (no copy); a read-only
  store view is copied once, since a tensor may be written;
- CUDA: one host-to-card copy from pinned memory, `non_blocking` on a side
  stream, and the consumer's stream waits on the copy's event before it
  reads the tensor.

`iter_torch_batches` places its batches through `batch_to_device` and
`shard_on_mesh`. The reference's sharded puts (`ShardManifest`,
`build_manifest`, `assemble_from_manifest`) come with the runtime's sharded
put path, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

_side_streams: Dict[Any, Any] = {}


def _host_tensor(array: Any, dtype: Any = None):
    """A CPU tensor of `array` (an ndarray or a tensor), in `dtype` (a
    torch or numpy dtype) if given."""
    import torch

    if isinstance(array, torch.Tensor):
        t = array
    else:
        arr = np.asarray(array)
        if dtype is not None and not isinstance(dtype, torch.dtype):
            arr = arr.astype(dtype)
            dtype = None
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            arr = np.array(arr, order="C")
        t = torch.from_numpy(arr)
    return t if dtype is None else t.to(dtype)


def _side_stream(device):
    import torch

    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


def batch_to_device(arrays: Dict[str, Any], *,
                    dtypes: Optional[Dict[str, Any]] = None,
                    device: Any = None) -> Dict[str, Any]:
    """{column: tensor on `device`} (None: cuda:0). On a card every column
    is copied from pinned memory on one side stream; the caller's current
    stream waits on the copies' event before it gets the batch."""
    import torch

    from ray_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    dtypes = dtypes or {}
    host = {c: _host_tensor(v, dtypes.get(c)) for c, v in arrays.items()}
    if dev.type != "cuda":
        return {c: t.to(dev) for c, t in host.items()}
    stream = _side_stream(dev)
    with torch.cuda.stream(stream):
        out = {c: t.pin_memory().to(dev, non_blocking=True)
               for c, t in host.items()}
        copied = torch.cuda.Event()
        copied.record(stream)
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(copied)
    for t in out.values():
        # The caching allocator must not reuse a tensor's memory while
        # the consumer's stream may still read it.
        t.record_stream(consumer)
    return out


def shard_on_mesh(arrays: Dict[str, Any], mesh: Any, *,
                  batch_axis: str = "dp",
                  dtypes: Optional[Dict[str, Any]] = None,
                  batch_size: Optional[int] = None) -> Dict[str, Any]:
    """{column: DTensor} of this rank's rows, `Shard(0)` on `batch_axis`
    of `mesh` and replicated on its other axes (the counterpart of
    `jax.make_array_from_process_local_data`). Every rank holds
    `batch_size` rows of a full batch; a short batch (the last one, which
    ranks' shards may end at different lengths), or one whose global rows
    (local rows x world size) do not divide the mesh's size, comes back
    as plain tensors on the mesh's device, unsharded, as the reference's
    short batch does."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device = ("cpu" if mesh.device_type == "cpu" else None)
    local = batch_to_device(arrays, dtypes=dtypes, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    placements = [Shard(0) if name == batch_axis else Replicate()
                  for name in mesh.mesh_dim_names]
    out = {}
    for c, t in local.items():
        full = batch_size is None or t.shape[0] == batch_size
        if full and (t.shape[0] * world) % max(mesh.size(), 1) == 0:
            out[c] = DTensor.from_local(t, mesh, placements,
                                        run_check=False)
        else:
            out[c] = t
    return out


def to_torch(value: Any, *, device: Any = None):
    """A (possibly store-backed) host array as a tensor on `device`
    (None: cuda:0) with the fewest copies. Accepts the output of
    `ray_tpu_torch.get`, or a tensor."""
    return batch_to_device({"v": value}, device=device)["v"]


def get_to_device(ref, *, timeout: Optional[float] = None,
                  device: Any = None):
    """`ray_tpu_torch.get` + `to_torch` in one call: ObjectRef -> tensor."""
    import ray_tpu_torch

    return to_torch(ray_tpu_torch.get(ref, timeout=timeout), device=device)
