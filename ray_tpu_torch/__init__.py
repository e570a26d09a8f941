"""PyTorch/CUDA port of `ray_tpu`'s serving and training paths, for NVIDIA
Hopper.

The package mirrors `ray_tpu`'s layout so each module has an obvious
counterpart (`ray_tpu_torch/ops/attention.py` <-> `ray_tpu/ops/attention.py`)
and imports nothing of it: what it needs is copied. Plain tensor code is
PyTorch; each Pallas TPU kernel on a ported path becomes a CUDA kernel
written by hand under `kernels/csrc/`.

Entry points run on `cuda:0` unless the caller passes a device (the tests
pass `device="cpu"`); see `device.resolve_device`.

The core API (`init`, `remote`, `get`, `put`, `wait`, `kill`, `get_actor`,
`shutdown`, ...) runs on the cluster runtime (`init()`: GCS, raylet and
workers as processes) or the in-process one (`init(local_mode=True)`);
`ray_tpu_torch.serve` stands on either.

Importing the package does not import torch: `resolve_device` loads on
first use, so the GCS, raylet and worker processes start without it.
"""

from ray_tpu_torch.core.actor import method
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import remote
from ray_tpu_torch.core.worker import (available_resources, cancel,
                                       cluster_resources, get, get_actor,
                                       init, is_initialized, kill, nodes, put,
                                       shutdown, timeline, wait)
from ray_tpu_torch.runtime_context import get_runtime_context



def __getattr__(name):
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "ObjectRef", "available_resources", "cancel", "cluster_resources", "get",
    "get_actor", "get_runtime_context", "init", "is_initialized", "kill",
    "method", "nodes", "put", "remote", "resolve_device", "shutdown",
    "timeline", "wait",
]
