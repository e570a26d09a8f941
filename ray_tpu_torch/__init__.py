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

from ray_tpu_torch.core.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.core.generator import ObjectRefGenerator
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction, remote
from ray_tpu_torch.core.worker import (available_resources, cancel,
                                       cluster_resources, get, get_actor,
                                       init, is_initialized, kill, nodes, put,
                                       shutdown, timeline, wait)
from ray_tpu_torch.runtime_context import get_runtime_context

from ray_tpu_torch import exceptions  # noqa: E402
from ray_tpu_torch import util  # noqa: E402

__version__ = "0.1.0"

def __getattr__(name):
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "ActorClass", "ActorHandle", "ObjectRef", "ObjectRefGenerator",
    "RemoteFunction", "remote", "method", "init", "shutdown",
    "is_initialized", "get", "put", "wait", "kill", "cancel", "get_actor",
    "nodes", "cluster_resources", "available_resources", "timeline",
    "get_runtime_context", "exceptions", "util", "__version__",
    "resolve_device",
]
