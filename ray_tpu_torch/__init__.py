"""PyTorch/CUDA port of `ray_tpu`'s serving and training paths, for NVIDIA
Hopper.

The package mirrors `ray_tpu`'s layout so each module has an obvious
counterpart (`ray_tpu_torch/ops/attention.py` <-> `ray_tpu/ops/attention.py`)
and imports nothing of it: what it needs is copied. Plain tensor code is
PyTorch; each Pallas TPU kernel on a ported path becomes a CUDA kernel
written by hand under `kernels/csrc/`.

Entry points run on `cuda:0` unless the caller passes a device (the tests
pass `device="cpu"`); see `device.resolve_device`.
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
