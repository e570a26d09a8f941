"""Training backends: the gang-wide process-group bootstrap seam, the port
of `ray_tpu/train/backend.py`.

Reference: `python/ray/train/_internal/backend_executor.py` Backend hooks +
`train/torch/config.py:151,171-190` where `_TorchBackend.on_start` wires
the rendezvous and `dist.init_process_group`. Where the reference's
`JaxConfig` runs `jax.distributed.initialize` on every worker, `TorchConfig`
runs `torch.distributed.init_process_group` over a TCP rendezvous on rank
0's free port: NCCL for workers that lease GPUs (one card each, as their
CUDA_VISIBLE_DEVICES shows them), gloo otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Covers the rendezvous skew of a fresh gang: each GPU worker imports torch
# (7-11 s on the card machine) before it joins.
_PROCESS_GROUP_TIMEOUT_S = 300.0


class Backend:
    def on_start(self, worker_group, backend_config) -> None:
        pass

    def on_training_start(self, worker_group, backend_config) -> None:
        pass

    def on_shutdown(self, worker_group, backend_config) -> None:
        pass


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


def _setup_torch_distributed(init_method: str, world_size: int, rank: int,
                             local_rank: int, local_world_size: int,
                             backend: Optional[str]) -> str:
    """Runs in each training worker: join the gang's process group.
    Returns the backend it joined with."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if backend is None:
        # A GPU lease shows the worker its cards; without one the raylet
        # leaves CUDA_VISIBLE_DEVICES empty.
        backend = ("nccl" if os.environ.get("CUDA_VISIBLE_DEVICES")
                   else "gloo")
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world_size),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(local_world_size)})
    if backend == "nccl":
        # The lease's CUDA_VISIBLE_DEVICES shows this worker one card.
        torch.cuda.set_device(0)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=_PROCESS_GROUP_TIMEOUT_S))
    got = dist.get_world_size()
    assert got == world_size, f"torch world size {got} != {world_size}"
    return backend


def _teardown_torch_distributed() -> bool:
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        pass
    return True


@dataclass
class TorchConfig(BackendConfig):
    """Backend config for torch.distributed training.

    backend: "nccl" or "gloo" to force one; None = NCCL for workers
        that hold a GPU lease, gloo otherwise.
    """

    backend: Optional[str] = None

    def __post_init__(self):
        if self.backend not in (None, "nccl", "gloo"):
            raise ValueError(f"TorchConfig.backend must be None, 'nccl' or "
                             f"'gloo', got {self.backend!r}")

    @property
    def backend_cls(self):
        return _TorchBackend

    def check_scaling(self, scaling) -> None:
        """Refuse a gang NCCL cannot form: NCCL takes one rank per card
        ("Duplicate GPU detected" otherwise), so each worker must lease
        at least one whole GPU."""
        nccl = self.backend == "nccl" or (self.backend is None
                                          and scaling.use_gpu)
        if nccl and (not scaling.use_gpu or scaling.gpus_per_worker < 1):
            raise ValueError(
                f"an NCCL gang needs a whole GPU per worker (NCCL takes "
                f"one rank per card), got use_gpu={scaling.use_gpu}, "
                f"gpus_per_worker={scaling.gpus_per_worker}; lease "
                f"gpus_per_worker >= 1 or use TorchConfig(backend='gloo')")


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        host_port = worker_group.execute_single(0, _free_port_on_worker)
        n = len(worker_group)
        import ray_tpu_torch

        nodes = [m["node_id"] for m in worker_group.metadata]
        refs = []
        for rank, w in enumerate(worker_group.workers):
            node = nodes[rank]
            refs.append(w.execute.remote(
                _setup_torch_distributed, f"tcp://{host_port}", n, rank,
                nodes[:rank].count(node), nodes.count(node),
                backend_config.backend))
        ray_tpu_torch.get(refs, timeout=_PROCESS_GROUP_TIMEOUT_S + 60)

    def on_shutdown(self, worker_group, backend_config: TorchConfig) -> None:
        try:
            worker_group.execute(_teardown_torch_distributed)
        except Exception:
            pass


def _free_port_on_worker() -> str:
    import socket

    from ray_tpu_torch.train._internal.worker_group import host_ip

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return f"{host_ip()}:{port}"
