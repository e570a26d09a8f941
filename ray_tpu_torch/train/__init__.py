"""ray_tpu_torch.train: distributed SPMD training on actor gangs, the port
of `ray_tpu/train/`.

Reference: `python/ray/train/` — trainers over a BackendExecutor +
WorkerGroup (`_internal/backend_executor.py:65`, `worker_group.py:102`).
The process-group seam is `torch.distributed` (`backend.py TorchConfig`:
NCCL on cards, gloo on the CPU) where the reference's is
`jax.distributed`.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig, TrainConfig)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session
from ray_tpu_torch.air.session import (get_checkpoint, get_dataset_shard,
                                       get_local_rank, get_node_rank,
                                       get_world_rank, get_world_size, report)
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.trainer import TorchTrainer, TrainingFailedError


def get_mesh(shape=None, *, dp_across_slices: bool = True, device=None):
    """The gang's device mesh over its process group. Call from inside a
    TorchTrainer train loop (after the backend joined the group). When
    the gang spans several nodes (slices) and `dp_across_slices`, the
    mesh is hybrid: dp spans nodes and the model axes stay on one node's
    fast interconnect (`parallel/mesh.py make_hybrid_mesh`). A one-node
    gang gets the plain mesh. `device=None` means CUDA; pass "cpu" for a
    gloo gang."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import (make_hybrid_mesh, make_mesh,
                                             slice_id_of)

    ranks = range(dist.get_world_size())
    if dp_across_slices and len({slice_id_of(r, device)
                                 for r in ranks}) > 1:
        return make_hybrid_mesh(shape, device=device)
    return make_mesh(shape, device=device)


__all__ = [
    "Backend", "BackendConfig", "Checkpoint", "CheckpointConfig",
    "FailureConfig", "TorchConfig", "TorchTrainer", "Result", "RunConfig",
    "ScalingConfig", "TrainConfig", "TrainingFailedError", "get_mesh",
    "session",
    "report", "get_checkpoint", "get_dataset_shard", "get_local_rank",
    "get_node_rank", "get_world_rank", "get_world_size",
]
