"""Tensor plane of the port: device meshes, sharded params, collectives, the
pipeline schedule and the train step.

The port of `ray_tpu/parallel/`: a `torch.distributed.DeviceMesh` over the
dp/pp/sp/tp axes (`mesh.py`), params as DTensors placed by JAX-style specs
(`spmd.py`), the collectives of the manual regions (`collectives.py`), the
GPipe schedule (`pipeline.py`), and `make_train_step` with AdamW, which
takes plain or DTensor params.
"""

from ray_tpu_torch.parallel.mesh import (AXES, MeshSpec, auto_mesh,
                                         make_hybrid_mesh, make_mesh,
                                         mesh_shape_for, slice_id_of)
from ray_tpu_torch.parallel.pipeline import gpipe
from ray_tpu_torch.parallel.spmd import (P, PartitionSpec, adamw,
                                         batch_sharding, init_sharded,
                                         make_eval_step, make_train_step,
                                         shard_pytree)

__all__ = ["AXES", "MeshSpec", "auto_mesh", "make_hybrid_mesh", "make_mesh",
           "mesh_shape_for", "slice_id_of", "gpipe", "P", "PartitionSpec",
           "adamw", "batch_sharding", "init_sharded", "make_eval_step",
           "make_train_step", "shard_pytree"]
