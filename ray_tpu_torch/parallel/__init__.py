"""Training-step construction of the port (`spmd.py`). Mesh and sharding
(`shard_pytree`, `init_sharded`, `batch_sharding`) are not ported yet
(ROADMAP.md, "Parallel layer")."""

from ray_tpu_torch.parallel.spmd import adamw, make_eval_step, make_train_step

__all__ = ["adamw", "make_eval_step", "make_train_step"]
