"""LearnerGroup: a local learner or a gang of remote ones, the port of
`ray_tpu/rllib/core/learner_group.py`.

The reference runs k learners as one SPMD program (a `dp` mesh over
`jax.distributed`, XLA's gradient psum). Here the remote learners live in
the training actors of Train's `BackendExecutor` with `TorchConfig`, as
`TorchTrainer`'s workers do: gloo on the CPU, NCCL when the learner's
device is a card, where each learner leases one whole GPU
(`ScalingConfig(use_gpu=True, gpus_per_worker=1)`; NCCL takes one card a
rank). Each learner takes an equal shard of the batch and averages its
gradients over the gang after `backward()` (`learner.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np


def _make_learner(module_factory, config, distributed: bool):
    from ray_tpu_torch.rllib.core.learner import PPOLearner

    return PPOLearner(module_factory(), config, distributed=distributed)


def _on_card(config: Dict[str, Any]) -> bool:
    device = config.get("device")
    return device is None or str(device).startswith("cuda")


class LearnerGroup:
    def __init__(self, module_factory: Callable, config: Dict[str, Any],
                 num_learners: int = 0):
        self.num_learners = num_learners
        self._local = None
        self._executor = None
        if num_learners == 0:
            self._local = _make_learner(module_factory, config,
                                        distributed=False)
            return
        import ray_tpu_torch
        from ray_tpu_torch.air.config import ScalingConfig
        from ray_tpu_torch.train._internal.backend_executor import \
            BackendExecutor
        from ray_tpu_torch.train.backend import TorchConfig

        gpu = _on_card(config)
        scaling = ScalingConfig(num_workers=num_learners, use_gpu=gpu,
                                gpus_per_worker=1 if gpu else 0)
        backend = TorchConfig()
        backend.check_scaling(scaling)
        self._executor = BackendExecutor(backend, scaling)
        # The Train gang bring-up: placement-group reservation and the
        # process group (reference: learner_group.py:102-117).
        self._executor.start()
        self._workers = self._executor.worker_group.workers
        # A leased card is the worker's cuda:0 (its CUDA_VISIBLE_DEVICES).
        worker_config = dict(config, device="cuda" if gpu else "cpu")
        ray_tpu_torch.get([w.execute.remote(_install_learner, module_factory,
                                            worker_config)
                           for w in self._workers], timeout=300)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(batch)
        import ray_tpu_torch

        k = len(self._workers)
        # Equal shards only: the gang's collectives run in lockstep, one
        # all-reduce a minibatch on every learner; drop the remainder.
        n = (len(batch["obs"]) // k) * k
        shards = [{key: v[i * n // k:(i + 1) * n // k]
                   for key, v in batch.items()} for i in range(k)]
        stats = ray_tpu_torch.get(
            [w.execute.remote(_update_learner, shard)
             for w, shard in zip(self._workers, shards)], timeout=600)
        return stats[0]

    def get_weights(self) -> Dict[str, np.ndarray]:
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._workers[0].execute.remote(_learner_weights), timeout=120)

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()


# Worker-process globals (one learner per training worker process).
_LEARNER = None


def _install_learner(module_factory, config) -> bool:
    global _LEARNER
    _LEARNER = _make_learner(module_factory, config, distributed=True)
    return True


def _update_learner(shard) -> Dict[str, float]:
    return _LEARNER.update(shard)


def _learner_weights():
    return _LEARNER.get_weights()
