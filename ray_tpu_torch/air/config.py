"""Run/scaling configuration dataclasses, the port of
`ray_tpu/air/config.py`.

Reference: `python/ray/air/config.py` (ScalingConfig :157, RunConfig :599,
FailureConfig :532, CheckpointConfig :458). Where the reference scales in
TPU chips per worker, the port scales in GPUs per worker (`use_gpu`,
`gpus_per_worker`, the resource `"GPU"`), as upstream Ray does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many training workers, and what each one holds.

    num_workers: actors in the gang (NCCL runs one per card).
    use_gpu: reserve GPUs for each worker.
    gpus_per_worker: GPUs each worker leases; its CUDA_VISIBLE_DEVICES
        shows it those cards.
    resources_per_worker: extra custom resources per worker.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    @property
    def num_cpus_per_worker(self) -> float:
        res = dict(self.resources_per_worker or {})
        return float(res.get("CPU", 1.0))

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and self.gpus_per_worker:
            res.setdefault("GPU", float(self.gpus_per_worker))
        return res

    def as_placement_group_factory(self):
        """Bundle list for gang placement (one bundle per worker)."""
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class TrainConfig:
    """Training-loop instrumentation knobs (round 17 observability).

    profile_steps: capture a torch.profiler trace (CPU and, where the
        worker holds a card, CUDA activity) on every worker for steps
        [a, b] (1-indexed, inclusive): the trace starts when step a
        begins and stops after step b completes. Each worker writes a
        Chrome trace, `trace.json`, under `profile_dir/<trial>/rank<k>`
        and publishes the location to GCS KV
        (`train_profile/<trial>/<rank>`). Open it in chrome://tracing or
        Perfetto.
    profile_dir: base directory for trace output (default
        `ray_tpu_torch_profile` under the worker's temp directory).
    """

    profile_steps: Optional[tuple] = None
    profile_dir: Optional[str] = None


@dataclass
class FailureConfig:
    """Reference: air/config.py FailureConfig — max_failures<0 = infinite."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: air/config.py CheckpointConfig."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    """Reference: air/config.py RunConfig (name, storage_path, failure/
    checkpoint configs)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    verbose: int = 1
    log_to_file: bool = False
    callbacks: Any = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
