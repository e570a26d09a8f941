"""AIR-equivalent shared config/session layer, the port of `ray_tpu/air/`.

Reference: `python/ray/air/` — `ScalingConfig`/`RunConfig`/`FailureConfig`/
`CheckpointConfig` (`air/config.py`), `session.report` (`air/session.py`),
`Checkpoint` (`train/_checkpoint.py:55`). ScalingConfig speaks in
workers and GPUs per worker, as upstream Ray's does.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "RunConfig",
    "ScalingConfig", "Result", "session",
]
