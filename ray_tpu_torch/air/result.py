"""Result of a training/tuning run (reference: python/ray/air/result.py),
the port of `ray_tpu/air/result.py`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return self.metrics.get("config")
