"""Trial bookkeeping (reference: `python/ray/tune/experiment/trial.py`),
the port of `ray_tpu/tune/trial.py`."""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"  # finished normally or scheduler-stopped
ERROR = "ERROR"


@dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    iterations: int = 0
    error: Optional[str] = None
    final: Any = None  # the trainable's return value
    checkpoint_dir: Optional[str] = None  # latest persisted trial ckpt

    def to_state(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "iterations": self.iterations,
            "error": self.error,
            "checkpoint_dir": self.checkpoint_dir,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Trial":
        t = cls(config=state["config"], trial_id=state["trial_id"])
        t.status = state["status"]
        t.last_result = state.get("last_result", {})
        t.iterations = state.get("iterations", 0)
        t.error = state.get("error")
        t.checkpoint_dir = state.get("checkpoint_dir")
        # Anything that was mid-flight when the driver died reruns.
        if t.status == RUNNING:
            t.status = PENDING
        return t
