"""Flight recorder, the part of `ray_tpu/core/flight.py` the serving engine
uses: a bounded ring of the most recent events
`(t_monotonic, thread_id, category, label, dur_us, arg)`.

On unless `RAY_TPU_FLIGHT_RECORDER` is set to a false value; call sites test
the module-level `enabled` flag first. The engine records `engine/prefill`
and `engine/decode` steps and the decode step's `engine/kv_gather` and
`engine/model_step` phases.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, List, Optional, Tuple

ENV_FLAG = "RAY_TPU_FLIGHT_RECORDER"

enabled = os.environ.get(ENV_FLAG, "1").strip().lower() in (
    "1", "true", "yes", "on")

_ring: deque = deque(maxlen=4096)


def record(category: str, label: str, dur_us: int = 0, arg: Any = None,
           t: Optional[float] = None) -> None:
    """Append one event; `t` is its start in time.monotonic seconds
    (default now). A deque append is atomic, so threads need no lock."""
    _ring.append((time.monotonic() if t is None else t,
                  threading.get_ident(), category, label, int(dur_us), arg))


def events() -> List[Tuple]:
    """The ring's events, oldest first."""
    return list(_ring)
