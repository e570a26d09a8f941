"""Per-span time attribution, the part of `ray_tpu/core/attribution.py`
the serving engine uses.

Off unless `RAY_TPU_ATTRIBUTION` is set; call sites test the module-level
`enabled` flag before reading a clock, so the engine pays one global load
per site when it is off. Spans fold into per-label (count, total_s, max_s).
"""

from __future__ import annotations

import os
import threading
from typing import Dict

ENV_FLAG = "RAY_TPU_ATTRIBUTION"

enabled = bool(os.environ.get(ENV_FLAG))

_lock = threading.Lock()
_stats: Dict[str, list] = {}   # label -> [count, total_s, max_s]


def _slot(label: str) -> list:
    s = _stats.get(label)
    if s is None:
        with _lock:
            s = _stats.setdefault(label, [0, 0.0, 0.0])
    return s


def record(label: str, dt: float) -> None:
    """Fold one span of `dt` seconds into `label`."""
    s = _slot(label)
    # Racing += under the GIL can undercount slightly; no lock per span.
    s[0] += 1
    s[1] += dt
    if dt > s[2]:
        s[2] = dt


def count(label: str, n: int = 1) -> None:
    """Count an event with no duration."""
    _slot(label)[0] += n


def snapshot() -> Dict[str, Dict[str, float]]:
    """{label: {count, total_ms, max_us}}."""
    with _lock:
        items = [(k, list(v)) for k, v in _stats.items()]
    return {label: {"count": n, "total_ms": total * 1e3, "max_us": mx * 1e6}
            for label, (n, total, mx) in sorted(items)}
