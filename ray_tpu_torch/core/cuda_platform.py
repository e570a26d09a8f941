"""GPU detection and per-process card visibility for the cluster runtime.

The port of `ray_tpu/core/jax_platform.py` and of `ray_tpu/parallel/tpu.py`'s
`detect_chip_count` / `local_tpu_resources` / `visible_chip_env`. A TPU
worker needs its JAX platform pinned at import; a CUDA worker needs only
`CUDA_VISIBLE_DEVICES`, which CUDA reads once, when it initialises. So a
raylet starts every worker with `CUDA_VISIBLE_DEVICES=""` and a GPU lease
sets the lease's ids before any user code runs (`apply_visible_gpus`).

Nothing here imports torch or initialises CUDA: the node counts its cards
from the driver's files.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

VISIBLE_ENV = "CUDA_VISIBLE_DEVICES"
# The node's own CUDA_VISIBLE_DEVICES (unset: every card), kept for its
# workers, which start with "" and map their instance ids through it.
NODE_VISIBLE_ENV = "RAY_TPU_NODE_CUDA_VISIBLE_DEVICES"


def _count_cards() -> int:
    """The NVIDIA cards this process can open: its /dev/nvidiaN device
    files (a container holds only the cards it was given, where the
    driver's /proc lists every card of the host), else the driver's /proc
    entries, else `nvidia-smi -L`."""
    try:
        n = sum(1 for d in os.listdir("/dev")
                if re.fullmatch(r"nvidia\d+", d)
                and os.access(os.path.join("/dev", d), os.R_OK | os.W_OK))
        if n:
            return n
    except OSError:
        pass
    try:
        n = len(os.listdir("/proc/driver/nvidia/gpus"))
        if n:
            return n
    except OSError:
        pass
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return 0
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def _visible_entries(value: str, cards: int) -> List[str]:
    """CUDA's reading of a CUDA_VISIBLE_DEVICES list: entries up to the
    first that names no card."""
    out: List[str] = []
    for item in value.split(","):
        item = item.strip()
        if not item:
            break
        if item.isdigit():
            if int(item) >= cards:
                break
        elif not item.startswith(("GPU-", "MIG-")):
            break
        out.append(item)
    return out


def detect_gpu_count() -> int:
    """The cards this process may use: the host's, restricted by the
    container runtime's NVIDIA_VISIBLE_DEVICES and by the
    CUDA_VISIBLE_DEVICES it inherited."""
    cards = _count_cards()
    granted = os.environ.get("NVIDIA_VISIBLE_DEVICES")
    if granted is not None and granted.strip() not in ("all", ""):
        cards = (0 if granted.strip() in ("none", "void")
                 else min(cards, len([g for g in granted.split(",")
                                      if g.strip()])))
    value = os.environ.get(VISIBLE_ENV)
    if value is None:
        return cards
    return len(_visible_entries(value, cards))


def local_gpu_resources() -> Dict[str, float]:
    """{"GPU": n} for this node, or {} with no card."""
    n = detect_gpu_count()
    return {"GPU": float(n)} if n > 0 else {}


def node_env(env: Dict[str, str]) -> None:
    """Record the node's own visibility in `env` (the environment of its
    daemons), so a worker maps instance ids to the node's cards."""
    if NODE_VISIBLE_ENV not in env and VISIBLE_ENV in env:
        env[NODE_VISIBLE_ENV] = env[VISIBLE_ENV]


def visible_gpu_env(gpu_ids: Sequence[int]) -> Dict[str, str]:
    """The CUDA_VISIBLE_DEVICES that shows a worker the node's instances
    `gpu_ids` (instance i is the node's i-th visible card)."""
    node = os.environ.get(NODE_VISIBLE_ENV)
    if node is None:
        ids = [str(i) for i in gpu_ids]
    else:
        entries = [e.strip() for e in node.split(",") if e.strip()]
        ids = [entries[i] for i in gpu_ids]
    return {VISIBLE_ENV: ",".join(ids)}


def apply_visible_gpus(gpu_ids: Optional[Sequence[int]]) -> None:
    """Show this worker its lease's cards. Must run before CUDA
    initialises in the process, which the raylet ensures by giving GPU
    leases only to workers that never ran a task."""
    if gpu_ids:
        os.environ.update(visible_gpu_env(gpu_ids))
