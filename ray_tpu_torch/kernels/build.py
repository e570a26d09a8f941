"""Build the port's CUDA kernels with nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each source under `csrc/` compiles on its own (`nvcc -shared` for sm_90a)
into `_build/<name>-<hash>.so`; the hash covers the source, the headers
under `csrc/` (`hopper.cuh`, the Hopper helpers both sources include) and
the flags, so an edited kernel or header rebuilds and an unchanged one is
reused. Nothing builds at
import: the first CUDA call of a wrapper builds its kernel, and `build()`
builds several at once, one nvcc process per source, all started together.
The wrappers pass raw pointers (`tensor.data_ptr()`) and PyTorch's current
stream; the C entry points return the launch's `cudaError_t`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
KERNELS = {"flash_attn_fwd": "flash_attn_fwd.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu"}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# What the last build of each kernel reported: seconds and ptxas's
# register/shared-memory/spill lines.
build_log: Dict[str, Dict[str, object]] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return path


def _target(name: str) -> Path:
    """The library path of kernel `name`: a hash of its source, of every
    header under `csrc/` (which any source may include) and of the flags,
    so an edited header rebuilds every kernel."""
    h = hashlib.sha256((CSRC / KERNELS[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named kernels (default: all) that are not built yet, one
    nvcc per source in parallel; returns each kernel's library path."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
