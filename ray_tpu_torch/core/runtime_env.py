"""Runtime environments: per-task/actor env_vars and working_dir (the
port of `ray_tpu/core/runtime_env.py`; its pip plugin waits).

Reference equivalent: `python/ray/_private/runtime_env/` (the working_dir
and env_vars plugins of the runtime env agent). The driver packages a
working_dir into a content-addressed zip in the GCS KV; workers download
and extract it once per content hash, then put it on sys.path and chdir
for execution. env_vars apply to the worker process before user code
runs. Isolation note: distinct runtime envs hash into the lease
scheduling key, so concurrent tasks with different envs never share a
leased worker.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile
import zipfile
from typing import Any, Dict, Optional

_MAX_WORKING_DIR_BYTES = 100 * 1024 * 1024
_EXTRACT_ROOT = os.path.join(tempfile.gettempdir(),
                             "ray_tpu_torch_runtime_envs")


def env_hash(runtime_env: Optional[Dict[str, Any]]) -> str:
    """Stable hash for scheduling-key isolation ('' = no env)."""
    if not runtime_env:
        return ""
    return hashlib.sha1(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:12]


def validate(runtime_env: Dict[str, Any]) -> None:
    if "pip" in runtime_env:
        raise ValueError(
            "runtime_env pip: the pip plugin comes with a later slice of "
            "the port")
    allowed = {"env_vars", "working_dir", "working_dir_key"}
    unknown = set(runtime_env) - allowed
    if unknown:
        raise ValueError(
            f"unsupported runtime_env fields {sorted(unknown)}; "
            f"supported: {sorted(allowed)}")
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()):
        raise ValueError("runtime_env env_vars must be {str: str}")


def pack_working_dir(path: str) -> bytes:
    """Deterministic zip of a directory tree."""
    if not os.path.isdir(path):
        raise ValueError(f"working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for fname in sorted(files):
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                zf.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_WORKING_DIR_BYTES:
        raise ValueError(
            f"working_dir zip is {len(data)} bytes; limit "
            f"{_MAX_WORKING_DIR_BYTES} (exclude data files)")
    return data


def upload_working_dir(rt, path: str) -> str:
    """Driver-side: zip + content-addressed KV upload; returns the key."""
    data = pack_working_dir(path)
    digest = hashlib.sha1(data).hexdigest()[:16]
    key = f"runtime_env:working_dir:{digest}".encode()
    rt.kv_put(key, data, overwrite=False)
    return key.decode()


def prepare_spec_env(rt, runtime_env: Optional[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """Resolve a user runtime_env into its wire form (working_dir
    uploaded, replaced by its KV key)."""
    if not runtime_env:
        return None
    validate(runtime_env)
    out = dict(runtime_env)
    wd = out.pop("working_dir", None)
    if wd:
        out["working_dir_key"] = upload_working_dir(rt, wd)
    return out


def apply_runtime_env(rt, runtime_env: Optional[Dict[str, Any]]) -> None:
    """Worker-side: make the env effective for this process."""
    if not runtime_env:
        return
    env_vars = runtime_env.get("env_vars") or {}
    os.environ.update(env_vars)
    key = runtime_env.get("working_dir_key")
    if key:
        target = os.path.join(_EXTRACT_ROOT, key.rsplit(":", 1)[-1])
        if not os.path.isdir(target):
            blob = rt.kv_get(key.encode())
            if blob is None:
                raise FileNotFoundError(
                    f"runtime_env working_dir blob {key} not in GCS KV")
            tmp = f"{target}.tmp.{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, target)
            except OSError:
                # Concurrent extract won the rename: use theirs.
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        if target not in sys.path:
            sys.path.insert(0, target)
        os.chdir(target)
