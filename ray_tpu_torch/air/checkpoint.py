"""Checkpoint: a portable bundle of training state.

Reference: `python/ray/train/_checkpoint.py:55` (directory-backed Checkpoint
with pyarrow-fs upload). Here: either an in-memory dict (travels through the
object store) or a local directory; persisted to the run's storage path by
the trainer. Tensors and arrays work naturally — values are pickled with
out-of-band buffers by the core serializer, whose pickler writes functions
and classes by reference (the port has no cloudpickle).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization

_PAYLOAD_FILE = "checkpoint.pkl"


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("Checkpoint needs exactly one of data= or path=")
        self._data = data
        self._path = path

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))

    # -- accessors ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        payload = os.path.join(self._path, _PAYLOAD_FILE)
        if os.path.exists(payload):
            with open(payload, "rb") as f:
                return serialization.loads(f.read())
        raise ValueError(
            f"Directory checkpoint at {self._path} has no {_PAYLOAD_FILE}; "
            "use to_directory() / path for raw file checkpoints")

    def to_directory(self, path: Optional[str] = None) -> str:
        out = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(out, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(out) != os.path.abspath(self._path):
                shutil.copytree(self._path, out, dirs_exist_ok=True)
        else:
            with open(os.path.join(out, _PAYLOAD_FILE), "wb") as f:
                f.write(serialization.dumps(self._data))
        return out

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        src = self._path if self._path else f"dict[{len(self._data)}]"
        return f"Checkpoint({src})"
