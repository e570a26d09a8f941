"""Config flag registry, the part of `ray_tpu/core/config.py` that the
in-process runtime reads.

Typed declarations read as attributes of `ray_config()`, with
`RAY_TPU_{NAME}` environment overrides and an `apply_system_config` hook
from `ray_tpu_torch.init(_system_config=...)`. Same names and defaults as
the reference; the flags of the cluster runtime come with it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _Flag:
    name: str
    default: Any
    type: Callable[[str], Any]
    doc: str


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Singleton flag store. Declare with `_declare`, read as attributes."""

    _flags: Dict[str, _Flag] = {}

    def __init__(self):
        self._values: Dict[str, Any] = {}

    @classmethod
    def _declare(cls, name: str, default: Any, doc: str = ""):
        if isinstance(default, bool):
            typ: Callable[[str], Any] = _parse_bool
        elif isinstance(default, int):
            typ = int
        elif isinstance(default, float):
            typ = float
        else:
            typ = str
        cls._flags[name] = _Flag(name, default, typ, doc)

    def __getattr__(self, name: str) -> Any:
        flags = type(self)._flags
        if name.startswith("_") or name not in flags:
            raise AttributeError(name)
        if name in self._values:
            return self._values[name]
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            return flags[name].type(env)
        return flags[name].default

    def apply_system_config(self, system_config: Dict[str, Any] | str | None):
        if system_config is None:
            return
        if isinstance(system_config, str):
            system_config = json.loads(system_config)
        for k, v in system_config.items():
            if k not in type(self)._flags:
                raise ValueError(f"Unknown system config key: {k}")
            self._values[k] = v


_D = Config._declare

_D("flight_recorder", True,
   "Per-process flight recorder (core/flight.py): a fixed-capacity ring "
   "of recent events (engine steps and their phases). Off sets "
   "RAY_TPU_FLIGHT_RECORDER=0 for this process and its children.")

_config = Config()


def ray_config() -> Config:
    return _config
