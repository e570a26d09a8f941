"""Global driver state and the public module-level API, the port of
`ray_tpu/core/worker.py`.

The port has one runtime, the in-process one (`core/local_mode.py`):
`init()` starts it, whatever `local_mode` says, and `init(address=...)`
raises, since joining a cluster comes with the slice that ports the
cluster runtime. The first API call without `init()` starts it, as the
reference's implicit init does.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch.core.object_ref import ObjectRef

_global_lock = threading.RLock()
_runtime = None


def current_runtime(or_none: bool = False):
    global _runtime
    with _global_lock:
        if _runtime is None:
            if or_none:
                return None
            # Auto-init, like the reference's implicit init on first API use.
            init()
        return _runtime


def set_runtime(rt) -> None:
    global _runtime
    with _global_lock:
        _runtime = rt


def is_initialized() -> bool:
    return _runtime is not None


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         local_mode: bool = True,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         _system_config: Optional[dict] = None,
         **kwargs: Any):
    """Start the in-process runtime and return it."""
    global _runtime
    with _global_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError(
                "ray_tpu_torch.init() was already called. Pass "
                "ignore_reinit_error=True to ignore.")
        if address is not None:
            raise NotImplementedError(
                "the port has only the in-process runtime; connecting to "
                f"{address!r} comes with the slice that ports the cluster "
                "runtime (core/cluster_runtime.py)")
        from ray_tpu_torch.core.config import ray_config

        ray_config().apply_system_config(_system_config)
        if not ray_config().flight_recorder:
            from ray_tpu_torch.core import flight

            flight.disable()
        from ray_tpu_torch.core.local_mode import LocalModeRuntime

        _runtime = LocalModeRuntime(num_cpus=num_cpus, namespace=namespace)
        return _runtime


def shutdown() -> None:
    global _runtime
    with _global_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def put(value: Any) -> ObjectRef:
    return current_runtime().put(value)


def get(object_refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    return current_runtime().get(object_refs, timeout=timeout)


def wait(object_refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return current_runtime().wait(
        object_refs, num_returns=num_returns, timeout=timeout,
        fetch_local=fetch_local)


def kill(actor, *, no_restart: bool = True) -> None:
    current_runtime().kill_actor(actor, no_restart=no_restart)


def cancel(object_ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    current_runtime().cancel(object_ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: Optional[str] = None):
    return current_runtime().get_actor(name, namespace=namespace)


def nodes() -> List[dict]:
    return current_runtime().nodes()


def cluster_resources() -> dict:
    return current_runtime().cluster_resources()


def available_resources() -> dict:
    return current_runtime().available_resources()


def timeline(filename: Optional[str] = None):
    return current_runtime().timeline(filename)
