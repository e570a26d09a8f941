"""Global driver/worker state and the public module-level API, the port of
`ray_tpu/core/worker.py`.

`init()` starts (or, with `address=`, joins) the cluster runtime
(`core/cluster_runtime.py`): a GCS and a raylet as processes, workers as
processes. `init(local_mode=True)` starts the in-process runtime
(`core/local_mode.py`). The first API call without `init()` starts a
cluster, as the reference's implicit init does.
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


def _runtime_is_alive(rt) -> bool:
    """Probe a cached runtime before ignore_reinit_error reuses it (two
    attempts: a loaded GCS may miss one short probe)."""
    if getattr(rt, "_shutdown", False):
        return False
    check = getattr(rt, "check_alive", None)
    if check is None:
        return True
    for attempt in range(2):
        try:
            if check():
                return True
        except Exception:
            pass
        if attempt == 0:
            import time

            time.sleep(1.0)
    return False


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[dict] = None,
         local_mode: bool = False,
         namespace: Optional[str] = None,
         object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         _system_config: Optional[dict] = None,
         **kwargs: Any):
    """Start or join a cluster (or, with `local_mode=True`, start the
    in-process runtime) and return the runtime."""
    global _runtime
    with _global_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                if _runtime_is_alive(_runtime):
                    return _runtime
                # A dead cached runtime would hand out stale state from a
                # torn-down cluster: replace it.
                try:
                    _runtime.shutdown()
                except Exception:
                    pass
                _runtime = None
            elif getattr(_runtime, "mode", None) == "worker":
                raise RuntimeError(
                    "ray_tpu_torch.init() ran inside a worker process: a "
                    "worker loads the driver's main file as a module to "
                    "import its functions and classes, so put the "
                    "script's top-level work under "
                    "`if __name__ == \"__main__\":`")
            else:
                raise RuntimeError(
                    "ray_tpu_torch.init() was already called. Pass "
                    "ignore_reinit_error=True to ignore.")
        from ray_tpu_torch.core.config import ray_config

        ray_config().apply_system_config(_system_config)
        if not ray_config().flight_recorder:
            # Raylets and workers read the flag from the inherited env.
            from ray_tpu_torch.core import flight

            flight.disable()
        if address and address.startswith("ray://"):
            raise NotImplementedError(
                "the ray:// client comes with a later slice of the port")
        if local_mode:
            from ray_tpu_torch.core.local_mode import LocalModeRuntime

            _runtime = LocalModeRuntime(num_cpus=num_cpus,
                                        namespace=namespace)
        else:
            from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

            _runtime = ClusterRuntime.connect_or_start(
                address=address, num_cpus=num_cpus, num_gpus=num_gpus,
                resources=resources, namespace=namespace,
                object_store_memory=object_store_memory,
                log_to_driver=log_to_driver)
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
    # Compiled-graph futures resolve through their channel, not the
    # object plane (reference: ray.get accepts CompiledDAGRef).
    if getattr(object_refs, "_is_compiled_dag_ref", False):
        return object_refs.get(timeout=timeout)
    if isinstance(object_refs, (list, tuple)) and any(
            getattr(r, "_is_compiled_dag_ref", False) for r in object_refs):
        return [get(r, timeout=timeout) for r in object_refs]
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
