"""`@remote` functions (the port of `ray_tpu/core/remote_function.py`).

Reference equivalent: `python/ray/remote_function.py` (`RemoteFunction` at
`:40`, `._remote` at `:261`): a decorated function gains `.remote(*a, **kw)`
returning ObjectRef(s), `.options(**opts)` for per-call overrides, and
`.bind(*a, **kw)`, a lazy `ray_tpu_torch.dag.FunctionNode`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.core.options import TaskOptions, task_options


class FunctionDescriptor:
    """Stable identity of a remote function: module + qualname + a pickle of
    the function exported once per job (reference: function_manager.py:228
    export over GCS KV, keyed by a function hash)."""

    __slots__ = ("module", "qualname", "function_hash")

    def __init__(self, module: str, qualname: str, function_hash: bytes):
        self.module = module
        self.qualname = qualname
        self.function_hash = function_hash

    def key(self) -> bytes:
        return self.function_hash

    def __repr__(self):
        return f"FunctionDescriptor({self.module}.{self.qualname})"


class RemoteFunction:
    def __init__(self, function, options_dict: Optional[Dict[str, Any]] = None):
        if not callable(function):
            raise TypeError("@remote must decorate a callable")
        self._function = function
        self._default_options = task_options(options_dict or {})
        self._descriptor: Optional[FunctionDescriptor] = None
        functools.update_wrapper(self, function)

    @property
    def _function_name(self) -> str:
        return getattr(self._function, "__qualname__", repr(self._function))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function_name}' cannot be called "
            "directly. Use '.remote()'."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def options(self, **updates):
        from ray_tpu_torch.core.options import OptionsProxy
        new_opts = task_options(updates, base=self._default_options)
        return OptionsProxy(
            submit=lambda args, kwargs: self._remote(args, kwargs, new_opts),
            bind=lambda args, kwargs: self._bind_node(args, kwargs, new_opts))

    def _bind_node(self, args, kwargs, opts):
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs, opts)

    def bind(self, *args, **kwargs):
        """Lazy DAG-node construction (reference: python/ray/dag)."""
        return self._bind_node(args, kwargs, self._default_options)

    def _remote(self, args, kwargs, opts: TaskOptions):
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime()
        return rt.submit_task(self, opts, args, kwargs)


def remote(*args, **kwargs):
    """The `@remote` decorator for both functions and classes.

    Usage:
        @remote
        def f(): ...
        @remote(num_cpus=2, num_gpus=1)
        def g(): ...
        @remote
        class A: ...
    """
    from ray_tpu_torch.core.actor import ActorClass

    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target, {})
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes only keyword arguments")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator
