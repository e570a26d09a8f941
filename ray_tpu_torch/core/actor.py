"""Actor API: `@remote class`, `.remote()` creation, handles, method calls
and their `.bind` to lazy DAG nodes (the port of `ray_tpu/core/actor.py`;
Serve has its own `bind`).

Reference equivalent: `python/ray/actor.py` — `ActorClass` (`:425`),
`ActorClass.remote` (`:565`), `ActorHandle` (`:1067`) with method proxies; GCS
owns the actor lifecycle (`gcs_actor_manager.h:251-280`).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.options import ActorOptions, TaskOptions, actor_options, task_options


class ActorMethod:
    """Bound method proxy on a handle: `handle.f.remote(...)`."""

    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: Any = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        opts = task_options({"num_returns": self._num_returns})
        return self._handle._submit(self._method_name, args, kwargs, opts)

    def options(self, **updates):
        from ray_tpu_torch.core.options import OptionsProxy
        base = task_options({"num_returns": self._num_returns})
        opts = task_options(updates, base=base)
        handle, name = self._handle, self._method_name

        def _bind(args, kwargs):
            from ray_tpu_torch.dag import ClassMethodNode
            return ClassMethodNode(handle, name, args, kwargs, options=opts)

        return OptionsProxy(
            submit=lambda args, kwargs: handle._submit(name, args, kwargs,
                                                       opts),
            bind=_bind)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassMethodNode
        opts = task_options({"num_returns": self._num_returns})
        return ClassMethodNode(self._handle, self._method_name, args, kwargs,
                               options=opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            "use '.remote()'."
        )


class ActorHandle:
    """Serializable reference to a live actor."""

    def __init__(self, actor_id: ActorID, class_name: str,
                 method_meta: Dict[str, Any], runtime=None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_meta = method_meta
        self._runtime = runtime

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id

    def _actor_runtime(self):
        if self._runtime is None:
            from ray_tpu_torch.core.worker import current_runtime
            self._runtime = current_runtime()
        return self._runtime

    def _submit(self, method_name: str, args, kwargs, opts: TaskOptions):
        return self._actor_runtime().submit_actor_task(
            self, method_name, opts, args, kwargs)

    def __getattr__(self, name: str):
        if name == "__ray_call__":
            # Run an arbitrary function against the live actor instance:
            # handle.__ray_call__.remote(fn, *args) -> fn(instance, *args)
            # (reference: actor.py __ray_call__ system method).
            return ActorMethod(self, "__ray_call__", 1)
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta
        if meta and name not in meta:
            raise AttributeError(
                f"Actor class '{self._class_name}' has no method '{name}'")
        num_returns = (meta or {}).get(name, {}).get("num_returns", 1)
        return ActorMethod(self, name, num_returns)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)

    def __reduce__(self):
        return (_rebuild_actor_handle,
                (self._actor_id, self._class_name, self._method_meta))


def _rebuild_actor_handle(actor_id, class_name, method_meta):
    return ActorHandle(actor_id, class_name, method_meta)


class ActorClass:
    def __init__(self, cls: type, options_dict: Dict[str, Any]):
        self._cls = cls
        self._default_options = actor_options(options_dict)
        functools.update_wrapper(self, cls, updated=[])

    @property
    def _class_name(self) -> str:
        return self._cls.__name__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._class_name}' cannot be instantiated "
            "directly. Use 'cls.remote()'."
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def options(self, **updates):
        from ray_tpu_torch.core.options import OptionsProxy
        new_opts = actor_options(updates, base=self._default_options)

        def _bind(args, kwargs):
            from ray_tpu_torch.dag import ClassNode
            return ClassNode(self, args, kwargs, new_opts)

        return OptionsProxy(
            submit=lambda args, kwargs: self._remote(args, kwargs, new_opts),
            bind=_bind)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs, self._default_options)

    def method_meta(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {}
        for name, member in inspect.getmembers(self._cls,
                                               predicate=callable):
            if name.startswith("__") and name != "__call__":
                continue
            meta[name] = {
                "num_returns": getattr(member, "_num_returns", 1),
                "concurrency_group": getattr(member,
                                             "_concurrency_group", None),
                "is_async": (inspect.iscoroutinefunction(member)
                             or inspect.isasyncgenfunction(member)),
                "is_generator": inspect.isgeneratorfunction(member)
                or inspect.isasyncgenfunction(member),
            }
        return meta

    def _remote(self, args, kwargs, opts: ActorOptions) -> ActorHandle:
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime()
        return rt.create_actor(self, opts, args, kwargs)


def method(*, num_returns: Any = 1, concurrency_group: Optional[str] = None):
    """`@method(num_returns=n)` decorator on actor methods
    (reference: python/ray/actor.py `method`)."""

    def decorator(fn):
        fn._num_returns = num_returns
        fn._concurrency_group = concurrency_group
        return fn

    return decorator
