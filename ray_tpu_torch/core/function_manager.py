"""Function/actor-class export over GCS KV, by reference.

The port of `ray_tpu/core/function_manager.py`. The reference pickles a
function or class by value with cloudpickle; the port carries no
cloudpickle, so it exports the object's module and qualified name, and a
worker imports it. So an exported object must be reachable by that name:

- a function or class defined at a module's top level exports; the
  wrappers that `@remote` and `@serve.deployment` leave under its name
  resolve to it;
- an object of the driver's `__main__` exports with the path of the
  driver's main file: a worker loads that file once as the module
  `__ray_tpu_main__` (so its `if __name__ == "__main__":` block does not
  run), and unpickling maps `__main__` onto it (`find_class`);
- a lambda, a closure or a class defined inside a function raises a
  `TypeError` that names it and says to define it at module level.

The same rule holds for functions and classes inside task arguments and
results (`core/serialization.py` pickles them through `reducer_override`
here), and for the Serve controller's checkpoint.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import sys
import threading
import types
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.codec import packb, unpackb

MAIN_ALIAS = "__ray_tpu_main__"

_main_lock = threading.Lock()


def _hash_blob(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:32]


def _unwrap(obj: Any) -> Any:
    """The function or class under a `@remote` / `@serve.deployment`
    wrapper (their `_function` / `_cls`), else `obj`."""
    if isinstance(obj, (types.FunctionType, type)):
        return obj
    for attr in ("_function", "_cls"):
        inner = getattr(obj, attr, None)
        if isinstance(inner, (types.FunctionType, type)):
            return inner
    return obj


def _walk(module: Any, qualname: str) -> Any:
    obj = module
    for part in qualname.split("."):
        obj = _unwrap(getattr(obj, part))
    return obj


def main_module() -> Optional[types.ModuleType]:
    """The module that `__main__` names in pickles read by this process:
    the driver's main file loaded as `__ray_tpu_main__` in a worker, the
    real `__main__` elsewhere."""
    return sys.modules.get(MAIN_ALIAS) or sys.modules.get("__main__")


def load_main(path: str) -> types.ModuleType:
    """Load the driver's main file as `__ray_tpu_main__`, once per
    process."""
    with _main_lock:
        mod = sys.modules.get(MAIN_ALIAS)
        if mod is not None:
            return mod
        spec = importlib.util.spec_from_file_location(MAIN_ALIAS, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load the driver's main file {path!r}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[MAIN_ALIAS] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[MAIN_ALIAS]
            raise
        return mod


def _driver_main_path() -> Optional[str]:
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    return os.path.abspath(path) if path else None


def reference_of(obj: Any) -> Tuple[str, str, Optional[str]]:
    """(module, qualname, main file or None) that name `obj`, or a
    `TypeError` that says why it cannot be exported by reference."""
    target = _unwrap(obj)
    module = getattr(target, "__module__", None)
    qualname = getattr(target, "__qualname__", None)
    label = f"{qualname or target!r} (module {module})"
    if not module or not qualname or "<" in qualname:
        raise TypeError(
            f"{label} is a lambda, a closure or defined inside a function: "
            "the port exports functions and classes by reference (it has "
            "no cloudpickle), so define it at module level")
    main_path = None
    if module in ("__main__", MAIN_ALIAS):
        mod = main_module()
        path = getattr(mod, "__file__", None)
        if path is None:
            raise TypeError(
                f"{label} is defined in a __main__ with no file (an "
                "interactive session): define it in a module file")
        main_path = os.path.abspath(path)
    else:
        mod = sys.modules.get(module)
    try:
        found = _walk(mod, qualname) if mod is not None else None
    except AttributeError:
        found = None
    if found is not target:
        raise TypeError(
            f"{label} is not reachable as {module}.{qualname}: define it "
            "at module level under its own name (the port exports "
            "functions and classes by reference)")
    return module, qualname, main_path


def resolve(module: str, qualname: str,
            main_path: Optional[str] = None) -> Any:
    """Import what `reference_of` named."""
    if module in ("__main__", MAIN_ALIAS):
        # The process whose main file it is reads its own __main__; any
        # other loads the file as __ray_tpu_main__.
        mod = (sys.modules["__main__"] if _driver_main_path() == main_path
               else load_main(main_path))
    else:
        mod = importlib.import_module(module)
    return _walk(mod, qualname)


def _by_reference(module: str, qualname: str,
                  main_path: Optional[str] = None) -> Any:
    """Unpickling hook for a function or class exported by reference."""
    return resolve(module, qualname, main_path)


def reduce_by_reference(obj: Any):
    """`reducer_override` half for functions and classes: NotImplemented
    where plain pickling names them; a `_by_reference` call where only a
    wrapper (`@remote`, `@serve.deployment`) sits under their name or
    they live in `__main__`; a TypeError for a local object."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None) or ""
    if module not in (None, "__main__", MAIN_ALIAS) and "<" not in qualname:
        try:
            found = sys.modules[module]
            for part in qualname.split("."):
                found = getattr(found, part)
            if found is obj:
                return NotImplemented
        except (KeyError, AttributeError):
            pass
    try:
        return _by_reference, reference_of(obj)
    except TypeError:
        if module == "__main__" or "<" in qualname:
            raise
        return NotImplemented   # plain pickle's own error names it


class FunctionManager:
    def __init__(self, kv_put, kv_get):
        """kv_put(key: str, value: bytes, overwrite) / kv_get(key) -> bytes;
        both synchronous callables provided by the runtime."""
        self._kv_put = kv_put
        self._kv_get = kv_get
        # id(obj) -> (weakref(obj), key). The weakref is re-verified on
        # every hit: CPython recycles ids of collected objects, so a bare
        # id-keyed cache could hand a *different* object at a reused
        # address the old one's key.
        self._exported: Dict[int, Tuple[Any, str]] = {}
        self._cache: Dict[str, Any] = {}      # key -> callable/class
        self._lock = threading.Lock()

    def export(self, obj: Callable) -> str:
        oid = id(obj)
        with self._lock:
            entry = self._exported.get(oid)
            if entry is not None:
                ref, key = entry
                if ref() is obj:
                    return key
                del self._exported[oid]
        module, qualname, main_path = reference_of(obj)
        blob = packb({"m": module, "q": qualname, "main": main_path})
        key = f"fn:{_hash_blob(blob)}"
        self._kv_put(key, blob, False)
        with self._lock:
            try:
                # Eviction callback bounds _exported: once the object is
                # collected its entry can never validate again, so drop it.
                self._exported[oid] = (
                    weakref.ref(obj, lambda _, oid=oid:
                                self._exported.pop(oid, None)), key)
            except TypeError:
                pass  # not weakref-able: no fast path
            self._cache[key] = obj
        return key

    def fetch(self, key: str) -> Any:
        with self._lock:
            obj = self._cache.get(key)
            if obj is not None:
                return obj
        blob = self._kv_get(key)
        if blob is None:
            raise KeyError(f"function blob {key} not found in GCS")
        ref = unpackb(blob)
        obj = resolve(ref["m"], ref["q"], ref.get("main"))
        with self._lock:
            self._cache[key] = obj
        return obj
