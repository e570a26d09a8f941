"""ObjectRef: the user-facing handle to an object in the distributed store.

Reference equivalent: `python/ray/_raylet.pyx` ObjectRef + the ownership model
of `src/ray/core_worker/reference_count.h` — each ref knows its owner; local
Python refcount drives release (`__del__` -> runtime.remove_local_reference);
serializing a ref inside a task argument or object value registers a borrow.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional

from ray_tpu_torch.core.ids import ObjectID

_thread_local = threading.local()


@contextlib.contextmanager
def _serialization_context(ref_hook: Optional[Callable[[Any], None]]):
    prev = getattr(_thread_local, "ref_hook", None)
    _thread_local.ref_hook = ref_hook
    try:
        yield
    finally:
        _thread_local.ref_hook = prev


class ObjectRef:
    __slots__ = ("_id", "_owner", "_runtime", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[bytes] = None,
                 runtime=None, skip_adding_local_ref: bool = False):
        self._id = object_id
        self._owner = owner  # opaque owner address (worker id bytes / addr tuple)
        self._runtime = runtime
        if runtime is not None and not skip_adding_local_ref:
            runtime.add_local_reference(object_id)

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    @property
    def owner_address(self):
        return self._owner

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    def __del__(self):
        rt = self._runtime
        if rt is not None:
            try:
                # Finalizers must not take runtime locks (GC can fire
                # them while those locks are held): prefer the deferred
                # lock-free release path when the runtime has one.
                release = getattr(rt, "deferred_release", None) \
                    or rt.remove_local_reference
                release(self._id)
            except Exception:
                pass

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _fill():
            # The ref's own runtime: a thread that outlives the runtime
            # must see its shutdown, not start a new one.
            rt = self._runtime
            if rt is None:
                from ray_tpu_torch.core.worker import current_runtime
                rt = current_runtime()
            try:
                fut.set_result(rt.get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_fill, daemon=True,
                         name="object-ref-future").start()
        return fut

    def __await__(self):
        """Await support inside asyncio actors / drivers."""
        import asyncio
        return asyncio.wrap_future(self.future()).__await__()

    def __reduce__(self):
        hook = getattr(_thread_local, "ref_hook", None)
        if hook is not None:
            hook(self)
        return (_rebuild_object_ref, (self._id.binary(), self._owner))


def _rebuild_object_ref(binary: bytes, owner):
    from ray_tpu_torch.core.worker import current_runtime

    rt = current_runtime(or_none=True)
    ref = ObjectRef(ObjectID(binary), owner, rt, skip_adding_local_ref=True)
    if rt is not None:
        rt.on_ref_deserialized(ref)
    hook = getattr(_thread_local, "ref_hook", None)
    if hook is not None:
        hook(ref)
    return ref
