"""Model multiplexing: many models per replica with LRU residency, the port
of `ray_tpu/serve/multiplex.py`.

Reference equivalent: `python/ray/serve/multiplex.py`
(`_ModelMultiplexWrapper`) + `serve.get_multiplexed_model_id()` — the
LLM-adapter pattern: one replica holds up to N loaded models (adapters,
per-tenant models); requests carry a model id; the router prefers the
replica that already has that model warm.

Two guarantees the LRU makes under concurrency:

- **single-flight loads**: concurrent `get_model` calls for the same
  cold model id share ONE load — an expensive model is never loaded
  twice side by side;
- **drain-deferred eviction**: evicting a model that an in-flight
  request is still using defers the actual drop until that request
  finishes. The replica opens a per-request "loan" scope
  (`_begin_request_loans` / `_end_request_loans`); every model a
  request touches is loaned to it, and eviction of a loaned model parks
  it in `_pending_evict` (out of the LRU — new requests reload fresh)
  until its loan count drains to zero. Dropping the last reference is
  where a model on the card can free its memory; a model whose threads
  hold it (an engine's scheduler) must stop them when it is dropped.

The replica's streaming path runs each request's async generator on an
event loop of its own thread (`Replica._iterate_result`), so, unlike the
reference's, the loader here is shared across threads and loops: the
in-flight load is a `concurrent.futures.Future` that a caller on any
loop awaits, and the LRU's bookkeeping is under a lock. On one loop the
order of loads, evictions and drops is the reference's.

Usage:

    @serve.deployment
    class Adapters:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_adapter(model_id)          # expensive

        async def __call__(self, prompt):
            model = await self.get_model(
                serve.get_multiplexed_model_id())
            return model(prompt)

    handle.options(multiplexed_model_id="tenant-7").remote(prompt)
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

_request_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")

# Per-request loan scope: every (wrapper, model_id) the request touches.
# Set by the replica around each request; plain code (including sync
# generators on executor threads) sees its own copy per context.
_request_loans: contextvars.ContextVar[Optional[List[Tuple[Any, str]]]] \
    = contextvars.ContextVar("serve_multiplex_loans", default=None)


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (empty when the request had
    none). Reference: serve.get_multiplexed_model_id."""
    return _request_model_id.get()


def _set_request_model_id(model_id: str):
    return _request_model_id.set(model_id)


def _begin_request_loans():
    """Open a loan scope for the current request; returns an opaque
    scope to pass to `_end_request_loans`. The loan list travels WITH
    the scope (not just the contextvar) so overlapping scopes release
    exactly their own loans."""
    loans: List[Tuple[Any, str]] = []
    return (_request_loans.set(loans), loans)


def _end_request_loans(scope) -> None:
    """Close the request's loan scope: release every model it borrowed
    (deferred evictions drop here once the last borrower leaves)."""
    token, loans = scope
    try:
        _request_loans.reset(token)
    except ValueError:
        # Generator bodies may resume under a different context than
        # the one that created the token; the release below is what
        # matters, the var itself resets with the context.
        pass
    for wrapper, model_id in loans:
        try:
            wrapper._release(model_id)
        except Exception:
            pass


class _ModelMultiplexWrapper:
    """Per-replica LRU of loaded models keyed by model id."""

    def __init__(self, load_fn: Callable, owner: Any, max_models: int):
        self._load_fn = load_fn
        self._owner = owner
        self._max = max(1, max_models)
        self._lock = threading.Lock()            # _models and _loading
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        # model_id -> the in-flight load (single-flight)
        self._loading: Dict[str, concurrent.futures.Future] = {}
        self._refs_lock = threading.Lock()
        self._refs: Dict[str, int] = {}          # in-flight loans
        self._pending_evict: Dict[str, Any] = {}  # evicted, draining

    @property
    def model_ids(self):
        with self._lock:
            return list(self._models.keys())

    # -- loan accounting (drain-deferred eviction) ---------------------
    def _loan(self, model_id: str) -> None:
        loans = _request_loans.get()
        if loans is None:
            return  # no request scope (direct call): immediate-evict mode
        with self._refs_lock:
            self._refs[model_id] = self._refs.get(model_id, 0) + 1
        loans.append((self, model_id))

    def _release(self, model_id: str) -> None:
        """One borrower finished with the model; drop a parked eviction
        once the last borrower leaves (this is where device memory
        actually frees)."""
        with self._refs_lock:
            n = self._refs.get(model_id, 0) - 1
            if n > 0:
                self._refs[model_id] = n
                return
            self._refs.pop(model_id, None)
            evicted = self._pending_evict.pop(model_id, None)
        del evicted

    def _evict_lru_locked(self) -> Any:
        """Take the LRU model out; returns it when no request holds it
        (the caller drops it outside the lock), else parks it."""
        evicted_id, evicted = self._models.popitem(last=False)
        with self._refs_lock:
            if self._refs.get(evicted_id, 0) > 0:
                # In use by an in-flight request: park it until the
                # last borrower releases — dropping now would free the
                # model under a request still running it.
                self._pending_evict[evicted_id] = evicted
                return None
        return evicted

    async def load(self, model_id: str) -> Any:
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)      # LRU touch
                self._loan(model_id)
                return self._models[model_id]
            pending = self._loading.get(model_id)
            if pending is None:
                fut: concurrent.futures.Future = concurrent.futures.Future()
                self._loading[model_id] = fut
        if pending is not None:
            # The shield keeps a waiter's cancellation off the shared
            # load; wrap_future lets a caller on any loop wait for it.
            model = await asyncio.shield(asyncio.wrap_future(pending))
            # The winner's load may have been evicted between its
            # completion and our wake-up; loan whatever we hand out.
            self._loan(model_id)
            return model
        try:
            model = self._load_fn(self._owner, model_id)
            if asyncio.iscoroutine(model):
                model = await model
            with self._lock:
                evicted = [self._evict_lru_locked()
                           for _ in range(len(self._models) - self._max + 1)]
                self._models[model_id] = model
                self._loan(model_id)
                self._loading.pop(model_id, None)
            # Out of the LRU either way; an unused model goes NOW
            # (reference: calls __del__ on eviction).
            del evicted
            fut.set_result(model)
            return model
        except BaseException as e:
            with self._lock:
                self._loading.pop(model_id, None)
            if not fut.done():
                fut.set_exception(e)
            raise


def multiplexed(fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for the replica's model-loader method (reference:
    serve.multiplexed). The wrapped method becomes an LRU-cached loader;
    calling it with a model id returns the warm model."""

    def wrap(load_fn: Callable):
        attr = f"__serve_multiplex_{load_fn.__name__}"
        create_lock = threading.Lock()

        async def loader(self, model_id: Optional[str] = None):
            wrapper = getattr(self, attr, None)
            if wrapper is None:
                with create_lock:
                    wrapper = getattr(self, attr, None)
                    if wrapper is None:
                        wrapper = _ModelMultiplexWrapper(
                            load_fn, self, max_num_models_per_replica)
                        setattr(self, attr, wrapper)
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or set "
                    "handle.options(multiplexed_model_id=...) on the "
                    "request")
            return await wrapper.load(model_id)

        loader.__serve_multiplexed__ = True
        loader.__name__ = load_fn.__name__
        return loader

    if fn is not None:
        return wrap(fn)
    return wrap
