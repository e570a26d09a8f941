"""ray_tpu_torch.serve — model serving on the actor runtime, ported from
`ray_tpu/serve/__init__.py`.

Reference equivalent: `python/ray/serve/` — `@serve.deployment` +
`serve.run` with a controller reconciling replica actors, an HTTP ingress
proxy, power-of-two-choices routing, queue-length autoscaling, and
graceful rolling updates. `@serve.batch` folds concurrent single requests
into one batched forward pass (`serve/batching.py` in the reference).

Serve stands on the port's in-process runtime: the controller, the proxy
and every replica are actors of one process, each replica a thread with
its own event loop, so a replica's model shares the process (and a card)
with every other. The serving engine (`serve.engine`) and the fleet over
it (`serve.fleet`) are subpackages.

`compile_deployment_chain` (`serve/cgraph.py`) compiles a chain of
deployments into a compiled graph over one pinned replica of each.
`@serve.multiplexed` (`serve/multiplex.py`) keeps several models a
replica behind an LRU, keyed by the request's `multiplexed_model_id`.
`start_grpc_ingress` and `GrpcServeClient` (`serve/_private/
grpc_proxy.py`) are the gRPC ingress and its client; they need the
grpcio package, which is imported only there.
"""

from __future__ import annotations

import asyncio
import functools
import time
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                  HTTPOptions)
from ray_tpu_torch.serve.exceptions import (DeploymentUnavailableError,
                                      RayServeException,
                                      ReplicaDrainingError)
from ray_tpu_torch.serve.handle import (DeploymentHandle,
                                        DeploymentResponse,
                                        DeploymentResponseGenerator)
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

__all__ = [
    "deployment", "run", "start", "delete", "shutdown", "status",
    "get_app_handle", "get_deployment_handle", "batch",
    "configure_proxy_admission", "proxy_admission_stats",
    "multiplexed", "get_multiplexed_model_id", "start_grpc_ingress",
    "GrpcServeClient", "compile_deployment_chain",
    "Deployment", "Application", "DeploymentHandle",
    "DeploymentResponse", "DeploymentResponseGenerator",
    "AutoscalingConfig", "DeploymentConfig",
    "HTTPOptions", "RayServeException", "ReplicaDrainingError",
    "DeploymentUnavailableError",
]


def __getattr__(name):
    # Lazy: grpc imports only when the ingress is actually used.
    if name == "GrpcServeClient":
        from ray_tpu_torch.serve._private.grpc_proxy import GrpcServeClient

        return GrpcServeClient
    if name == "compile_deployment_chain":
        from ray_tpu_torch.serve.cgraph import compile_deployment_chain

        return compile_deployment_chain
    raise AttributeError(name)

_PROXY_NAME = "SERVE_PROXY"
_http_port: Optional[int] = None
_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"
_grpc_port: Optional[int] = None


class Deployment:
    """The declarative unit: a user class + deployment config.
    Reference: serve/deployment.py Deployment."""

    def __init__(self, cls, name: str, config: DeploymentConfig):
        self._cls = cls
        self.name = name
        self.config = config

    def options(self, *, num_replicas: Optional[int] = None,
                version: Optional[str] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config: Optional[AutoscalingConfig] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                name: Optional[str] = None) -> "Deployment":
        cfg = replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if version is not None:
            cfg.version = version
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        return Deployment(self._cls, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


class Application:
    """A bound deployment graph node (reference: serve/api.py
    Application + deployment_graph_build.py): a deployment plus init
    args which may themselves contain bound Applications — `serve.run`
    deploys the children first and replaces them with handles (model
    composition)."""

    def __init__(self, deployment: Deployment, args, kwargs):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class _HandleMarker:
    """Placeholder for a child deployment's handle inside init args;
    swapped for a live DeploymentHandle in the replica process."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name

    def __repr__(self):
        return f"_HandleMarker({self.deployment_name})"


def _map_tree(value, leaf_fn):
    """Shared structural walk for handle substitution/resolution —
    one walker so deploy-side and replica-side can't drift. Unchanged
    subtrees are returned AS-IS (identity), so container subclasses
    (namedtuples, OrderedDict, user types) pass through untouched
    unless they actually contain a marker/application."""
    mapped = leaf_fn(value)
    if mapped is not value:
        return mapped
    if isinstance(value, tuple):
        items = [_map_tree(v, leaf_fn) for v in value]
        if all(a is b for a, b in zip(items, value)):
            return value
        if hasattr(value, "_fields"):      # namedtuple
            return type(value)(*items)
        return tuple(items)
    if isinstance(value, list):
        items = [_map_tree(v, leaf_fn) for v in value]
        if all(a is b for a, b in zip(items, value)):
            return value
        return items
    if isinstance(value, dict):
        items = {k: _map_tree(v, leaf_fn) for k, v in value.items()}
        if all(items[k] is value[k] for k in value):
            return value
        try:
            return type(value)(items)
        except Exception:
            return items
    return value


def _substitute_applications(value, deploy_child):
    """Deep-replace bound Applications with handle markers, deploying
    each child (post-order) via `deploy_child(app) -> name`."""
    return _map_tree(
        value, lambda v: _HandleMarker(deploy_child(v))
        if isinstance(v, Application) else v)


def deployment(cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               max_ongoing_requests: int = 16,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               version: Optional[str] = None):
    """`@serve.deployment` (reference: serve/api.py:deployment)."""

    def wrap(c):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options or {},
            version=version)
        return Deployment(c, name or c.__name__, cfg)

    return wrap(cls) if cls is not None else wrap


# ---------------------------------------------------------------------------
# control plane entry points
# ---------------------------------------------------------------------------
def _get_or_create_controller():
    from ray_tpu_torch.core.remote_function import remote
    from ray_tpu_torch.core.worker import get_actor
    from ray_tpu_torch.serve._private.controller import (CONTROLLER_NAME,
                                                         ServeController)

    try:
        return get_actor(CONTROLLER_NAME)
    except Exception:
        pass
    # Detached and restartable, as the reference's (the in-process
    # runtime restarts nothing). Generous concurrency: every live router
    # long-polls listen_for_change and each poll occupies a slot for its
    # full wait.
    actor_cls = remote(num_cpus=0, name=CONTROLLER_NAME,
                       max_concurrency=128, max_restarts=-1,
                       lifetime="detached")(ServeController)
    try:
        return actor_cls.remote()
    except Exception:
        # Lost a creation race: someone else registered the name first.
        return get_actor(CONTROLLER_NAME)


def start(http_options: Optional[HTTPOptions] = None) -> int:
    """Start (or find) the Serve instance: controller + HTTP proxy.
    Returns the proxy port."""
    global _http_port
    from ray_tpu_torch.core.remote_function import remote
    from ray_tpu_torch.core.worker import get, get_actor
    from ray_tpu_torch.serve._private.proxy import HTTPProxy

    controller = _get_or_create_controller()
    try:
        proxy = get_actor(_PROXY_NAME)
    except Exception:
        opts = http_options or HTTPOptions(port=0)
        actor_cls = remote(num_cpus=0, name=_PROXY_NAME,
                           max_concurrency=64)(HTTPProxy)
        proxy = actor_cls.remote(controller, opts.host, opts.port, opts)
        _http_port = get(proxy.start.remote(), timeout=60)
    if _http_port is None:
        _http_port = get(proxy.ready.remote(), timeout=60)
    return _http_port


def start_grpc_ingress(port: int = 0, host: str = "127.0.0.1",
                       allow_pickle: bool = True) -> int:
    """Start (or find) the gRPC ingress (reference: serve.start's
    grpc_options / gRPCProxy): a detached actor serving
    /ray_tpu.serve.ServeAPIService/Call. Returns the bound port; reach it
    with `serve.GrpcServeClient(f"127.0.0.1:{port}")`.

    The ingress unpickles request payloads by default, so it is
    TRUSTED-NETWORK-ONLY (see grpc_proxy.py's module docstring);
    `allow_pickle=False` restricts it to msgpack-native payloads for
    exposure to non-Python clients. Asking for allow_pickle=False while
    a pickle-enabled ingress is already running raises (the guarantee
    cannot be retrofitted); the reverse — a default caller finding a
    msgpack-only ingress — attaches to it, and pickle payloads are then
    rejected per request. Without grpcio this raises ImportError."""
    global _grpc_port
    from ray_tpu_torch.core.remote_function import remote
    from ray_tpu_torch.core.worker import get, get_actor
    from ray_tpu_torch.serve._private.grpc_proxy import (GrpcIngress,
                                                         _import_grpc)

    _import_grpc()
    start()
    try:
        proxy = get_actor(_GRPC_PROXY_NAME)
    except Exception:
        actor_cls = remote(num_cpus=0, name=_GRPC_PROXY_NAME,
                           max_concurrency=64)(GrpcIngress)
        proxy = actor_cls.remote(host, port, allow_pickle)
        _grpc_port = get(proxy.start.remote(), timeout=60)
        return _grpc_port
    # Existing ingress: the no-pickle guarantee cannot be retrofitted —
    # silently returning a pickle-enabled port would void what the
    # caller explicitly asked for.
    if not allow_pickle and get(proxy.allows_pickle.remote(), timeout=30):
        raise RayServeException(
            "gRPC ingress is already running WITH pickle payloads "
            "enabled; serve.shutdown() it before starting an "
            "allow_pickle=False ingress")
    if _grpc_port is None:
        _grpc_port = get(proxy.start.remote(), timeout=60)
    return _grpc_port


def configure_proxy_admission(max_inflight: Optional[int] = None,
                              rate: Optional[float] = None,
                              burst: int = 16) -> bool:
    """(Re)configure the HTTP ingress overload gate at runtime: an
    in-flight cap (excess answers 503 before any work is queued) and a
    token-bucket rate limit (429). `None` disables a gate. Sheds are
    counted in `serve_engine_shed_requests`."""
    from ray_tpu_torch.core.worker import get, get_actor

    start()
    proxy = get_actor(_PROXY_NAME)
    return get(proxy.configure_admission.remote(
        max_inflight, rate, burst), timeout=30)


def proxy_admission_stats() -> Dict[str, Any]:
    """Current gate state + shed counts from the HTTP ingress."""
    from ray_tpu_torch.core.worker import get, get_actor

    start()   # same contract as configure_proxy_admission
    proxy = get_actor(_PROXY_NAME)
    return get(proxy.admission_stats.remote(), timeout=30)


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        wait_for_ready: bool = True,
        _blocking_timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy (or update) an application; returns its handle
    (reference: serve/api.py:run)."""
    from ray_tpu_torch.core.worker import get_actor
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    start()
    controller = get_actor(CONTROLLER_NAME)

    deployed: list = []
    assigned: dict = {}     # id(Application) -> deployed name (diamonds)
    # The ROOT's name is reserved up front: a child of the same class
    # must uniquify, not overwrite the ingress (or vice versa).
    used_names: set = {app.deployment.name}

    def deploy_child(child: Application) -> str:
        if id(child) in assigned:
            return assigned[id(child)]  # same bound node reused: share
        base = child.deployment.name
        name = base
        n = 1
        while name in used_names:
            # Two DIFFERENT children of the same class must not collapse
            # into one deployment (reference uniquifies graph nodes).
            name = f"{base}_{n}"
            n += 1
        used_names.add(name)
        assigned[id(child)] = name
        _deploy_app(controller, child, route_prefix=None,
                    deploy_child=deploy_child, name=name)
        deployed.append(name)
        return name

    _deploy_app(controller, app, route_prefix=route_prefix,
                deploy_child=deploy_child)
    dep = app.deployment
    handle = DeploymentHandle(dep.name, controller)
    if wait_for_ready:
        for name in deployed + [dep.name]:
            _wait_ready(controller, name, _blocking_timeout_s)
    return handle


def _deploy_app(controller, app: Application,
                route_prefix: Optional[str], deploy_child,
                name: Optional[str] = None) -> None:
    from ray_tpu_torch.core.worker import get

    dep = app.deployment
    # Children deploy first (post-order), so by the time this deployment
    # constructs, its dependencies resolve.
    init_args = _substitute_applications(tuple(app.init_args),
                                         deploy_child)
    init_kwargs = _substitute_applications(dict(app.init_kwargs),
                                           deploy_child)
    get(controller.deploy.remote(
        name or dep.name, dep._cls, init_args, init_kwargs, dep.config,
        route_prefix=route_prefix), timeout=60)


def _wait_ready(controller, deployment_name: str,
                timeout_s: float) -> None:
    from ray_tpu_torch.core.worker import get

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        # The controller's loop is busy while a replica's constructor
        # runs in it (a model build): wait up to the whole deadline.
        status_ = get(controller.status.remote(),
                      timeout=max(0.1, deadline - time.monotonic()))
        info = status_.get(deployment_name)
        if info and any(r["state"] == "RUNNING"
                        for r in info["replicas"]):
            return
        time.sleep(0.1)
    raise TimeoutError(
        f"deployment {deployment_name!r} has no RUNNING replica after "
        f"{timeout_s}s")


def status() -> Dict[str, Any]:
    from ray_tpu_torch.core.worker import get

    controller = _get_or_create_controller()
    return get(controller.status.remote(), timeout=30)


def get_app_handle(name: str) -> DeploymentHandle:
    return get_deployment_handle(name)


def get_deployment_handle(deployment_name: str) -> DeploymentHandle:
    from ray_tpu_torch.core.worker import get_actor
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    controller = get_actor(CONTROLLER_NAME)
    return DeploymentHandle(deployment_name, controller)


def delete(deployment_name: str) -> None:
    from ray_tpu_torch.core.worker import get, get_actor
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    controller = get_actor(CONTROLLER_NAME)
    get(controller.delete_deployment.remote(deployment_name),
                timeout=60)


def shutdown() -> None:
    """Delete every deployment (each replica drained, then killed), then
    stop and kill the proxies and the controller. Without a runtime
    there is nothing to shut down."""
    global _http_port, _grpc_port
    from ray_tpu_torch.core.worker import current_runtime, kill
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    _http_port = None
    _grpc_port = None
    rt = current_runtime(or_none=True)
    if rt is None:
        return
    try:
        controller = rt.get_actor(CONTROLLER_NAME)
        rt.get(controller.shutdown.remote(), timeout=60)
        kill(controller)
    except Exception:
        pass
    for name in (_PROXY_NAME, _GRPC_PROXY_NAME):
        try:
            proxy = rt.get_actor(name)
            rt.get(proxy.stop.remote(), timeout=15)
            kill(proxy)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# request batching
# ---------------------------------------------------------------------------
def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Fold concurrent single calls into one batched call (reference:
    `python/ray/serve/batching.py` @serve.batch). The wrapped async
    method receives a LIST of inputs and must return a list of outputs;
    callers await single results. On a model this turns N
    replica-concurrent requests into one [N, ...] forward pass."""

    def wrap(f):
        queues: Dict[int, "_BatchQueue"] = {}

        @functools.wraps(f)
        async def wrapper(self, item):
            loop = asyncio.get_running_loop()
            q = queues.get(id(loop))
            if q is None:
                q = _BatchQueue(f, max_batch_size, batch_wait_timeout_s)
                queues[id(loop)] = q
            return await q.submit(self, item)

        wrapper._is_serve_batch = True
        return wrapper

    return wrap(fn) if fn is not None else wrap


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = wait_timeout_s
        self._items: List[Any] = []
        self._futures: List[asyncio.Future] = []
        self._flusher: Optional[asyncio.Task] = None
        # Strong refs to in-flight batch tasks: the event loop only
        # keeps WEAK references to tasks, so a flush fired for waiters
        # whose callers were since cancelled could be garbage-collected
        # mid-run — dropping the whole batch on the floor.
        self._tasks: set = set()

    async def submit(self, owner, item):
        fut = asyncio.get_running_loop().create_future()
        self._items.append(item)
        self._futures.append(fut)
        if len(self._items) >= self._max:
            self._flush_now(owner)
        elif self._flusher is None or self._flusher.done():
            # The flusher is an INDEPENDENT task, deliberately not
            # awaited by this submit: cancelling the first awaiter must
            # not cancel the timer the rest of the batch relies on.
            self._flusher = asyncio.get_running_loop().create_task(
                self._delayed_flush(owner))
        # If the caller is cancelled here, its slot still flushes with
        # the batch (results land on a done future harmlessly) and the
        # INDEPENDENT flusher task keeps ticking for the rest —
        # regression-tested in test_unit_serve_batching.py.
        return await fut

    async def _delayed_flush(self, owner):
        await asyncio.sleep(self._wait)
        self._flush_now(owner)

    def _flush_now(self, owner) -> None:
        if not self._items:
            return
        items, futures = self._items, self._futures
        self._items, self._futures = [], []
        task = asyncio.get_running_loop().create_task(
            self._run_batch(owner, items, futures))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_batch(self, owner, items, futures) -> None:
        try:
            outs = await self._fn(owner, items)
            if len(outs) != len(items):
                raise RayServeException(
                    f"@serve.batch function returned {len(outs)} results "
                    f"for {len(items)} inputs")
            for fut, out in zip(futures, outs):
                if not fut.done():
                    fut.set_result(out)
        except BaseException as e:  # noqa: BLE001
            # One failure rejects EVERY waiter of this batch: each
            # caller sees the batched fn's exception, not a hang.
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
