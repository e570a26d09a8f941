"""ServeController: the reconciliation loop.

Reference equivalent: `python/ray/serve/_private/controller.py:87,347` —
an actor holding target state (deployments, versions, replica counts) and
converging actual state to it: starting replicas, draining and stopping
extras, rolling version updates one replica at a time (start-new →
drain-old), restarting dead replicas, and queue-length autoscaling
(`autoscaling_policy.py:12`).

Ported from `ray_tpu/serve/_private/controller.py`. On the cluster
runtime the controller checkpoints its target state and live replica set
to the GCS KV on every change and recovers from it when it restarts
(`_save_checkpoint`, `_recover`), re-adopting the replicas, which are
named detached actors, each in its own worker process. The checkpoint is
a pickle of the port's object path (`core/serialization.py`): deployment
classes go in it by reference, so they must be defined at module level.
The in-process runtime keeps no checkpoint: there the controller cannot
die alone. A deployment without a pinned version gets one from a digest
of its class's code and a pickle of its init args (`_auto_version`),
where the reference hashes a cloudpickle of both.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import inspect
import math
import sys
import time
import types
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.serialization import _Pickler

CONTROLLER_NAME = "SERVE_CONTROLLER"
CHECKPOINT_KEY = "serve:controller_ckpt"


@dataclass
class _ReplicaState:
    handle: Any
    replica_id: str
    version: Optional[str]
    state: str = "STARTING"        # STARTING | RUNNING | STOPPING
    ongoing: int = 0
    last_seen: float = field(default_factory=time.monotonic)


@dataclass
class _DeploymentState:
    name: str
    cls_factory: Any
    init_args: tuple
    init_kwargs: dict
    config: Any                    # DeploymentConfig
    target_replicas: int
    replicas: List[_ReplicaState] = field(default_factory=list)
    route_version: int = 0         # bumped whenever the running set changes
    last_scale_up: float = 0.0
    last_scale_down: float = 0.0
    _scale_high_since: Optional[float] = None
    _scale_low_since: Optional[float] = None


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._routes: Dict[str, str] = {}   # route_prefix -> deployment
        self._routes_version = 0
        self._shutdown = False
        # The ctor runs off the actor event loop; the reconcile task is
        # created lazily from the first async call, which does run on it.
        self._loop_task = None
        self._ckpt_fingerprint: Any = None
        # Crash recovery (reference: controller.py:87 — state is
        # checkpointed to the GCS KV and reloaded on restart; replicas
        # are detached named actors the new incarnation re-adopts).
        try:
            self._recover()
        except Exception:
            import traceback

            traceback.print_exc()

    def _ensure_reconciler(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._reconcile_loop())

    # -- durability -----------------------------------------------------
    @staticmethod
    def _durable_runtime():
        """The cluster runtime this controller runs in, or None in the
        in-process runtime (no checkpoint there)."""
        from ray_tpu_torch.core.worker import current_runtime

        rt = current_runtime()
        return None if getattr(rt, "is_local_mode", False) else rt

    def _fingerprint(self):
        return (
            self._routes_version,
            tuple(sorted(
                (n, st.target_replicas, st.route_version,
                 tuple(sorted((r.replica_id, r.state)
                              for r in st.replicas)))
                for n, st in self._deployments.items())),
        )

    def _save_checkpoint(self) -> None:
        """Persist target state + the live replica set to the GCS KV on
        every mutation; a cheap no-op when nothing changed."""
        rt = self._durable_runtime()
        if rt is None:
            return
        fp = self._fingerprint()
        if fp == self._ckpt_fingerprint:
            return
        from ray_tpu_torch.core.serialization import dumps

        try:
            blob = dumps({
                "routes": dict(self._routes),
                "routes_version": self._routes_version,
                "deployments": {
                    name: {
                        "cls_factory": st.cls_factory,
                        "init_args": st.init_args,
                        "init_kwargs": st.init_kwargs,
                        "config": st.config,
                        "target_replicas": st.target_replicas,
                        # route_version must survive restarts: listeners
                        # hold the old incarnation's counters, and a
                        # reset counter would never exceed them — their
                        # long-polls would go silent forever.
                        "route_version": st.route_version,
                        "replicas": [(r.replica_id, r.version, r.state)
                                     for r in st.replicas],
                    } for name, st in self._deployments.items()},
            })
            rt.kv_put(CHECKPOINT_KEY, blob, True)
            self._ckpt_fingerprint = fp
        except Exception:
            import traceback

            traceback.print_exc()

    def _recover(self) -> None:
        rt = self._durable_runtime()
        if rt is None:
            return
        blob = rt.kv_get(CHECKPOINT_KEY)
        if not blob:
            return
        from ray_tpu_torch.core.serialization import loads

        data = loads(blob)
        self._routes = dict(data.get("routes", {}))
        self._routes_version = data.get("routes_version", 0) + 1
        for name, d in data.get("deployments", {}).items():
            st = _DeploymentState(
                name=name, cls_factory=d["cls_factory"],
                init_args=tuple(d["init_args"]),
                init_kwargs=dict(d["init_kwargs"]),
                config=d["config"],
                target_replicas=d["target_replicas"])
            for rid, version, rstate in d.get("replicas", ()):
                if rstate != "RUNNING":
                    continue  # half-started replicas restart fresh
                try:
                    handle = rt.get_actor(f"SERVE_REPLICA::{rid}")
                except Exception:
                    continue  # died with the old controller
                st.replicas.append(_ReplicaState(
                    handle=handle, replica_id=rid, version=version,
                    state="RUNNING"))
            st.route_version = d.get("route_version", 0) + 1
            self._deployments[name] = st

    # -- API (driver / serve.run) --------------------------------------
    async def deploy(self, name: str, cls_factory, init_args, init_kwargs,
                     config, route_prefix: Optional[str] = None) -> bool:
        """Create or update a deployment. A changed version triggers a
        rolling update; a changed num_replicas scales."""
        self._ensure_reconciler()
        # The caller's config is not ours to change (a cluster runtime
        # hands the controller a copy; this one passes the object).
        config = dataclasses.replace(config)
        if config.version is None:
            # Auto-version from the code + constructor args so an
            # unversioned redeploy with changes still rolls (reference:
            # serve computes a config/code version hash when the user
            # does not pin one). Unpicklable args keep None (no
            # auto-roll).
            config.version = _auto_version(cls_factory, init_args,
                                           init_kwargs)
        existing = self._deployments.get(name)
        target = (config.autoscaling_config.min_replicas
                  if config.autoscaling_config else config.num_replicas)
        if existing is None:
            self._deployments[name] = _DeploymentState(
                name=name, cls_factory=cls_factory,
                init_args=tuple(init_args), init_kwargs=dict(init_kwargs),
                config=config, target_replicas=target)
        else:
            existing.cls_factory = cls_factory
            existing.init_args = tuple(init_args)
            existing.init_kwargs = dict(init_kwargs)
            old_autoscaling = existing.config.autoscaling_config
            existing.config = config
            if config.autoscaling_config is None:
                existing.target_replicas = config.num_replicas
            elif old_autoscaling is None:
                existing.target_replicas = target
        if route_prefix is not None and \
                self._routes.get(route_prefix) != name:
            self._routes[route_prefix] = name
            self._routes_version += 1
        self._save_checkpoint()
        return True

    async def delete_deployment(self, name: str) -> bool:
        state = self._deployments.pop(name, None)
        if state is None:
            return False
        if any(d == name for d in self._routes.values()):
            self._routes = {r: d for r, d in self._routes.items()
                            if d != name}
            self._routes_version += 1
        await asyncio.gather(
            *[self._stop_replica(state, r) for r in list(state.replicas)],
            return_exceptions=True)
        self._save_checkpoint()
        return True

    async def get_routing_table(self, name: str) -> Dict[str, Any]:
        """Running replicas for a deployment + a version counter the
        router uses for cache invalidation."""
        self._ensure_reconciler()
        state = self._deployments.get(name)
        if state is None:
            return {"version": -1, "replicas": []}
        return {
            "version": state.route_version,
            "replicas": [(r.replica_id, r.handle) for r in state.replicas
                         if r.state == "RUNNING"],
        }

    async def get_routes(self) -> Dict[str, str]:
        return dict(self._routes)

    async def listen_for_change(self, versions: Dict[str, int],
                                timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll (reference: long_poll.py:174 LongPollHost): blocks
        until the route table or any listed deployment's routing version
        moves past the caller's snapshot, or timeout_s elapses; returns
        the changed snapshots. `versions` maps "__routes__" and
        deployment names to the caller's last-seen versions."""
        self._ensure_reconciler()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s

        def changed() -> Dict[str, Any]:
            out: Dict[str, Any] = {}
            # Routes only for a caller that listens for them. (The
            # reference defaults an absent "__routes__" to -1, so a
            # router's poll for its deployment alone returns at once,
            # every time: a busy loop that takes the interpreter's lock
            # from a replica's engine in the same process.)
            if ("__routes__" in versions
                    and self._routes_version > versions["__routes__"]):
                out["__routes__"] = {"version": self._routes_version,
                                     "routes": dict(self._routes)}
            for name, seen in versions.items():
                if name == "__routes__":
                    continue
                st = self._deployments.get(name)
                if st is None:
                    if seen != -1:
                        # Deleted: tell the listener to STOP polling —
                        # otherwise dead-deployment pollers pile up and
                        # exhaust the controller's concurrency slots.
                        out[name] = {"version": -1, "replicas": [],
                                     "deleted": True}
                    continue
                if st.route_version > seen:
                    out[name] = {
                        "version": st.route_version,
                        "replicas": [(r.replica_id, r.handle)
                                     for r in st.replicas
                                     if r.state == "RUNNING"],
                    }
            return out

        while True:
            out = changed()
            if out or loop.time() >= deadline or self._shutdown:
                return out
            await asyncio.sleep(0.05)

    async def status(self) -> Dict[str, Any]:
        out = {}
        for name, st in self._deployments.items():
            out[name] = {
                "target_replicas": st.target_replicas,
                "replicas": [
                    {"id": r.replica_id, "state": r.state,
                     "version": r.version, "ongoing": r.ongoing}
                    for r in st.replicas],
            }
        return out

    async def shutdown(self) -> bool:
        self._shutdown = True
        for state in list(self._deployments.values()):
            await self.delete_deployment(state.name)
        # A later serve instance must start empty, not adopt this one.
        rt = self._durable_runtime()
        if rt is not None:
            try:
                from ray_tpu_torch.core.serialization import dumps

                rt.kv_put(CHECKPOINT_KEY, dumps({}), True)
            except Exception:
                pass
        return True

    # -- reconciliation -------------------------------------------------
    async def _reconcile_loop(self) -> None:
        while not self._shutdown:
            try:
                for state in list(self._deployments.values()):
                    await self._reconcile(state)
                    await self._autoscale(state)
                # Replica-set / autoscale changes persist too, so a
                # restarted controller re-adopts the same live actors.
                self._save_checkpoint()
            except Exception:
                import traceback

                traceback.print_exc()
            await asyncio.sleep(0.1)

    async def _reconcile(self, state: _DeploymentState) -> None:
        version = state.config.version
        # 1. Reap dead replicas (health probe).
        for r in list(state.replicas):
            if r.state != "RUNNING":
                continue
            if time.monotonic() - r.last_seen \
                    < state.config.health_check_period_s:
                continue
            try:
                await _aget(r.handle.check_health.remote(), timeout=5.0)
                r.last_seen = time.monotonic()
            except Exception:
                # Reap AND kill: dropping it from the table without
                # killing would leak a live actor (and its resources)
                # serving stale traffic forever.
                state.replicas.remove(r)
                state.route_version += 1
                try:
                    _kill(r.handle)
                except Exception:
                    pass
        running = [r for r in state.replicas if r.state == "RUNNING"]
        current = [r for r in running if r.version == version]
        outdated = [r for r in running if r.version != version]
        starting = [r for r in state.replicas if r.state == "STARTING"]

        # 2. Scale up: missing replicas (count outdated ones still serving
        # so a rolling update replaces one at a time instead of doubling).
        deficit = state.target_replicas - (len(current) + len(starting)
                                           + len(outdated))
        # During a rolling update keep one extra slot so a new-version
        # replica starts BEFORE an old one drains (no capacity dip) — one
        # slot, and only while the new version is short of the target.
        # (The reference grants the slot whenever none is starting, so the
        # tick that promotes a new replica starts one more, which the
        # scale-down then stops: a 1-replica update builds two.)
        if outdated and deficit <= 0:
            fresh = len(current) + len(starting)
            deficit = max(0, min(1, state.target_replicas - fresh,
                                 state.target_replicas + 1
                                 - fresh - len(outdated)))
        if deficit > 0:
            # A replica's constructor may take seconds (a model build; in
            # the in-process runtime it runs in the calling thread): start
            # them at once, off this loop, which goes on answering status
            # and long polls.
            results = await asyncio.gather(
                *[asyncio.to_thread(self._start_replica, state)
                  for _ in range(deficit)], return_exceptions=True)
            for err in results:
                if isinstance(err, BaseException):
                    import traceback

                    traceback.print_exception(err)

        # 3. Rolling replace: once a current-version replica is up, drain
        # outdated ones.
        surplus = (len(current) + len(outdated)) - state.target_replicas
        if outdated and len(current) >= 1 and surplus > 0:
            await self._stop_replica(state, outdated[0])

        # 4. Scale down extras of the current version.
        elif len(current) > state.target_replicas:
            victim = min(current, key=lambda r: r.ongoing)
            await self._stop_replica(state, victim)

        # 5. Promote replicas that finished starting; drop ones whose
        # actor died during __init__ (or never came up) so the deficit
        # recomputes and a replacement starts — otherwise a ghost
        # STARTING entry wedges the deployment at 0 RUNNING forever.
        from ray_tpu_torch.exceptions import RayActorError

        for r in starting:
            try:
                await _aget(r.handle.check_health.remote(), timeout=0.5)
            except RayActorError:
                state.replicas.remove(r)
                continue
            except Exception:
                if time.monotonic() - r.last_seen > 120.0:
                    state.replicas.remove(r)
                    try:
                        _kill(r.handle)
                    except Exception:
                        pass
                continue
            r.state = "RUNNING"
            r.last_seen = time.monotonic()
            state.route_version += 1

    def _start_replica(self, state: _DeploymentState) -> None:
        from ray_tpu_torch.core.remote_function import remote
        from ray_tpu_torch.serve._private.replica import Replica

        replica_id = f"{state.name}#{uuid.uuid4().hex[:6]}"
        opts = dict(state.config.ray_actor_options)
        opts.setdefault("num_cpus", 0)
        opts.setdefault("max_concurrency",
                        state.config.max_ongoing_requests)
        # Named, as the reference's replicas are (a restarted controller
        # re-adopts them by name there).
        opts.setdefault("name", f"SERVE_REPLICA::{replica_id}")
        opts.setdefault("lifetime", "detached")
        actor_cls = remote(**opts)(Replica)
        handle = actor_cls.remote(
            state.cls_factory, state.init_args, state.init_kwargs,
            state.name, replica_id, state.config.version)
        if self._shutdown or self._deployments.get(state.name) is not state:
            # Deleted while this replica was being built off the loop.
            _kill(handle)
            return
        state.replicas.append(_ReplicaState(
            handle=handle, replica_id=replica_id,
            version=state.config.version))

    async def _stop_replica(self, state: _DeploymentState,
                            replica: _ReplicaState) -> None:
        if replica in state.replicas:
            replica.state = "STOPPING"
            state.replicas.remove(replica)
            state.route_version += 1
        try:
            await _aget(
                replica.handle.prepare_for_shutdown.remote(
                    state.config.graceful_shutdown_timeout_s),
                timeout=state.config.graceful_shutdown_timeout_s + 5)
        except Exception:
            pass
        try:
            _kill(replica.handle)
        except Exception:
            pass

    # -- autoscaling ----------------------------------------------------
    async def _collect_metric_snapshots(self) -> list:
        """Every process's app-metric snapshot: the local registry (all
        of it in the in-process runtime, where proxies, routers and
        replicas share this process) plus, on the cluster runtime, the
        GCS's latest fold of the pushed metrics pipeline, or each
        raylet's `get_metrics` where the fold is empty, unavailable or
        off."""
        from ray_tpu_torch.core import metrics_ts
        from ray_tpu_torch.core.config import ray_config
        from ray_tpu_torch.util.metrics import default_registry

        snaps = list(default_registry().snapshot())
        rt = self._durable_runtime()
        if rt is None:
            return snaps
        if metrics_ts.enabled and ray_config().metrics_pipeline:
            try:
                fold = await _on_loop(rt, rt._gcs.latest_metrics())
                if fold:
                    snaps.extend(fold)
                    return snaps
            except Exception:
                pass  # fold unavailable — fall through to the poll
        try:
            for n in await _on_loop(rt, rt._gcs.get_nodes()):
                if not n.get("alive"):
                    continue
                try:
                    snaps.extend(await _on_loop(
                        rt, _raylet_metrics(rt, n["address"])))
                except Exception:
                    continue
        except Exception:
            pass
        return snaps

    async def _autoscale(self, state: _DeploymentState) -> None:
        """Queue-length autoscaling driven by the data plane's OWN
        gauges — `serve_replica_ongoing_requests` (per live replica) +
        `serve_deployment_queued_queries` (per router process backlog) —
        instead of an extra metrics.remote() poll per replica per tick
        (the PR-2 follow-up in ROADMAP). The gauges lag by the metrics
        push interval; upscale/downscale delays already absorb that. If
        no gauge has been pushed yet for any live replica (fresh
        deployment), fall back to one polling round."""
        cfg = state.config.autoscaling_config
        if cfg is None:
            return
        running = [r for r in state.replicas if r.state == "RUNNING"]
        if not running:
            return
        try:
            snaps = await self._collect_metric_snapshots()
        except Exception:
            snaps = []
        per_replica, queued = _deployment_load_from_samples(
            snaps, state.name, [r.replica_id for r in running])
        if per_replica:
            total = queued
            for r in running:
                if r.replica_id in per_replica:
                    r.ongoing = int(per_replica[r.replica_id])
                total += per_replica.get(r.replica_id, 0)
        else:
            total = 0
            for r in running:
                try:
                    m = await _aget(r.handle.metrics.remote(), timeout=2.0)
                    r.ongoing = m["ongoing"]
                    total += m["ongoing"]
                except Exception:
                    pass
        desired = math.ceil(total / max(cfg.target_ongoing_requests, 1e-9))
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        now = time.monotonic()
        if desired > state.target_replicas:
            state._scale_low_since = None
            if state._scale_high_since is None:
                state._scale_high_since = now
            if now - state._scale_high_since >= cfg.upscale_delay_s:
                state.target_replicas = desired
                state._scale_high_since = None
        elif desired < state.target_replicas:
            state._scale_high_since = None
            if state._scale_low_since is None:
                state._scale_low_since = now
            if now - state._scale_low_since >= cfg.downscale_delay_s:
                state.target_replicas = desired
                state._scale_low_since = None
        else:
            state._scale_high_since = None
            state._scale_low_since = None


def _deployment_load_from_samples(snapshots: list, deployment: str,
                                  live_replica_ids: list):
    """Fold metric snapshots into autoscaling inputs for one deployment.

    Returns `(per_replica_ongoing, queued_total)`:
    - `per_replica_ongoing`: replica_id -> latest
      `serve_replica_ongoing_requests` gauge value, restricted to the
      LIVE replica set (dead replicas' gauges linger in raylet snapshots
      until worker eviction and must not count);
    - `queued_total`: sum of `serve_deployment_queued_queries` across
      router processes (each process aggregates its own backlog, so the
      cluster total is the sum over sources).
    """
    live = set(live_replica_ids)
    per_replica: Dict[str, float] = {}
    queued = 0.0
    for m in snapshots:
        if m.get("name") == "serve_replica_ongoing_requests":
            for s in m.get("samples", []):
                tags = s.get("tags", {})
                rid = tags.get("replica")
                if tags.get("deployment") == deployment and rid in live:
                    per_replica[rid] = s.get("value", 0.0)
        elif m.get("name") == "serve_deployment_queued_queries":
            for s in m.get("samples", []):
                if s.get("tags", {}).get("deployment") == deployment:
                    queued += s.get("value", 0.0)
    return per_replica, queued


async def _on_loop(rt, coro):
    """Run a coroutine of the runtime's RPC clients on the runtime's own
    loop (the controller's methods run on the actor's loop)."""
    return await asyncio.to_thread(rt._loop.run, coro, 10.0)


async def _raylet_metrics(rt, address: str) -> list:
    client = await rt._raylet_client(address)
    return await client.call("get_metrics", timeout=5.0)


async def _aget(ref, timeout: Optional[float] = None):
    """Await an ObjectRef from inside the controller's event loop without
    blocking it (`get` is thread-blocking)."""
    return await asyncio.to_thread(ref._runtime.get, ref, timeout=timeout)


def _kill(handle) -> None:
    handle._actor_runtime().kill_actor(handle)


class _Unversionable(Exception):
    pass


class _VersionPickler(_Pickler):
    """Refuses a tensor on a device: a version must never copy one."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.device.type != "cpu"):
            raise _Unversionable
        return super().reducer_override(obj)


def _digest_code(code: types.CodeType, h) -> None:
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _digest_code(const, h)
        else:
            h.update(repr(const).encode())


def _digest_object(obj, h, seen: set) -> None:
    """Module, qualname and each function's bytecode and constants,
    recursively through classes, their bases and their methods."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        for fn in (obj.fget, obj.fset, obj.fdel):
            if fn is not None:
                _digest_object(fn, h, seen)
        return
    if isinstance(obj, type):
        h.update(f"{obj.__module__}.{obj.__qualname__}".encode())
        for base in obj.__bases__:
            if base is not object:
                _digest_object(base, h, seen)
        for name, member in sorted(vars(obj).items()):
            if isinstance(member, (type, staticmethod, classmethod,
                                   property)) or inspect.isfunction(member):
                h.update(name.encode())
                _digest_object(member, h, seen)
        return
    if inspect.isfunction(obj):
        h.update(f"{obj.__module__}.{obj.__qualname__}".encode())
        _digest_code(obj.__code__, h)
        return
    _digest_object(type(obj), h, seen)   # a callable instance


def _auto_version(cls_factory, init_args, init_kwargs) -> Optional[str]:
    """12 hex digits of a digest of the code and a pickle of the init
    args, or None where the args do not pickle (or hold a tensor on a
    device)."""
    import io

    h = hashlib.sha1()
    _digest_object(cls_factory, h, set())
    buf = io.BytesIO()
    try:
        _VersionPickler(buf, protocol=5).dump(
            (tuple(init_args), dict(init_kwargs)))
    except Exception:
        return None
    h.update(buf.getvalue())
    return h.hexdigest()[:12]
