"""Request router: power-of-two-choices replica selection.

Reference equivalent: `python/ray/serve/_private/router.py:290`
(PowerOfTwoChoicesReplicaScheduler): keep a cached replica set (refreshed
from the controller on a version counter), sample two candidates, route to
the one with the lower queue, retry through drains/deaths. Ported from
`ray_tpu/serve/_private/router.py`; every call goes through the runtime
of the controller's handle, and the long-poll thread ends when that
runtime shuts down or, in the in-process runtime (which never restarts
an actor), when the controller dies; on the cluster runtime it polls on
through the controller's restart.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class Router:
    def __init__(self, controller_handle, deployment_name: str,
                 refresh_interval_s: float = 1.0):
        self._controller = controller_handle
        self.deployment_name = deployment_name
        self._refresh_interval_s = refresh_interval_s
        self._replicas: List[Tuple[str, Any]] = []
        self._version = -2
        self._last_refresh = 0.0
        self._inflight: Dict[str, int] = {}
        # model_id -> replica_id affinity (multiplexed routing: keep a
        # model's requests on the replica that already loaded it;
        # reference: the multiplexed scheduling of replica_scheduler.py).
        self._model_affinity: Dict[str, str] = {}
        # session_id -> replica_id affinity (sticky sessions: keep a
        # conversation on the replica whose KV cache already holds its
        # history — the serve-layer half of fleet KV-aware routing).
        self._session_affinity: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._poller: Optional[threading.Thread] = None

    def _apply(self, table: Dict[str, Any]) -> None:
        with self._lock:
            self._last_refresh = time.monotonic()
            if table["version"] != self._version:
                self._version = table["version"]
                self._replicas = list(table["replicas"])
                self._inflight = {rid: self._inflight.get(rid, 0)
                                  for rid, _ in self._replicas}

    def _runtime(self):
        return self._controller._actor_runtime()

    def _refresh(self, force: bool = False) -> None:
        self._ensure_poller()
        now = time.monotonic()
        if not force and now - self._last_refresh \
                < self._refresh_interval_s:
            return
        try:
            table = self._runtime().get(
                self._controller.get_routing_table.remote(
                    self.deployment_name), timeout=30)
        except Exception:
            # Controller unreachable: KEEP routing to the cached replica
            # set (the long-poll client serves stale snapshots until the
            # host answers again).
            self._last_refresh = now
            return
        self._apply(table)

    def _ensure_poller(self) -> None:
        if self._poller is not None and self._poller.is_alive():
            return
        if self._runtime().shutdown_event.is_set():
            return
        self._poller = threading.Thread(target=self._poll_loop,
                                        daemon=True,
                                        name=f"router-{self.deployment_name}")
        self._poller.start()

    def _poll_loop(self) -> None:
        """Long-poll push channel (reference: long_poll.py:174): blocks
        on the controller until the routing version moves, then applies
        the new table — updates land in ~one RTT instead of one refresh
        interval. Ends when the deployment is deleted, the controller
        dies, or the runtime shuts down."""
        from ray_tpu_torch.exceptions import RayActorError

        rt = self._runtime()
        while not rt.shutdown_event.is_set():
            try:
                out = rt.get(
                    self._controller.listen_for_change.remote(
                        {self.deployment_name: self._version},
                        timeout_s=10.0),
                    timeout=20)
                table = (out or {}).get(self.deployment_name)
                if table:
                    self._apply(table)
                    if table.get("deleted"):
                        # Deployment gone: stop holding a controller
                        # slot. A redeploy restarts the poller through
                        # _refresh -> _ensure_poller.
                        return
            except RayActorError:
                if getattr(rt, "is_local_mode", False):
                    return       # the controller is gone for good
                # On the cluster a killed controller restarts from its
                # checkpoint: poll again.
                rt.shutdown_event.wait(1.0)
            except Exception:
                rt.shutdown_event.wait(1.0)

    def _choose(self, model_id: Optional[str] = None,
                session_id: Optional[str] = None) -> Tuple[str, Any]:
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            raise _NoReplicas()
        if session_id:
            # Sticky sessions outrank model affinity: a conversation's
            # KV blocks live on exactly one replica, so moving it costs
            # a full re-prefill — worth more than a warm model slot.
            # Same overload escape as model affinity (2x + 4 slack).
            with self._lock:
                pinned = self._session_affinity.get(session_id)
            match = next((r for r in replicas if r[0] == pinned), None)
            if match is not None:
                others = [r for r in replicas if r[0] != pinned]
                if not others:
                    return match
                alt = random.choice(others)
                with self._lock:
                    lp = self._inflight.get(match[0], 0)
                    la = self._inflight.get(alt[0], 0)
                if lp <= 2 * la + 4:
                    return match
        if model_id:
            # Affinity first: the replica that last served this model has
            # it warm in its multiplex LRU — unless it's clearly
            # overloaded vs the p2c alternative (2x + 4 queue slack).
            with self._lock:
                pinned = self._model_affinity.get(model_id)
            match = next((r for r in replicas if r[0] == pinned), None)
            if match is not None:
                others = [r for r in replicas if r[0] != pinned]
                if not others:
                    return match
                alt = random.choice(others)
                with self._lock:
                    lp = self._inflight.get(match[0], 0)
                    la = self._inflight.get(alt[0], 0)
                if lp <= 2 * la + 4:
                    return match
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        with self._lock:
            la = self._inflight.get(a[0], 0)
            lb = self._inflight.get(b[0], 0)
        return a if la <= lb else b

    def assign(self, method_name: str, args: tuple, kwargs: dict,
               timeout_s: float = 30.0,
               model_id: Optional[str] = None,
               session_id: Optional[str] = None,
               streaming: bool = False):
        """Pick a replica and submit; returns (replica_id, ObjectRef).
        Blocks (with backoff) while the deployment has no running
        replica — e.g. mid-startup.

        Observability: the assignment runs inside a `serve.router` span
        (child of the ingress's ambient span), and the span's traceparent
        rides the request metadata so the replica's span — on the
        replica's own loop or thread — parents to it: one trace id covers
        proxy -> router -> replica."""
        from ray_tpu_torch.util.tracing import current_traceparent, span

        deadline = time.monotonic() + timeout_s
        self._refresh()
        with span("serve.router",
                  attributes={"deployment": self.deployment_name,
                              "component": "router"}):
            # Queued = requests INSIDE assign that have no replica yet —
            # the signal that matters during overload/startup (an
            # autoscaler reading this must see the backlog, not the
            # already-executing requests, which the replicas' ongoing
            # gauge covers). Counted process-wide: several Routers can
            # serve one deployment (one per handle).
            from ray_tpu_torch.serve._private.metrics import queued_delta

            queued_delta(self.deployment_name, +1)
            try:
                while True:
                    try:
                        replica_id, handle = self._choose(model_id,
                                                          session_id)
                        break
                    except _NoReplicas:
                        if time.monotonic() > deadline:
                            from ray_tpu_torch.serve.exceptions import (
                                DeploymentUnavailableError)

                            raise DeploymentUnavailableError(
                                f"no running replicas for "
                                f"{self.deployment_name!r} after "
                                f"{timeout_s}s")
                        time.sleep(0.05)
                        self._refresh(force=True)
            finally:
                queued_delta(self.deployment_name, -1)
            with self._lock:
                self._inflight[replica_id] = \
                    self._inflight.get(replica_id, 0) + 1
                if model_id:
                    self._model_affinity[model_id] = replica_id
                if session_id:
                    self._session_affinity[session_id] = replica_id
            try:
                from ray_tpu_torch.serve._private.metrics import router_metrics

                router_metrics()["assignments"].inc(
                    1, tags={"deployment": self.deployment_name})
            except Exception:
                pass  # metrics must never fail the data path
            metadata: Optional[dict] = None
            if model_id:
                metadata = {"multiplexed_model_id": model_id}
            if session_id:
                metadata = dict(metadata or {})
                metadata["session_id"] = session_id
            traceparent = current_traceparent()
            if traceparent:
                metadata = dict(metadata or {})
                metadata["traceparent"] = traceparent
            if streaming:
                # Streaming actor task: the replica's sync-generator
                # entrypoint yields one ObjectRef per item to the
                # returned ObjectRefGenerator while it runs.
                method = handle.handle_request_streaming.options(
                    num_returns="streaming")
                if metadata is not None:
                    ref = method.remote(method_name, args, kwargs,
                                        metadata)
                else:
                    ref = method.remote(method_name, args, kwargs)
            elif metadata is not None:
                ref = handle.handle_request.remote(method_name, args,
                                                   kwargs, metadata)
            else:
                ref = handle.handle_request.remote(method_name, args,
                                                   kwargs)
        return replica_id, ref

    def inflight_snapshot(self) -> Dict[str, int]:
        """Per-replica in-flight counts (dashboard /api/serve)."""
        with self._lock:
            return dict(self._inflight)

    def complete(self, replica_id: str) -> None:
        with self._lock:
            if replica_id in self._inflight:
                self._inflight[replica_id] = max(
                    0, self._inflight[replica_id] - 1)

    def invalidate(self) -> None:
        """Force the next assign to re-pull the routing table (a replica
        died or drained under us)."""
        self._last_refresh = 0.0
        self._version = -2


class _NoReplicas(Exception):
    pass
