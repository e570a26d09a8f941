"""GCS client: typed accessors over the RPC client.

Reference equivalent: `src/ray/gcs/gcs_client/accessor.h` (Node/Actor/Job/
InternalKV accessors) + `python/ray/_raylet.pyx:2473 GcsClient`.

The port's copy of `ray_tpu/core/gcs/client.py`. No reply redirects: the
port's GCS is one server.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.rpc import ConnectionLost, RpcClient, RpcError

logger = logging.getLogger(__name__)


def backoff_delay(attempt: int, rng=None, *,
                  base_s: Optional[float] = None,
                  cap_s: Optional[float] = None) -> float:
    """Capped exponential backoff with FULL jitter (AWS-style:
    sleep = uniform(0, min(cap, base * 2^attempt))).

    One definition shared by every control-plane retry loop — the real
    `_ReconnectingRpc._reconnect` below and `core/simcluster.py`'s
    simulated clients — so the de-synchronization property the scale
    harness measures is the property production runs. A fixed sleep here
    (the pre-round-14 0.5 s) synchronizes 100 reconnecting clients into
    a thundering herd against a just-restarted GCS."""
    import random

    from ray_tpu_torch.core.config import ray_config

    cfg = ray_config()
    base = (cfg.gcs_reconnect_backoff_base_ms / 1000.0
            if base_s is None else base_s)
    cap = (cfg.gcs_reconnect_backoff_max_ms / 1000.0
           if cap_s is None else cap_s)
    ceiling = min(cap, base * (2 ** min(attempt, 32)))
    return (rng or random).uniform(0.0, ceiling)


class _ReconnectingRpc:
    """RpcClient facade that survives a GCS restart (reference: GCS
    fault tolerance — workers/raylets reconnect against the restarted
    server, `gcs_client` retry machinery + `redis_store_client.h`
    persistence on the server side).

    On ConnectionLost: reconnect within the `gcs_rpc_timeout_s` window,
    re-attach push handlers, re-issue channel subscriptions, then retry
    the call once. GCS table ops are keyed/overwriting (idempotent), so
    a single retry is safe.

    HA (round 18): `address` may be a comma-separated replica set. The
    target is RE-RESOLVED on every reconnect attempt (never bound at
    construction — a moved or failed-over GCS used to be unreachable
    forever), rotating the set and preferring the leader hint carried by
    `NotLeaderError` redirects, so a raylet/driver rides its ordinary
    jittered-backoff path onto whichever replica wins the election."""

    def __init__(self, address: str):
        self.addresses = [a.strip() for a in address.split(",")
                          if a.strip()]
        # The configured replica set is the durable core of the rotation
        # set; leader hints learned from redirects are kept separately
        # and BOUNDED, so stale hints from old incarnations can't grow
        # the set (or keep dead addresses in rotation) forever.
        self._seed_addresses = list(self.addresses)
        self._hint_addresses: List[str] = []
        self._rr = 0  # rotation cursor, persistent across reconnects
        self.address = self.addresses[0]  # current target
        self._leader_hint: Optional[str] = None
        self._client = RpcClient(self.address)
        self._push_handlers: Dict[str, Callable] = {}
        self._subscribed: set = set()
        self._reconnect_lock: Optional[asyncio.Lock] = None
        self._closed = False
        self._cluster_id: Optional[str] = None

    @property
    def connected(self) -> bool:
        return self._client.connected

    async def connect(self, timeout: float = 10.0) -> None:
        self._reconnect_lock = asyncio.Lock()
        loop = asyncio.get_running_loop()
        # Split the caller's budget across the replica set: one dead
        # replica eating the FULL timeout would starve the live ones and
        # turn worst-case initial connect into N*timeout.
        deadline = loop.time() + timeout
        share = max(0.5, timeout / max(1, len(self.addresses)))
        last_err: Optional[Exception] = None
        connected = False
        for addr in self.addresses:
            budget = min(share, deadline - loop.time())
            if budget <= 0:
                break
            client = RpcClient(addr)
            try:
                await client.connect(timeout=budget)
                self.address = addr
                self._client = client
                connected = True
                break
            except Exception as e:  # noqa: BLE001
                last_err = e
                try:
                    await client.close()
                except Exception:
                    pass
        if not connected:
            raise last_err if last_err is not None else ConnectionLost(
                f"GCS at {','.join(self.addresses)} unreachable")
        try:
            self._cluster_id = await self._client.call("cluster_id",
                                                       timeout=10.0)
        except Exception:
            self._cluster_id = None

    async def close(self) -> None:
        self._closed = True
        await self._client.close()

    def on_push(self, channel: str, handler: Callable) -> None:
        self._push_handlers[channel] = handler
        self._client.on_push(channel, handler)

    def mark_subscribed(self, channel: str) -> None:
        self._subscribed.add(channel)

    async def call(self, method: str, **kwargs: Any) -> Any:
        try:
            return await self._client.call(method, **kwargs)
        except ConnectionLost:
            if self._closed:
                raise
            await self._reconnect()
            return await self._redirect_aware_call(method, kwargs)
        except RpcError as e:
            if self._closed or not self._note_redirect(e):
                raise
            if not self._leader_hint:
                # No hint to follow: rotate off this replica NOW (it may
                # be minority-partitioned yet still accepting calls) so
                # the retry loop starts against a different one.
                try:
                    await self._client.close()
                except Exception:
                    pass
                await self._reconnect()
            return await self._redirect_aware_call(method, kwargs)

    def _note_redirect(self, err: Exception) -> bool:
        """Record the leader hint from a NOT_LEADER error string (the
        follower's NotLeaderError crosses the wire as a plain handler
        error). True if this was a redirect. A QuorumLostError is
        retryable the same way: the replica we reached cannot commit
        right now (minority side of a partition) — rotate and let
        whoever leads next serve the retry."""
        # The port's GCS is one server (its HA replica set waits for a
        # later slice), so no reply redirects.
        return False

    async def _redirect_aware_call(self, method: str,
                                   kwargs: Dict[str, Any]) -> Any:
        """Retry loop after a reconnect or redirect: follow NOT_LEADER
        hints (switching replicas) within the gcs_rpc_timeout_s window.
        A vacant leadership (election in progress) shows up as repeated
        redirects-with-no-hint and is ridden out on the same jittered
        backoff the reconnect path uses."""
        from ray_tpu_torch.core.config import ray_config

        loop = asyncio.get_running_loop()
        deadline = loop.time() + ray_config().gcs_rpc_timeout_s
        attempt = 0
        while True:
            if self._leader_hint and self._leader_hint != self.address:
                # A redirect told us who leads: drop the current replica
                # and let _reconnect dial the hint.
                try:
                    await self._client.close()
                except Exception:
                    pass
                await self._reconnect()
            try:
                return await self._client.call(method, **kwargs)
            except ConnectionLost:
                if self._closed or loop.time() >= deadline:
                    raise
                await self._reconnect()
            except RpcError as e:
                if (self._closed or not self._note_redirect(e)
                        or loop.time() >= deadline):
                    raise
                if not self._leader_hint:
                    # Hint-less redirect (election running) or
                    # QuorumLostError (minority-side replica): re-calling
                    # the SAME replica would spin on it until the window
                    # expires even when a majority-side leader is
                    # reachable. Rotate off it through _reconnect after
                    # the jittered backoff.
                    await asyncio.sleep(backoff_delay(attempt))
                    try:
                        await self._client.close()
                    except Exception:
                        pass
                    await self._reconnect()
            attempt += 1

    def _note_hint_address(self, addr: str) -> None:
        """Admit a redirect hint into the rotation set without letting
        stale hints accumulate: the set is the configured seed replicas
        plus at most a replica-set's worth of the newest hints."""
        if addr in self._seed_addresses:
            return
        if addr in self._hint_addresses:
            self._hint_addresses.remove(addr)
        self._hint_addresses.append(addr)
        keep = max(1, len(self._seed_addresses))
        del self._hint_addresses[:-keep]
        self.addresses = self._seed_addresses + self._hint_addresses

    def _resolve_target(self, attempt: int) -> str:
        """Pick the address for THIS reconnect attempt. Re-resolving
        per attempt (instead of binding at construction) is what lets a
        client follow a GCS that moved or failed over: prefer the last
        NOT_LEADER hint, otherwise rotate the replica set — skipping the
        address we just gave up on, so a deliberate rotation (hint-less
        redirect off a minority replica) never re-dials it first."""
        if self._leader_hint:
            hint, self._leader_hint = self._leader_hint, None
            self._note_hint_address(hint)
            return hint
        n = len(self.addresses)
        addr = self.addresses[self._rr % n]
        self._rr += 1
        if addr == self.address and n > 1:
            addr = self.addresses[self._rr % n]
            self._rr += 1
        return addr

    async def _reconnect(self) -> None:
        from ray_tpu_torch.core import flight
        from ray_tpu_torch.core.config import ray_config

        async with self._reconnect_lock:
            if self._client.connected:
                return  # another caller already reconnected
            loop = asyncio.get_running_loop()
            window = ray_config().gcs_rpc_timeout_s
            deadline = loop.time() + window
            last_err: Optional[Exception] = None
            attempt = 0
            while loop.time() < deadline:
                target = self._resolve_target(attempt)
                fresh = RpcClient(target)
                try:
                    if flight.enabled:
                        flight.instant("gcs", "gcs.retry", arg=attempt)
                    # Short per-dial budget: RpcClient.connect retries a
                    # refused/dead address internally until its timeout,
                    # so a generous budget here turns every dead replica
                    # in the rotation into a multi-second sink (a 3-of-4
                    # set with one dead node would burn most of the
                    # reconnect window on it). THIS loop is the retry
                    # mechanism — move on to the next replica quickly.
                    await fresh.connect(
                        timeout=min(1.0, max(0.25,
                                             deadline - loop.time())))
                    if self._cluster_id:
                        # Ephemeral-port reuse: whoever answers on the
                        # cached address must be OUR cluster, not a new
                        # one that grabbed the freed port.
                        cid = await fresh.call("cluster_id", timeout=5.0)
                        if cid != self._cluster_id:
                            raise ConnectionLost(
                                f"{target} now serves a different "
                                f"cluster ({cid[:8]}…)")
                    for ch, h in self._push_handlers.items():
                        fresh.on_push(ch, h)
                    old, self._client = self._client, fresh
                    self.address = target
                    try:
                        await old.close()
                    except Exception:
                        pass
                    for ch in self._subscribed:
                        await fresh.call("subscribe", channel=ch)
                    logger.info("reconnected to GCS at %s (attempt %d)",
                                target, attempt)
                    if flight.enabled:
                        flight.instant("gcs", "gcs.reconnect", arg=attempt)
                    return
                except Exception as e:  # noqa: BLE001
                    last_err = e
                    try:
                        await fresh.close()
                    except Exception:
                        pass
                    # Capped exponential backoff with full jitter: a herd
                    # of clients that lost the GCS together must not
                    # retry in lockstep (satellite of ISSUE 14; fixed
                    # 0.5 s before).
                    await asyncio.sleep(backoff_delay(attempt))
                    attempt += 1
            raise ConnectionLost(
                f"GCS at {','.join(self.addresses)} unreachable for "
                f"{window}s ({attempt} attempts): {last_err}")


class GcsClient:
    def __init__(self, address: str, rpc: Optional[Any] = None):
        # `address` may be a comma-separated HA replica set; the
        # reconnecting facade rotates it and follows NOT_LEADER
        # redirects. `rpc` is injectable so core/simcluster.py can bind
        # the SAME typed accessors to an in-process loopback channel:
        # the sim's raylets speak to the real GcsServer through the real
        # client code, minus the TCP socket.
        self.rpc = rpc if rpc is not None else _ReconnectingRpc(address)

    async def connect(self, timeout: float = 10.0) -> None:
        await self.rpc.connect(timeout=timeout)

    async def close(self) -> None:
        await self.rpc.close()

    # -- pubsub ---------------------------------------------------------
    async def subscribe(self, channel: str,
                        handler: Callable[[Any], Any]) -> None:
        # Deliveries arrive as typed PubsubMessage envelopes
        # (core/wire.py); unwrap HERE so channel handlers receive the
        # plain payload. A malformed delivery raises WireDecodeError
        # into the push dispatcher's log instead of corrupting handlers.
        # The per-channel seq detects dropped deliveries (a seq that
        # moves backwards is a GCS restart: counters reset, not a drop).
        last_seq = [0]

        def unwrap(payload):
            if isinstance(payload, dict) and payload.get(
                    "_t") == "PubsubMessage":
                from ray_tpu_torch.core.wire import from_wire

                msg = from_wire(payload, expect="PubsubMessage")
                if msg.seq is not None:
                    if last_seq[0] and msg.seq > last_seq[0] + 1:
                        logger.warning(
                            "pubsub channel %r: %d deliveries lost "
                            "(seq %d -> %d)", channel,
                            msg.seq - last_seq[0] - 1, last_seq[0],
                            msg.seq)
                    last_seq[0] = msg.seq
                payload = msg.data
            return handler(payload)

        self.rpc.on_push(channel, unwrap)
        await self.rpc.call("subscribe", channel=channel)
        self.rpc.mark_subscribed(channel)

    async def publish(self, channel: str, data: Any) -> None:
        await self.rpc.call("publish", channel=channel, data=data)

    # -- nodes ----------------------------------------------------------
    async def register_node(self, **kwargs: Any) -> Dict[str, Any]:
        from ray_tpu_torch.core.wire import NodeInfo, to_wire

        return await self.rpc.call("register_node",
                                   node=to_wire(NodeInfo(**kwargs)))

    async def heartbeat(self, node_id: str,
                        resources_available: Dict[str, float],
                        load: Optional[dict] = None,
                        metrics: Optional[List[dict]] = None,
                        workers: Optional[List[dict]] = None) -> bool:
        """False = the GCS does not recognize this node (it restarted or
        declared the node dead): the caller must re-register.

        `metrics` is the node's coalesced metrics-pipeline batch (round
        17) and `workers` the node's batched per-worker state (round 18):
        piggybacking both here keeps the fleet at one push RPC per node
        per interval regardless of worker count, and keeps worker churn
        off the quorum-replicated write path (it lands as GCS soft
        state)."""
        return await self.rpc.call(
            "heartbeat", node_id=node_id,
            resources_available=resources_available, load=load,
            metrics=metrics, workers=workers, timeout=5.0)

    async def get_nodes(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("get_nodes")

    async def drain_node(self, node_id: str) -> None:
        await self.rpc.call("drain_node", node_id=node_id)

    # -- actors ---------------------------------------------------------
    async def register_actor(self, actor_id: str,
                             info: Dict[str, Any]) -> Dict[str, Any]:
        # Typed wire envelope (core/wire.py ActorInfo): registration is
        # the durable record — validate it at the schema boundary.
        from ray_tpu_torch.core.wire import ActorInfo, to_wire

        if isinstance(info, dict):
            info = ActorInfo(actor_id=actor_id,
                             state=info.get("state", "PENDING"),
                             **{k: v for k, v in info.items()
                                if k != "state"})
        return await self.rpc.call("register_actor", actor_id=actor_id,
                                   info=to_wire(info))

    async def update_actor(self, actor_id: str,
                           updates: Dict[str, Any]) -> bool:
        return await self.rpc.call("update_actor", actor_id=actor_id,
                                   updates=updates)

    async def get_actor(self, actor_id: Optional[str] = None,
                        name: Optional[str] = None,
                        namespace: str = "default"
                        ) -> Optional[Dict[str, Any]]:
        return await self.rpc.call("get_actor", actor_id=actor_id, name=name,
                                   namespace=namespace)

    async def list_actors(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("list_actors")

    # -- jobs -----------------------------------------------------------
    async def add_job(self, job_id: str, info: Dict[str, Any]) -> None:
        from ray_tpu_torch.core.wire import JobInfo, to_wire

        if isinstance(info, dict):
            info = JobInfo(job_id=job_id, **info)
        await self.rpc.call("add_job", job_id=job_id, info=to_wire(info))

    async def get_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        return await self.rpc.call("get_job", job_id=job_id)

    async def mark_job_finished(self, job_id: str) -> None:
        await self.rpc.call("mark_job_finished", job_id=job_id)

    async def list_jobs(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("list_jobs")

    # -- task events ------------------------------------------------------
    async def add_task_events(self, events: List[Dict[str, Any]]) -> bool:
        return await self.rpc.call("add_task_events", events=events)

    async def get_task_events(self, job_id: Optional[str] = None
                              ) -> List[Dict[str, Any]]:
        return await self.rpc.call("get_task_events", job_id=job_id)

    # -- kv -------------------------------------------------------------
    async def kv_put(self, key: str, value: bytes,
                     overwrite: bool = True) -> bool:
        return await self.rpc.call("kv_put", key=key, value=value,
                                   overwrite=overwrite)

    async def kv_get(self, key: str) -> Optional[bytes]:
        return await self.rpc.call("kv_get", key=key)

    async def kv_del(self, key: str) -> bool:
        return await self.rpc.call("kv_del", key=key)

    async def kv_keys(self, prefix: str) -> List[str]:
        return await self.rpc.call("kv_keys", prefix=prefix)

    async def kv_exists(self, key: str) -> bool:
        return await self.rpc.call("kv_exists", key=key)

    # -- placement groups ------------------------------------------------
    async def register_placement_group(self, pg_id: str,
                                       info: Dict[str, Any]) -> bool:
        return await self.rpc.call("register_placement_group", pg_id=pg_id,
                                   info=info)

    async def update_placement_group(self, pg_id: str,
                                     updates: Dict[str, Any],
                                     expect_state: Optional[str] = None
                                     ) -> bool:
        return await self.rpc.call("update_placement_group", pg_id=pg_id,
                                   updates=updates,
                                   expect_state=expect_state)

    async def get_placement_group(self, pg_id: str
                                  ) -> Optional[Dict[str, Any]]:
        return await self.rpc.call("get_placement_group", pg_id=pg_id)

    async def list_placement_groups(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("list_placement_groups")

    # -- metrics pipeline + SLOs (round 17) -----------------------------
    async def query_metrics(self, series: str, window_s: float = 60.0,
                            agg: str = "raw",
                            labels: Optional[Dict[str, str]] = None,
                            group_by: Optional[List[str]] = None
                            ) -> Dict[str, Any]:
        return await self.rpc.call(
            "query_metrics", series=series, window_s=window_s, agg=agg,
            labels=labels, group_by=group_by, timeout=10.0)

    async def latest_metrics(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("latest_metrics", timeout=10.0)

    async def metrics_stats(self) -> Dict[str, Any]:
        return await self.rpc.call("metrics_stats", timeout=5.0)

    async def register_slo(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        return await self.rpc.call("register_slo", spec=spec, timeout=10.0)

    async def remove_slo(self, name: str) -> bool:
        return await self.rpc.call("remove_slo", name=name, timeout=10.0)

    async def get_slo(self) -> List[Dict[str, Any]]:
        return await self.rpc.call("get_slo", timeout=10.0)

    async def dump_flight_record(self, window_s: Optional[float] = None,
                                 include_events: bool = True
                                 ) -> Dict[str, Any]:
        return await self.rpc.call(
            "dump_flight_record", window_s=window_s,
            include_events=include_events, timeout=10.0)

    # -- misc -----------------------------------------------------------
    async def ping(self) -> str:
        return await self.rpc.call("ping", timeout=5.0)

    async def cluster_info(self) -> Dict[str, Any]:
        return await self.rpc.call("cluster_info")
