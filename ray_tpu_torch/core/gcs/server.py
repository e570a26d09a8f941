"""GCS — the cluster-global control plane.

Reference equivalent: `src/ray/gcs/gcs_server/` (GcsNodeManager,
GcsActorManager tables, GcsKvManager, InternalPubSub, GcsHealthCheckManager,
GcsJobManager — `gcs_server.cc:189-237` init sequence). Design deviation:
actor *placement* is owner-led (the creating worker leases the actor worker
itself, like a task); the GCS stores the actor table, watches liveness, and
publishes updates. GCS-led scheduling of detached actors is layered on top
via the same table.

State is held in a pluggable store (in-memory now, matching the reference's
`InMemoryStoreClient`; a persistent backend can be swapped in for GCS
fault tolerance like `RedisStoreClient`).

The port's copy of `ray_tpu/core/gcs/server.py`. One GCS with its WAL
and the placement-group table: the HA replica set (`replication.py`)
waits for a later slice, and `--replica-id` raises.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch.core.config import ray_config
from ray_tpu_torch.core.rpc import RpcServer, ServerConnection

logger = logging.getLogger(__name__)


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 storage_path: Optional[str] = None):
        self._rpc = RpcServer(self, host, port)
        # Durable table storage (reference: gcs redis_store_client /
        # observable_store_client): load at boot, snapshot when dirty.
        self._storage_path = storage_path
        self._dirty = False
        self._dirty_keys: Set[tuple] = set()   # (table, key) pending flush
        self._snapshot_task: Optional[asyncio.Task] = None
        self._flush_lock = asyncio.Lock()
        self._flush_gen = 0
        self._flushed_gen = 0  # last generation SUCCESSFULLY written
        self._wal_size = 0
        # -- tables (reference: gcs_table_storage.h) ----------------------
        self.nodes: Dict[str, Dict[str, Any]] = {}       # node_id hex -> info
        self.actors: Dict[str, Dict[str, Any]] = {}      # actor_id hex -> info
        self.named_actors: Dict[str, str] = {}           # "ns/name" -> actor id
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.kv: Dict[str, bytes] = {}
        self.workers: Dict[str, Dict[str, Any]] = {}
        self.placement_groups: Dict[str, Dict[str, Any]] = {}
        # Task-event store, bounded (reference: GcsTaskManager's
        # max_num_task_events_stored).
        from collections import deque

        self.task_events: deque = deque(maxlen=100_000)
        # -- pubsub (reference: InternalPubSub / pubsub/) -----------------
        self._subs: Dict[str, Set[ServerConnection]] = {}
        self._pub_seq: Dict[str, int] = {}
        self._heartbeats: Dict[str, float] = {}
        self._health_task: Optional[asyncio.Task] = None
        self._start_time = time.time()
        # Post-restart grace: until this instant, nodes recovered from
        # persisted state (stale_view=True) are exempt from health-check
        # death — they need at least one full heartbeat interval to find
        # the restarted server before we may judge them (set by
        # _load_storage when it recovers alive nodes).
        self._restart_grace_until = 0.0
        # GCS-led placement-group rescheduling: pg_id -> the asyncio
        # task re-placing its lost bundles. Spawned by _mark_node_dead,
        # resumed at start() for groups recovered mid-RESCHEDULING,
        # re-kicked by the health loop when a stuck group's cluster
        # changes.
        self._reschedule_tasks: Dict[str, asyncio.Task] = {}
        # Outbound raylet clients for the reschedule 2PC.
        self._raylet_clients: Dict[str, Any] = {}
        # -- metrics pipeline (round 17) ----------------------------------
        # metric_series is the PERSISTED half (series metadata: identity,
        # type, labels, help, boundaries — rides the WAL like any table);
        # the retention rings live only in the store: after a kill -9 the
        # recovered metadata makes re-pushed series land on their old
        # identity instead of registering duplicates, while point history
        # restarts empty.
        from ray_tpu_torch.core.gcs.metrics_store import MetricsStore, SloTracker

        self.metric_series: Dict[str, Dict[str, Any]] = {}
        cfg = ray_config()
        self.metrics = MetricsStore(
            max_series=cfg.metrics_max_series,
            points=cfg.metrics_retention_points,
            on_register=self._on_series_register)
        self.slo = SloTracker(on_transition=self._on_slo_transition)
        self._slo_last_eval = 0.0

    def _on_series_register(self, key: str, meta: Dict[str, Any]) -> None:
        self.metric_series[key] = meta
        self.mark_dirty("metric_series", key)  # 1 Hz debounced flush

    def _on_slo_transition(self, name: str, old: str, new: str,
                           burn: float) -> None:
        from ray_tpu_torch.core import flight

        logger.warning("SLO %s: %s -> %s (burn %.2fx)", name, old, new, burn)
        if flight.enabled:
            flight.instant("slo", "slo.burn",
                           arg=f"{name}:{old}->{new}:burn={burn:.2f}")

    @property
    def address(self) -> str:
        return self._rpc.address

    async def start(self, serve_rpc: bool = True) -> None:
        """`serve_rpc=False` runs the full control plane — storage
        recovery, health loop, snapshot loop, every handler — without
        binding a TCP listener. core/simcluster.py uses it to drive N
        simulated raylets against this REAL server through in-process
        loopback dispatch."""
        self._load_storage()
        # Re-pushed series after a restart must reuse their WAL-recovered
        # identity (no duplicate registration): seed the store with the
        # persisted metadata before the first heartbeat can arrive.
        self.metrics.adopt_metadata(self.metric_series)
        self._recover_slos()
        # Cluster identity: ephemeral ports get reused across test
        # clusters on one box, and a reconnecting client could silently
        # adopt a FOREIGN cluster that happens to listen on its cached
        # address. The id survives GCS restarts (persisted in kv) so
        # legitimate FT reconnects still pass the check (reference: the
        # cluster ID stamped into every GCS connection, gcs_client).
        import uuid

        cid = self.kv.get("__cluster_id__")
        if cid is not None:
            self.cluster_id = (cid.decode() if isinstance(cid, bytes)
                               else str(cid))
        else:
            self.cluster_id = uuid.uuid4().hex
            self.kv["__cluster_id__"] = self.cluster_id.encode()
            self.mark_dirty("kv", "__cluster_id__")
        # Crash-resume: a kill -9 mid-reschedule leaves groups
        # RESCHEDULING (the transition was written through); a crash
        # BEFORE the transition leaves a CREATED group pointing at a
        # node recovered as dead. Both resume here.
        await self._rescan_reschedules()
        if serve_rpc:
            await self._rpc.start()
        self._health_task = asyncio.ensure_future(self._health_loop())
        if self._storage_path:
            self._snapshot_task = asyncio.ensure_future(
                self._snapshot_loop())
        if serve_rpc:
            logger.info("GCS listening on %s", self.address)

    async def handle_cluster_id(self, conn: ServerConnection) -> str:
        return self.cluster_id

    # -- durable storage (reference: gcs_table_storage.h over a store
    # client, redis_store_client.h's per-key writes). Incremental: each
    # flush appends only the mutated (table, key) records to a write-ahead
    # log; a full snapshot is written only when the WAL grows past
    # `gcs_wal_compact_bytes` (compaction), so flush cost is O(delta), not
    # O(cluster state). --------------------------------------------------
    # Nodes persist too (round 14): at 100 nodes, losing the membership
    # table on every GCS restart forced a full re-registration storm
    # before any scheduling could resume. Recovered records come back
    # with stale_view=True (resource view unconfirmed) and enjoy a
    # health-check grace window; a node's first post-restart heartbeat
    # reconciles the live view and clears the flag — no re-register RPC
    # needed, no herd.
    _PERSISTED_TABLES = ("nodes", "actors", "named_actors", "jobs",
                         "placement_groups", "kv", "metric_series")

    def mark_dirty(self, table: Optional[str] = None,
                   *keys: str) -> None:
        """Record mutated rows for the next flush. With no arguments the
        entire persisted state is marked (recovery/migration path)."""
        self._dirty = True
        if not self._storage_path:
            return  # nothing consumes the key set; don't grow it unbounded
        if table is None:
            for t in self._PERSISTED_TABLES:
                self._dirty_keys.update((t, k) for k in getattr(self, t))
        else:
            self._dirty_keys.update((table, k) for k in keys)

    async def flush_now(self) -> None:
        """Write-through for registration-class mutations (named actors,
        KV, jobs, PGs): the reference GCS acks only after the store
        client persisted (redis_store_client.h), so a crash must not
        lose an acked registration. High-churn updates (heartbeats,
        actor state transitions) stay on the 1 Hz debounce."""
        if not self._storage_path:
            return
        import pickle
        import struct

        my_gen = self._flush_gen
        async with self._flush_lock:
            if self._flushed_gen > my_gen:
                # A flush that STARTED after this caller's mutation (and
                # after it queued here) captured it AND hit disk: coalesce
                # instead of writing once per acked KV put. Comparing
                # against the successfully-WRITTEN generation matters —
                # coalescing on a failed overlapping write would ack a
                # mutation that never persisted.
                return
            gen = self._flush_gen = self._flush_gen + 1
            self._dirty = False
            keys = self._dirty_keys
            self._dirty_keys = set()
            if not keys:
                self._flushed_gen = gen
                return
            # Serialize ON the event loop: handlers can't mutate records
            # while we pickle, so no deep copy is needed and the writer
            # thread only ever touches immutable bytes.
            records = []
            for table, key in keys:
                tbl = getattr(self, table)
                records.append((table, key, key in tbl, tbl.get(key)))
            payload = pickle.dumps(records, protocol=5)
            frame = struct.pack("<I", len(payload)) + payload
            try:
                await asyncio.to_thread(self._append_wal, frame)
                self._flushed_gen = gen
            except Exception:
                self._dirty_keys |= keys
                self._dirty = True  # snapshot loop retries
                logger.warning("GCS write-through failed", exc_info=True)
                # Callers ack durability to their clients — a failed
                # write must surface as a failed mutation, not a silent
                # success that a crash then forgets.
                raise
            if self._wal_size >= ray_config().gcs_wal_compact_bytes:
                await self._compact()

    _SNAP_MAGIC = b"GSNP1\x00"

    async def _compact(self) -> None:
        """Fold the WAL into a fresh full snapshot. Caller holds
        _flush_lock, so no deltas append concurrently. Records are pickled
        on the loop in small batches with a yield between them, so the loop
        never stalls for the whole state (heartbeats keep flowing); a
        record mutated after its batch was serialized is in _dirty_keys
        and its delta lands in the (empty) WAL right after compaction.
        Crash between the snapshot rename and the WAL truncate is safe:
        replaying the stale WAL re-applies values the snapshot already
        contains."""
        import pickle
        import struct

        frames = [self._SNAP_MAGIC]
        for t in self._PERSISTED_TABLES:
            tbl = getattr(self, t)
            keys = list(tbl)
            for i in range(0, len(keys), 500):
                batch = [(t, k, True, tbl[k]) for k in keys[i:i + 500]
                         if k in tbl]
                payload = pickle.dumps(batch, protocol=5)
                frames.append(struct.pack("<I", len(payload)) + payload)
                await asyncio.sleep(0)
        blob = b"".join(frames)
        try:
            await asyncio.to_thread(self._write_snapshot_and_truncate, blob)
        except Exception:
            logger.warning("GCS compaction failed (WAL keeps growing)",
                           exc_info=True)

    def _load_storage(self) -> None:
        if not self._storage_path:
            return
        import os
        import pickle
        import struct

        if os.path.exists(self._storage_path):
            try:
                with open(self._storage_path, "rb") as f:
                    head = f.read(len(self._SNAP_MAGIC))
                    if head == self._SNAP_MAGIC:
                        # Framed snapshot (same record format as the WAL).
                        self._replay_frames(f, torn_ok=False)
                    else:
                        # Legacy single-pickle snapshot.
                        f.seek(0)
                        snap = pickle.load(f)
                        for table in self._PERSISTED_TABLES:
                            getattr(self, table).update(snap.get(table, {}))
            except Exception:
                logger.warning(
                    "GCS snapshot at %s unreadable; starting from WAL only",
                    self._storage_path, exc_info=True)
        # Replay the delta log over the snapshot. A torn tail (crash mid
        # append) ends the replay at the last complete frame — and the
        # file MUST then be truncated to that frame before _append_wal
        # reopens it in append mode: new fsynced+acked frames written
        # after a surviving partial frame would be unreachable to every
        # future replay (ADVICE r5 high: acked writes silently dropped
        # on the second restart).
        wal = self._wal_path()
        if os.path.exists(wal):
            with open(wal, "rb") as f:
                replayed, clean_end = self._replay_frames(f, torn_ok=True)
            wal_size = os.path.getsize(wal)
            if clean_end < wal_size:
                logger.warning(
                    "GCS WAL has a torn tail (%d of %d bytes replayable);"
                    " truncating before accepting new appends",
                    clean_end, wal_size)
                with open(wal, "r+b") as f:
                    f.truncate(clean_end)
                    f.flush()
                    os.fsync(f.fileno())
                wal_size = clean_end
            self._wal_size = wal_size
            if replayed:
                logger.info("GCS replayed %d WAL batches", replayed)
        # Recovered actor records point at pre-restart workers; their
        # liveness is re-established by owners / health checks. Recovered
        # NODE records carry a pre-crash resource view: mark them stale
        # (cleared by their first live heartbeat; pg_scheduler deprefers
        # stale views) and open the post-restart grace window so the
        # health loop cannot storm _mark_node_dead before the raylets
        # have had one full heartbeat interval to find us.
        recovered_alive = [n for n in self.nodes.values()
                           if n.get("alive")]
        if recovered_alive:
            cfg = ray_config()
            grace_ms = cfg.gcs_restart_node_grace_ms or (
                cfg.health_check_period_ms
                * cfg.health_check_failure_threshold)
            now = time.time()
            self._restart_grace_until = now + grace_ms / 1000.0
            for info in recovered_alive:
                info["stale_view"] = True
                # Seed the heartbeat clock at boot: a recovered node that
                # never reports again ages out of the grace window into a
                # normal missed-heartbeat death instead of living forever
                # on a missing dict entry.
                self._heartbeats.setdefault(info["node_id"], now)
        logger.info("GCS recovered %d actors, %d jobs, %d kv keys, "
                    "%d nodes (%d alive, grace %.1fs) from %s",
                    len(self.actors), len(self.jobs), len(self.kv),
                    len(self.nodes), len(recovered_alive),
                    max(0.0, self._restart_grace_until - time.time()),
                    self._storage_path)

    async def _snapshot_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            if not self._dirty:
                continue
            # flush_now serializes every writer through _flush_lock —
            # an unsynchronized periodic write could capture older tables
            # yet land over a newer write-through.
            try:
                await self.flush_now()
            except Exception:
                pass  # stays dirty; retried next tick

    def _replay_frames(self, f, torn_ok: bool):
        """Apply length-prefixed record batches from an open file. A torn
        tail (crash mid-append) ends a WAL replay at the last complete
        frame; in a snapshot it means corruption, so raise. Returns
        (frames_applied, offset_after_last_complete_frame) — the offset
        is what a WAL load truncates to."""
        import pickle
        import struct

        replayed = 0
        clean_end = f.tell()
        while True:
            hdr = f.read(4)
            if not hdr:
                break
            if len(hdr) < 4:
                if torn_ok:
                    break
                raise EOFError("truncated snapshot frame header")
            (n,) = struct.unpack("<I", hdr)
            payload = f.read(n)
            if len(payload) < n:
                if torn_ok:
                    break
                raise EOFError("truncated snapshot frame")
            try:
                records = pickle.loads(payload)
            except Exception:
                if torn_ok:
                    break
                raise
            for table, key, present, value in records:
                tbl = getattr(self, table, None)
                if tbl is None:
                    continue
                if present:
                    tbl[key] = value
                else:
                    tbl.pop(key, None)
            replayed += 1
            clean_end = f.tell()
        return replayed, clean_end

    def _wal_path(self) -> str:
        return f"{self._storage_path}.wal"

    def _append_wal(self, frame: bytes) -> None:
        import os

        if not self._storage_path:
            # Storage severed under us (simcluster kill -9: a flush
            # already past flush_now's entry check must fail, not land
            # in a stray file): surface as a failed write.
            raise OSError("GCS storage detached")
        with open(self._wal_path(), "ab") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
            self._wal_size = f.tell()

    def _write_snapshot_and_truncate(self, blob: bytes) -> None:
        import os
        import threading

        if not self._storage_path:
            raise OSError("GCS storage detached")

        # Unique tmp per writer: stop()'s final flush may overlap an
        # in-flight to_thread write; each renames atomically.
        tmp = (f"{self._storage_path}.tmp.{os.getpid()}"
               f".{threading.get_ident()}")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._storage_path)
        with open(self._wal_path(), "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        self._wal_size = 0

    async def stop(self) -> None:
        if self._health_task:
            self._health_task.cancel()
        if self._snapshot_task:
            self._snapshot_task.cancel()
        if self._storage_path and self._dirty:
            # Final flush: acked mutations survive a clean shutdown
            # (through the same lock as every other writer).
            try:
                await self.flush_now()
            except Exception:
                pass  # already logged; shutdown must proceed
        for task in self._reschedule_tasks.values():
            task.cancel()
        self._reschedule_tasks.clear()
        for client in self._raylet_clients.values():
            try:
                await client.close()
            except Exception:
                pass
        self._raylet_clients.clear()
        await self._rpc.stop()

    # ------------------------------------------------------------------
    # health checking (reference: gcs_health_check_manager.h:39)
    # ------------------------------------------------------------------
    async def _health_loop(self) -> None:
        cfg = ray_config()
        period = cfg.health_check_period_ms / 1000.0
        threshold = cfg.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            now = time.time()
            for node_id, info in list(self.nodes.items()):
                if not info.get("alive"):
                    continue
                if (info.get("stale_view")
                        and now < self._restart_grace_until):
                    # Post-restart grace: this node was recovered from
                    # storage and has not re-confirmed yet — give it a
                    # full re-registration window before any death
                    # verdict (a restart must not read as 100
                    # simultaneous node failures).
                    continue
                last = self._heartbeats.get(node_id, now)
                if now - last > period * threshold:
                    logger.warning("node %s missed heartbeats; marking dead",
                                   node_id[:8])
                    await self._mark_node_dead(node_id)
            # Re-kick stuck reschedules + the mid-pass-race safety net
            # (one shared scan; see _rescan_reschedules).
            await self._rescan_reschedules()
            # SLO burn-rate evaluation rides this loop rather than its
            # own task: the simcluster kill -9 cancels a known task set,
            # and one more periodic scan does not deserve one more task.
            if self.slo.slos and (
                    now - self._slo_last_eval
                    >= cfg.slo_eval_period_ms / 1000.0):
                self._slo_last_eval = now
                try:
                    self.slo.evaluate(self.metrics, now=now)
                except Exception:
                    logger.warning("SLO evaluation failed", exc_info=True)

    async def _mark_node_dead(self, node_id: str) -> None:
        info = self.nodes.get(node_id)
        if info is None or not info.get("alive"):
            return
        info["alive"] = False
        info["end_time"] = time.time()
        self.mark_dirty("nodes", node_id)
        from ray_tpu_torch.core import flight

        if flight.enabled:
            flight.instant("node", "node.dead", arg=node_id[:8])
        await self._publish("node", {
            "node_id": node_id, "alive": False,
            "address": (self.nodes.get(node_id) or {}).get("address")})
        # Fail actors that lived on the node.
        for actor_id, a in self.actors.items():
            if a.get("node_id") == node_id and a["state"] not in (
                    "DEAD",):
                a["state"] = "DEAD"
                a["death_cause"] = "node_died"
                await self._publish(f"actor:{actor_id}", a)
        # GCS-led PG rescheduling (round 15): a CREATED group with a
        # bundle on the dead node goes RESCHEDULING (write-through CAS)
        # and a recovery pass re-places only the lost bundles onto
        # survivors. Owner-led recovery is impossible here — the owner
        # may have died WITH the node. Same scan the health loop runs.
        await self._rescan_reschedules()

    # ------------------------------------------------------------------
    # GCS-led placement-group rescheduling (round 15; reference:
    # GcsPlacementGroupScheduler rescheduling on node removal)
    # ------------------------------------------------------------------
    async def _rescan_reschedules(self) -> None:
        """The one reschedule scan (start() crash-resume, health loop):
        RESCHEDULING groups get a live pass (stuck ones re-kick each
        period — new node registrations make yesterday's infeasible
        placement feasible), and CREATED groups naming a non-alive
        node re-begin. The CREATED check is the SAFETY NET for the
        mid-pass race: a node that dies while its group is already
        RESCHEDULING is skipped by _mark_node_dead's CREATED-only
        trigger, so the pass can land CREATED with a location table
        naming the fresh corpse — this scan heals it."""
        for pg_id, pg in list(self.placement_groups.items()):
            state = pg.get("state")
            if state == "RESCHEDULING":
                self._spawn_reschedule(pg_id)
            elif state == "CREATED" and any(
                    not (self.nodes.get(loc.get("node_id")) or {})
                    .get("alive", False)
                    for loc in pg.get("bundle_locations") or []):
                await self._begin_reschedule(pg_id)

    async def _begin_reschedule(self, pg_id: str) -> None:
        """CAS a CREATED group to RESCHEDULING (write-through: the
        raylet reconciler must see the group still stands behind its
        surviving bundles across a GCS crash) and spawn the recovery
        pass."""
        ok = await self.handle_update_placement_group(
            None, pg_id=pg_id, updates={"state": "RESCHEDULING"},
            expect_state="CREATED")
        if ok:
            self._spawn_reschedule(pg_id)

    def _spawn_reschedule(self, pg_id: str) -> None:
        task = self._reschedule_tasks.get(pg_id)
        if task is not None and not task.done():
            return
        task = asyncio.ensure_future(self._reschedule_pg(pg_id))
        self._reschedule_tasks[pg_id] = task
        # Self-pruning: a finished pass must not pin its Task (frame,
        # locals) for the life of the process under PG churn.
        task.add_done_callback(
            lambda t, pg_id=pg_id: (
                self._reschedule_tasks.pop(pg_id, None)
                if self._reschedule_tasks.get(pg_id) is t else None))

    async def _reschedule_pg(self, pg_id: str) -> None:
        from ray_tpu_torch.core.pg_scheduler import reschedule_placement_group

        try:
            state = await reschedule_placement_group(
                self._local_accessor(), self._raylet_client_for, pg_id)
            if state == "RESCHEDULING":
                logger.warning(
                    "placement group %s still RESCHEDULING after every "
                    "attempt (no feasible placement); the health loop "
                    "re-kicks when the cluster changes", pg_id[:8])
        except Exception:
            logger.warning("pg %s reschedule pass crashed", pg_id[:8],
                           exc_info=True)

    def _local_accessor(self) -> Any:
        """What `reschedule_placement_group` needs from 'the GCS' — the
        same three accessors the owner-side 2PC uses, served from our
        own tables so the protocol definition stays shared."""
        server = self

        class _Accessor:
            async def get_placement_group(self, pg_id):
                return server.placement_groups.get(pg_id)

            async def get_nodes(self):
                return list(server.nodes.values())

            async def update_placement_group(self, pg_id, updates,
                                             expect_state=None):
                return await server.handle_update_placement_group(
                    None, pg_id=pg_id, updates=updates,
                    expect_state=expect_state)

        return _Accessor()

    async def _raylet_client_for(self, address: str) -> Any:
        """Outbound raylet client for the reschedule 2PC, dialled once
        and cached."""
        from ray_tpu_torch.core.rpc import RpcClient

        client = self._raylet_clients.get(address)
        if client is None or not client.connected:
            if client is not None:
                # Replace-without-close leaks the dead client's
                # transport on every raylet flap.
                try:
                    await client.close()
                except Exception:
                    pass
            client = RpcClient(address)
            await client.connect(timeout=5.0)
            self._raylet_clients[address] = client
        return client


    # ------------------------------------------------------------------
    # pubsub
    # ------------------------------------------------------------------
    async def _publish(self, channel: str, data: Any) -> None:
        # Typed pubsub envelope (core/wire.py PubsubMessage): per-channel
        # delivery sequence numbers let subscribers detect drops; the
        # client unwraps centrally so channel handlers see plain data.
        from ray_tpu_torch.core.wire import PubsubMessage, to_wire

        seq = self._pub_seq[channel] = self._pub_seq.get(channel, 0) + 1
        frame = to_wire(PubsubMessage(channel=channel, data=data, seq=seq))
        for conn in list(self._subs.get(channel, ())):
            if conn.closed:
                self._subs[channel].discard(conn)
            else:
                await conn.push(channel, frame)

    async def handle_subscribe(self, conn: ServerConnection, *,
                               channel: str) -> bool:
        self._subs.setdefault(channel, set()).add(conn)
        conn.metadata.setdefault("channels", set()).add(channel)
        return True

    async def handle_unsubscribe(self, conn: ServerConnection, *,
                                 channel: str) -> bool:
        self._subs.get(channel, set()).discard(conn)
        return True

    async def handle_publish(self, conn: ServerConnection, *, channel: str,
                             data: Any) -> bool:
        await self._publish(channel, data)
        return True

    async def on_client_disconnect(self, conn: ServerConnection) -> None:
        for channel in conn.metadata.get("channels", ()):
            self._subs.get(channel, set()).discard(conn)
        node_id = conn.metadata.get("node_id")
        if node_id:
            await self._mark_node_dead(node_id)
        worker_id = conn.metadata.get("worker_id")
        if worker_id and worker_id in self.workers:
            self.workers[worker_id]["alive"] = False

    # ------------------------------------------------------------------
    # nodes (reference: GcsNodeManager + NodeInfoGcsService)
    # ------------------------------------------------------------------
    async def handle_register_node(self, conn: ServerConnection, *,
                                   node: Optional[dict] = None,
                                   node_id: str = "", address: str = "",
                                   object_store_address: str = "",
                                   resources: Optional[Dict[str, float]]
                                   = None,
                                   labels: Optional[Dict[str, str]] = None,
                                   is_head: bool = False) -> Dict[str, Any]:
        if node is not None:
            from ray_tpu_torch.core.wire import from_wire

            n = from_wire(node, expect="NodeInfo")
            node_id, address = n.node_id, n.address
            object_store_address = n.object_store_address or address
            resources, labels = n.resources, n.labels
            is_head = n.is_head
        resources = resources or {}
        labels = labels or {}
        # A node re-registering after WE declared it dead must be told:
        # the cluster already restarted its actors and reconstructed its
        # objects elsewhere, so its surviving actor workers are stale.
        was_dead = (node_id in self.nodes
                    and not self.nodes[node_id].get("alive", True))
        self.nodes[node_id] = {
            "node_id": node_id,
            "address": address,
            "object_store_address": object_store_address,
            "resources_total": resources,
            "resources_available": dict(resources),
            "labels": labels,
            "alive": True,
            "is_head": is_head,
            "start_time": time.time(),
        }
        self._heartbeats[node_id] = time.time()
        conn.metadata["node_id"] = node_id
        self.mark_dirty("nodes", node_id)
        await self._publish("node", {"node_id": node_id, "alive": True})
        return {"ok": True, "was_dead": was_dead}

    async def handle_heartbeat(self, conn: ServerConnection, *, node_id: str,
                               resources_available: Dict[str, float],
                               load: Optional[Dict[str, Any]] = None,
                               metrics: Optional[List[Dict[str, Any]]] = None,
                               workers: Optional[List[Dict[str, Any]]] = None,
                               ) -> bool:
        info = self.nodes.get(node_id)
        if info is None or not info.get("alive", False):
            # Unknown (registration lost with an unpersisted crash) or
            # previously declared dead: the raylet must re-register
            # before its heartbeats count (GCS FT re-registration
            # contract — raylet re-registers on a False reply).
            return False
        self._heartbeats[node_id] = time.time()
        info["resources_available"] = resources_available
        # First heartbeat after a restart reconciles the recovered
        # record: the live view replaces the persisted snapshot.
        info.pop("stale_view", None)
        # Bind the node to this connection so a post-restart disconnect
        # still marks it dead promptly — recovered nodes never re-call
        # register_node, which is where the binding used to happen.
        conn.metadata["node_id"] = node_id
        if load is not None:
            info["load"] = load
        if metrics:
            # The node's coalesced metrics push rides the heartbeat — one
            # RPC per node per interval, whatever the worker count.
            try:
                self.metrics.ingest(
                    metrics, extra_labels={"node_id": node_id[:8]})
            except Exception:
                logger.warning("bad metrics batch from %s",
                               node_id[:8], exc_info=True)
        if workers is not None:
            # Batched per-worker state (ROADMAP 4d): the raylet folds its
            # whole worker table into the node heartbeat — one RPC per
            # tick, not one per worker — and the records land as SOFT
            # state (not in _PERSISTED_TABLES), so worker churn never
            # touches the quorum-replicated write path.
            now = time.time()
            seen = set()
            for w in workers:
                wid = w.get("worker_id")
                if not wid:
                    continue
                seen.add(wid)
                self.workers[wid] = dict(
                    w, node_id=node_id, alive=True, last_seen=now)
            for wid, info in list(self.workers.items()):
                if info.get("node_id") == node_id and wid not in seen:
                    # Absent from its raylet's batch: the worker exited
                    # (the raylet reports its whole live table each tick).
                    del self.workers[wid]
        return True

    async def handle_get_nodes(self, conn: ServerConnection,
                               ) -> List[Dict[str, Any]]:
        return list(self.nodes.values())

    async def handle_drain_node(self, conn: ServerConnection, *,
                                node_id: str) -> bool:
        await self._mark_node_dead(node_id)
        return True

    # ------------------------------------------------------------------
    # actors (reference: GcsActorManager; lifecycle gcs_actor_manager.h:251)
    # ------------------------------------------------------------------
    async def handle_register_actor(self, conn: ServerConnection, *,
                                    actor_id: str, info: Dict[str, Any]
                                    ) -> Dict[str, Any]:
        if isinstance(info, dict) and "_t" in info:
            # Typed decode (core/wire.py ActorInfo): malformed peers fail
            # here with a WireDecodeError naming the bad field; the table
            # stores the validated plain record.
            from ray_tpu_torch.core.wire import from_wire

            info = from_wire(info, expect="ActorInfo").as_dict()
        name = info.get("name")
        ns = info.get("namespace") or "default"
        if name:
            key = f"{ns}/{name}"
            existing = self.named_actors.get(key)
            if existing == actor_id:
                pass  # at-least-once retry of our own registration
            elif existing is not None:
                state = self.actors.get(existing, {}).get("state")
                if state not in ("DEAD", None):
                    return {"ok": False,
                            "error": f"actor name '{name}' already taken in "
                                     f"namespace '{ns}'"}
            self.named_actors[key] = actor_id
            self.mark_dirty("named_actors", key)
        self.mark_dirty("actors", actor_id)
        info = dict(info, actor_id=actor_id, state=info.get("state",
                                                            "PENDING"))
        self.actors[actor_id] = info
        await self._publish(f"actor:{actor_id}", info)
        if name:
            # Only NAMED registrations are looked up after a restart;
            # anonymous actors ride the 1 Hz debounce (a full-table
            # snapshot per short-lived actor would serialize creation).
            await self.flush_now()
        return {"ok": True}

    async def handle_update_actor(self, conn: ServerConnection, *,
                                  actor_id: str,
                                  updates: Dict[str, Any]) -> bool:
        info = self.actors.get(actor_id)
        if info is None:
            return False
        info.update(updates)
        self.mark_dirty("actors", actor_id)
        await self._publish(f"actor:{actor_id}", info)
        if info.get("state") == "DEAD":
            name = info.get("name")
            ns = info.get("namespace") or "default"
            # A restartable actor keeps its name through death: its owner
            # may revive it (reference: gcs_actor_manager.h RESTARTING
            # keeps the registration). Intentional kills and
            # non-restartable actors free the name immediately.
            restartable = (info.get("max_restarts", 0) != 0
                           and updates.get("death_cause") != "ray.kill")
            if (name and not restartable
                    and self.named_actors.get(f"{ns}/{name}") == actor_id):
                del self.named_actors[f"{ns}/{name}"]
                self.mark_dirty("named_actors", f"{ns}/{name}")
            if not restartable:
                await self._remove_groups_of_creator(actor_id)
        return True

    async def handle_get_actor(self, conn: ServerConnection, *,
                               actor_id: Optional[str] = None,
                               name: Optional[str] = None,
                               namespace: str = "default"
                               ) -> Optional[Dict[str, Any]]:
        if actor_id is None and name is not None:
            actor_id = self.named_actors.get(f"{namespace}/{name}")
        if actor_id is None:
            return None
        return self.actors.get(actor_id)

    async def handle_list_actors(self, conn: ServerConnection
                                 ) -> List[Dict[str, Any]]:
        return list(self.actors.values())

    # ------------------------------------------------------------------
    # jobs (reference: GcsJobManager)
    # ------------------------------------------------------------------
    async def handle_add_job(self, conn: ServerConnection, *, job_id: str,
                             info: Dict[str, Any]) -> bool:
        if isinstance(info, dict) and "_t" in info:
            from ray_tpu_torch.core.wire import from_wire

            info = from_wire(info, expect="JobInfo").as_dict()
        self.jobs[job_id] = dict(info, job_id=job_id,
                                 start_time=time.time())
        self.mark_dirty("jobs", job_id)
        return True

    async def handle_get_job(self, conn: ServerConnection, *,
                             job_id: str) -> Optional[Dict[str, Any]]:
        return self.jobs.get(job_id)

    async def handle_mark_job_finished(self, conn: ServerConnection, *,
                                       job_id: str) -> bool:
        if job_id in self.jobs:
            self.jobs[job_id]["finished"] = True
            self.jobs[job_id]["end_time"] = time.time()
            self.mark_dirty("jobs", job_id)
        # Non-detached actors die with their job (reference:
        # GcsActorManager::OnJobFinished); raylets subscribe and reap
        # their local actor workers. Detached actors survive.
        for actor_id, info in list(self.actors.items()):
            if (info.get("job_id") == job_id
                    and not info.get("detached")
                    and info.get("state") not in ("DEAD",)):
                info["state"] = "DEAD"
                info["death_cause"] = "job finished"
                self.mark_dirty("actors", actor_id)
                await self._publish(f"actor:{actor_id}", info)
        await self._publish("job", {"job_id": job_id, "finished": True})
        return True

    async def handle_list_jobs(self, conn: ServerConnection
                               ) -> List[Dict[str, Any]]:
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # task events (reference: GcsTaskManager + task_event_buffer flushes)
    # ------------------------------------------------------------------
    async def handle_add_task_events(self, conn: ServerConnection, *,
                                     events: List[Dict[str, Any]]) -> bool:
        self.task_events.extend(events)
        return True

    async def handle_get_task_events(
            self, conn: ServerConnection, *,
            job_id: Optional[str] = None) -> List[Dict[str, Any]]:
        events = list(self.task_events)
        if job_id is not None:
            events = [e for e in events if e.get("job_id") == job_id]
        return events

    # ------------------------------------------------------------------
    # internal KV (reference: GcsKvManager / InternalKV service)
    # ------------------------------------------------------------------
    async def handle_kv_put(self, conn: ServerConnection, *, key: bytes,
                            value: bytes, overwrite: bool = True) -> bool:
        k = key.decode() if isinstance(key, bytes) else key
        if not overwrite and k in self.kv:
            # Equal value => treat as an at-least-once retry of the put
            # that already won (the client may never have seen the ack).
            return self.kv[k] == value
        self.kv[k] = value
        self.mark_dirty("kv", k)
        await self.flush_now()  # KV acks are durable (Serve state, etc.)
        return True

    async def handle_kv_get(self, conn: ServerConnection, *,
                            key: bytes) -> Optional[bytes]:
        k = key.decode() if isinstance(key, bytes) else key
        return self.kv.get(k)

    async def handle_kv_del(self, conn: ServerConnection, *,
                            key: bytes) -> bool:
        k = key.decode() if isinstance(key, bytes) else key
        existed = self.kv.pop(k, None) is not None
        self.mark_dirty("kv", k)
        await self.flush_now()
        return existed

    async def handle_kv_keys(self, conn: ServerConnection, *,
                             prefix: str) -> List[str]:
        return [k for k in self.kv if k.startswith(prefix)]

    async def handle_kv_exists(self, conn: ServerConnection, *,
                               key: bytes) -> bool:
        k = key.decode() if isinstance(key, bytes) else key
        return k in self.kv

    # ------------------------------------------------------------------
    # placement groups (table only; 2PC runs between owner and raylets)
    # ------------------------------------------------------------------
    async def handle_register_placement_group(
            self, conn: ServerConnection, *, pg_id: str,
            info: Dict[str, Any]) -> bool:
        self.placement_groups[pg_id] = dict(info, pg_id=pg_id)
        self.mark_dirty("placement_groups", pg_id)
        # Write-through: the registered record is what raylet-side
        # bundle reconciliation trusts after a crash — a PG whose
        # registration died with the debounce would read as "lost" and
        # have its half-prepared bundles returned while the owner still
        # believes it is scheduling (2PC atomicity, ISSUE 14).
        await self.flush_now()
        return True

    async def handle_update_placement_group(
            self, conn: ServerConnection, *, pg_id: str,
            updates: Dict[str, Any],
            expect_state: Optional[str] = None) -> bool:
        """`expect_state` makes the update conditional (CAS): the async
        owner-side scheduler must not resurrect a REMOVED group."""
        info = self.placement_groups.get(pg_id)
        if info is None:
            return False
        if expect_state is not None and info.get("state") != expect_state:
            return False
        info.update(updates)
        self.mark_dirty("placement_groups", pg_id)
        await self._publish(f"pg:{pg_id}", info)
        if updates.get("state") in ("CREATED", "REMOVED", "INFEASIBLE",
                                    "RESCHEDULING"):
            # Terminal transitions are registration-class (see
            # flush_now docstring): an acked CREATED that a kill -9
            # forgets would leave committed bundles pointing at a
            # PENDING ghost after restart — exactly the half-reserved
            # state the chaos test forbids. RESCHEDULING writes through
            # too: the recovery pass must resume (not vanish) across a
            # GCS crash, and the raylet reconciler must keep standing
            # behind the surviving bundles it reads this state for.
            await self.flush_now()
        return True

    async def _remove_groups_of_creator(self, actor_id: str) -> None:
        """A group created inside an actor lives as long as that actor
        (upstream Ray: GcsPlacementGroupManager cleans a dead creator's
        groups), as Tune's trial actor creates its gang's: mark its live
        groups REMOVED. The raylets' bundle reconcile then returns their
        reservations, since the creator that would have returned them is
        gone."""
        for pg_id, info in list(self.placement_groups.items()):
            if (info.get("creator_actor_id") == actor_id
                    and info.get("state") in ("PENDING", "CREATED",
                                              "RESCHEDULING")):
                await self.handle_update_placement_group(
                    None, pg_id=pg_id,
                    updates={"state": "REMOVED",
                             "detail": f"creator actor {actor_id[:8]} "
                                       "died"},
                    expect_state=info.get("state"))

    async def handle_get_placement_group(
            self, conn: ServerConnection, *,
            pg_id: str) -> Optional[Dict[str, Any]]:
        return self.placement_groups.get(pg_id)

    async def handle_list_placement_groups(
            self, conn: ServerConnection) -> List[Dict[str, Any]]:
        return list(self.placement_groups.values())

    # ------------------------------------------------------------------
    # metrics pipeline + SLOs (round 17 observability)
    # ------------------------------------------------------------------
    async def handle_query_metrics(
            self, conn: ServerConnection, *, series: str,
            window_s: float = 60.0, agg: str = "raw",
            labels: Optional[Dict[str, str]] = None,
            group_by: Optional[List[str]] = None) -> Dict[str, Any]:
        return self.metrics.query(series, window_s=float(window_s),
                                  agg=agg, labels=labels, group_by=group_by)

    async def handle_latest_metrics(self, conn: ServerConnection
                                    ) -> List[Dict[str, Any]]:
        """The latest cluster-wide fold, registry-snapshot shaped (what
        the dashboard renders as Prometheus text at GET /metrics)."""
        return self.metrics.latest_fold()

    async def handle_metrics_stats(self, conn: ServerConnection
                                   ) -> Dict[str, Any]:
        return self.metrics.stats()

    async def handle_register_slo(self, conn: ServerConnection, *,
                                  spec: Dict[str, Any]) -> Dict[str, Any]:
        spec = self.slo.register(dict(spec))
        # Specs are cheap and declarative — persist them in kv so a
        # restarted GCS keeps watching the same objectives.
        import json

        self.kv[f"__slo__/{spec['name']}"] = json.dumps(spec).encode()
        self.mark_dirty("kv", f"__slo__/{spec['name']}")
        await self.flush_now()
        return spec

    async def handle_remove_slo(self, conn: ServerConnection, *,
                                name: str) -> bool:
        self.kv.pop(f"__slo__/{name}", None)
        self.mark_dirty("kv", f"__slo__/{name}")
        return self.slo.remove(name)

    async def handle_get_slo(self, conn: ServerConnection
                             ) -> List[Dict[str, Any]]:
        return self.slo.status(self.metrics)

    def _recover_slos(self) -> None:
        import json

        for k, v in self.kv.items():
            if not k.startswith("__slo__/"):
                continue
            try:
                self.slo.register(json.loads(
                    v.decode() if isinstance(v, bytes) else v))
            except Exception:
                logger.warning("unreadable persisted SLO %s", k,
                               exc_info=True)

    async def handle_dump_flight_record(
            self, conn: ServerConnection, *,
            window_s: Optional[float] = None,
            include_events: bool = True) -> Dict[str, Any]:
        """The GCS's own flight ring (slo.burn, node.dead, ...), shaped
        like the raylet's dump handler so the dashboard merge code can
        treat the GCS as one more source on /api/timeline."""
        from ray_tpu_torch.core import flight

        if not flight.enabled:
            return {"node_id": "gcs", "records": []}
        return {"node_id": "gcs",
                "records": [flight.dump(window_s=window_s,
                                        include_events=include_events)]}

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    async def handle_ping(self, conn: ServerConnection) -> str:
        return "pong"

    async def handle_cluster_info(self, conn: ServerConnection
                                  ) -> Dict[str, Any]:
        info = {
            "address": self.address,
            "cluster_id": self.cluster_id,
            "uptime": time.time() - self._start_time,
            "num_nodes": sum(1 for n in self.nodes.values() if n["alive"]),
            "num_workers": len(self.workers),
        }
        return info


def main() -> None:
    """`python -m ray_tpu_torch.core.gcs.server --port P` — standalone GCS."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--storage", default=None,
                        help="snapshot file for GCS fault tolerance; "
                             "restart with the same path to recover "
                             "tables")
    # The HA replica set's flags, as the reference's CLI takes them:
    # refused until the replica set is ported.
    parser.add_argument("--replica-id", default=None,
                        help="this replica's id in an HA replica set")
    parser.add_argument("--peers", default=None,
                        help="comma-separated id=host:port of the other "
                             "replicas")
    args = parser.parse_args()
    if args.replica_id:
        raise NotImplementedError(
            "--replica-id: the GCS's HA replica set "
            "(core/gcs/replication.py) comes with a later slice of the port")

    logging.basicConfig(level=logging.INFO)

    from ray_tpu_torch.core import flight

    if flight.enabled:
        # The standalone GCS is a flight source too: slo.burn and
        # node.dead events merge onto /api/timeline next to the stalls
        # that caused them (the dashboard scrapes dump_flight_record).
        flight.set_role("gcs")

    async def run():
        server = GcsServer(args.host, args.port,
                           storage_path=args.storage)
        await server.start()
        print(f"GCS_ADDRESS={server.address}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
