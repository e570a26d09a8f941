"""Raylet: per-node scheduler daemon + object-store host, the port of
`ray_tpu/core/raylet.py`, where the reference's TPU chip ids become GPU
instance ids (see `_take_gpus`).

Reference equivalent: `src/ray/raylet/` — `NodeManager` (worker leasing
`node_manager.cc:1767`, scheduling via `ClusterTaskManager`/
`LocalTaskManager`), `WorkerPool` (`worker_pool.h:156`), and the in-process
plasma store. The hybrid scheduling policy (pack locally until a utilization
threshold, then spread; `scheduling/policy/hybrid_scheduling_policy.h:50`)
drives spillback exactly like the reference: a lease reply may redirect the
client to another node, which re-requests there.
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import ray_config
from ray_tpu_torch.core.gcs.client import GcsClient
from ray_tpu_torch.core.object_store import make_store
from ray_tpu_torch.core.rpc import RpcClient, RpcServer, ServerConnection

logger = logging.getLogger(__name__)


class _Worker:
    def __init__(self, worker_id: str, proc: subprocess.Popen):
        self.worker_id = worker_id
        self.proc = proc
        self.address: Optional[str] = None
        self.state = "starting"  # starting | idle | leased | actor | dead
        self.lease_id: Optional[str] = None
        self.ready = asyncio.Event()
        self.actor_id: Optional[str] = None
        self.actor_job_id: Optional[str] = None
        self.actor_detached = False
        self.held: Dict[str, float] = {}  # resources held by active lease
        self.bundle_key: Optional[str] = None  # PG bundle the lease drew from
        self.chip_ids: List[int] = []  # GPU instance ids of this lease
        # The fraction of chip_ids[0] a fractional GPU lease holds (0.0
        # for whole instances).
        self.gpu_share = 0.0
        # Held a lease once: its CUDA may have initialised with the
        # visibility of that lease, so it never takes a GPU lease.
        self.used = False
        self.granted_at = 0.0  # lease grant time (OOM policy: newest dies)
        self.log_path: Optional[str] = None
        self.log_offset = 0  # how far the log monitor has shipped
        self.lease_job_id: Optional[str] = None  # job of the active lease
        self.blocked = False  # task blocked in get(): CPU released


def _gpus_fit(free: List[int], partial: Dict[int, float], n: float) -> bool:
    """Whether a pool of GPU instances (`free`: wholly free ids,
    `partial`: id -> free fraction of a shared one) can hold a demand of
    `n`: a whole demand needs that many wholly free ids, a fractional
    one an instance with that fraction left (the pool's sum may fit
    where no instance does)."""
    if n <= 0:
        return True
    if n >= 1:
        return len(free) >= int(n)
    return bool(free) or any(f + 1e-9 >= n for f in partial.values())


def _take_gpus(free: List[int], partial: Dict[int, float],
               n: float) -> Tuple[List[int], float]:
    """Take GPU instance ids for a demand of `n` from a pool; returns the
    ids and the fraction of ids[0] held (0.0 for whole instances). A
    whole demand takes ids from the front of the free list, as the
    reference takes TPU chips. A fractional one shares an instance, as
    upstream Ray packs GPUs (a CUDA card, unlike a TPU chip, opens in
    several processes): the instance with the least fraction left that
    still holds it, else the first wholly free id."""
    if n <= 0:
        return [], 0.0
    if n < 1:
        fits = [(f, i) for i, f in partial.items() if f + 1e-9 >= n]
        if fits:
            _, gid = min(fits)
        else:
            gid = free.pop(0)
            partial[gid] = 1.0
        partial[gid] -= n
        return [gid], n
    n = int(n)
    taken, free[:] = free[:n], free[n:]
    return taken, 0.0


def _give_gpus(free: List[int], partial: Dict[int, float],
               ids: List[int], share: float) -> None:
    """Return what `_take_gpus` took (or a bundle's whole reservation)
    to a pool; an instance whose shares all came back is wholly free."""
    if share:
        gid = ids[0]
        partial[gid] = partial.get(gid, 0.0) + share
        if partial[gid] >= 1.0 - 1e-9:
            del partial[gid]
            free.append(gid)
    else:
        free.extend(ids)


class _Bundle:
    """One reserved placement-group bundle on this node (reference:
    `src/ray/raylet/placement_group_resource_manager.h` — prepared bundles
    hold node resources; commit makes them leasable; return releases).
    Its GPU ids come from the node's pool: `gpu_ids` are the ids it owns,
    `chips`/`gpu_partial` the part of them no lease holds now."""

    def __init__(self, resources: Dict[str, float], gpu_ids: List[int],
                 share: float):
        self.total = dict(resources)
        self.available = dict(resources)
        self.gpu_ids = list(gpu_ids)
        self.chips: List[int] = [] if share else list(gpu_ids)
        self.gpu_partial: Dict[int, float] = (
            {gpu_ids[0]: share} if share else {})
        self.committed = False
        self.removed = False
        self.prepared_at = time.monotonic()
        self.committed_at = 0.0  # set by handle_commit_bundle

    def in_use(self) -> Dict[str, float]:
        return {k: self.total[k] - self.available.get(k, 0.0)
                for k in self.total
                if self.total[k] - self.available.get(k, 0.0) > 1e-9}


class NodeLedger:
    """Per-node resource accounting + placement-group 2PC + the
    spillback policy — the scheduling brain of a raylet, factored out of
    the process machinery (workers, object store, sockets).

    Consumers provide: `node_id`, `resources_total`,
    `resources_available`, `_bundles` ({key: _Bundle}), `_chips_free`
    and `_gpu_partial` (the node's GPU pool), `_cluster_view`
    ({node_id: node info}), and `_gcs` (a GcsClient) for bundle
    reconciliation."""

    # The bundle reconcile's period, and how long a committed bundle may
    # wait for its group to reach CREATED before it is returned.
    PG_RECONCILE_INTERVAL_S = 5.0
    PG_STUCK_COMMIT_S = 60.0
    # throttles _maybe_reconcile_bundles; instance attr once it runs
    _last_bundle_reconcile = 0.0

    def _fits(self, avail: Dict[str, float],
              demand: Dict[str, float]) -> bool:
        return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())

    def _acquire(self, demand: Dict[str, float]) -> None:
        for k, v in demand.items():
            self.resources_available[k] = self.resources_available.get(
                k, 0.0) - v

    def _release(self, demand: Dict[str, float]) -> None:
        for k, v in demand.items():
            self.resources_available[k] = min(
                self.resources_available.get(k, 0.0) + v,
                self.resources_total.get(k, v))

    def _pick_spillback(self, demand: Dict[str, float]) -> Optional[str]:
        """Best remote node that can host the demand now (spread by most
        available, the scorer's tie-break in the reference)."""
        best, best_score = None, -1.0
        for node_id, info in self._cluster_view.items():
            if node_id == self.node_id or not info.get("alive"):
                continue
            avail = info.get("resources_available", {})
            if not self._fits(avail, demand):
                continue
            score = sum(avail.get(k, 0.0) for k in ("CPU", "GPU"))
            if score > best_score:
                best, best_score = info["address"], score
        return best

    def _feasible_locally(self, demand: Dict[str, float]) -> bool:
        return self._fits(self.resources_total, demand)

    def _maybe_spillback(self, demand: Dict[str, float],
                         spillback_count: int) -> Optional[str]:
        """Hybrid policy (hybrid_scheduling_policy.h): pack locally
        while below the spread threshold; above it — or when local
        can't fit — spill to a viable remote. The spillback chain is
        bounded so two saturated raylets with stale views of each
        other can't ping-pong a lease forever. One helper shared by
        the single and batched lease handlers, so the policy cannot
        diverge between them."""
        if spillback_count >= 2:
            return None
        local_fits = self._fits(self.resources_available, demand)
        utilization = 1.0 - (
            self.resources_available.get("CPU", 0.0)
            / max(self.resources_total.get("CPU", 1.0), 1e-9))
        if (not local_fits or utilization
                > ray_config().scheduler_spread_threshold):
            return self._pick_spillback(demand)
        return None

    # ------------------------------------------------------------------
    # placement-group bundles: 2PC reserve/commit/return (reference:
    # node_manager.cc:1821 HandlePrepareBundleResources, :1837
    # HandleCommitBundleResources + placement_group_resource_manager.h)
    # ------------------------------------------------------------------
    async def handle_prepare_bundle(self, conn: ServerConnection, *,
                                    pg_id: str, bundle_index: int,
                                    resources: Dict[str, float]
                                    ) -> Dict[str, Any]:
        key = f"{pg_id}:{bundle_index}"
        if key in self._bundles and not self._bundles[key].removed:
            return {"ok": True}  # idempotent re-prepare
        demand = {k: float(v) for k, v in resources.items() if v}
        if not self._fits(self.resources_available, demand):
            return {"ok": False,
                    "reason": f"insufficient resources for bundle {key}: "
                              f"need {demand}, have "
                              f"{self.resources_available}"}
        gpus = demand.get("GPU", 0.0)
        if not _gpus_fit(self._chips_free, self._gpu_partial, gpus):
            return {"ok": False,
                    "reason": f"no GPU instances for bundle {key}: need "
                              f"{gpus}, free {self._chips_free}, shared "
                              f"{self._gpu_partial}"}
        self._acquire(demand)
        ids, share = _take_gpus(self._chips_free, self._gpu_partial, gpus)
        self._bundles[key] = _Bundle(demand, ids, share)
        return {"ok": True}

    async def handle_commit_bundle(self, conn: ServerConnection, *,
                                   pg_id: str, bundle_index: int) -> bool:
        b = self._bundles.get(f"{pg_id}:{bundle_index}")
        if b is None or b.removed:
            return False
        b.committed = True
        b.committed_at = time.monotonic()
        return True

    async def handle_return_bundle(self, conn: ServerConnection, *,
                                   pg_id: str, bundle_index: int) -> bool:
        return self._return_bundle(f"{pg_id}:{bundle_index}")

    def _return_bundle(self, key: str) -> bool:
        b = self._bundles.get(key)
        if b is None or b.removed:
            return False
        # Unused share back to the pool now; b.total shrinks to the in-use
        # share, which drains back as each outstanding lease ends
        # (_release_lease_resources) — empty total deletes the entry.
        b.removed = True
        self._release(b.available)
        _give_gpus(self._chips_free, self._gpu_partial, b.chips, 0.0)
        for gid, share in b.gpu_partial.items():
            _give_gpus(self._chips_free, self._gpu_partial, [gid], share)
        b.total = b.in_use()
        b.available = {}
        b.chips = []
        b.gpu_partial = {}
        if not b.total:
            del self._bundles[key]
        return True

    def _reap_stale_prepares(self) -> None:
        """Drop prepared-but-never-committed bundles (owner died between
        the 2PC phases) so their reservations don't leak."""
        cutoff = time.monotonic() - 30.0
        for key, b in list(self._bundles.items()):
            if not b.committed and not b.removed and b.prepared_at < cutoff:
                logger.warning("returning stale uncommitted bundle %s", key)
                self._return_bundle(key)

    async def _maybe_reconcile_bundles(self) -> None:
        """Return committed bundles whose placement group the GCS no
        longer stands behind — the cluster-wide rollback that a crash
        anywhere in the 2PC (owner mid-commit, GCS mid-CAS, another
        raylet mid-prepare) cannot perform itself. _reap_stale_prepares
        covers the reserve phase; this covers the commit phase:

        - group REMOVED / INFEASIBLE / unknown -> the reservation is a
          leak, return it now;
        - group still not CREATED `PG_STUCK_COMMIT_S` after our commit
          -> the owner died between commit and the CREATED CAS, return.

        Throttled to one GCS round trip per `PG_RECONCILE_INTERVAL_S`;
        a GCS outage skips the pass (no false rollbacks on 'unknown
        because unreachable')."""
        committed = {key.split(":", 1)[0]
                     for key, b in self._bundles.items()
                     if b.committed and not b.removed}
        if not committed:
            return
        now = time.monotonic()
        if now - self._last_bundle_reconcile < self.PG_RECONCILE_INTERVAL_S:
            return
        self._last_bundle_reconcile = now
        for pg_id in committed:
            try:
                info = await self._gcs.get_placement_group(pg_id)
            except Exception:
                return  # control plane unreachable: judge nothing
            state = (info or {}).get("state")
            if state == "CREATED":
                # The group stands — but only behind the bundles its
                # location table names. A commit that landed here during
                # a crashed GCS reschedule pass whose final CAS chose a
                # DIFFERENT node is an orphan reservation: nothing will
                # ever lease or return it.
                locs = (info or {}).get("bundle_locations") or []
                for key, b in list(self._bundles.items()):
                    if (not key.startswith(pg_id + ":") or not b.committed
                            or b.removed):
                        continue
                    try:
                        idx = int(key.rsplit(":", 1)[1])
                    except ValueError:
                        continue
                    if (idx < len(locs)
                            and locs[idx].get("node_id") != self.node_id
                            and now - getattr(b, "committed_at", now)
                            >= self.PG_STUCK_COMMIT_S):
                        # The commit-age grace mirrors the PENDING
                        # branch: a FRESH mislocated commit is most
                        # likely an in-flight reschedule pass that
                        # prepared+committed here while our CREATED
                        # read was already in flight (stale snapshot)
                        # — returning it would strand the location
                        # table the pass is about to write. A genuine
                        # crash orphan persists past the window and
                        # still comes back.
                        logger.warning(
                            "returning bundle %s committed here but "
                            "located on %s (rescheduled elsewhere)",
                            key, locs[idx].get("node_id"))
                        from ray_tpu_torch.core import flight

                        if flight.enabled:
                            flight.instant("pg", "pg.rollback", arg=key)
                        self._return_bundle(key)
                continue
            if state == "RESCHEDULING":
                # A member node died and the GCS is re-placing the LOST
                # bundles; surviving reservations (ours) must hold — a
                # rollback here would be the capacity the group still
                # legitimately owns. The rescheduler's terminal CAS
                # (back to CREATED) re-enables the location check above.
                continue
            if state == "PENDING":
                if any(now - getattr(b, "committed_at", now)
                       < self.PG_STUCK_COMMIT_S
                       for key, b in self._bundles.items()
                       if key.startswith(pg_id + ":") and b.committed
                       and not b.removed):
                    continue  # owner may still be driving the 2PC
                # Expire the group ATOMICALLY before touching the
                # ledger: a slow-but-live owner may be racing us toward
                # its CREATED CAS, and returning the bundle first would
                # manufacture a half-reserved CREATED group. Whoever
                # wins the PENDING CAS defines the outcome — if the
                # owner just won, our CAS misses and we keep the
                # reservation; if we win, the owner's CREATED CAS
                # misses and it rolls back cleanly.
                try:
                    won = await self._gcs.update_placement_group(
                        pg_id, {"state": "INFEASIBLE",
                                "detail": "committed bundle expired "
                                          "waiting for CREATED "
                                          f"(> {self.PG_STUCK_COMMIT_S}s)"},
                        expect_state="PENDING")
                except Exception:
                    return  # control plane unreachable: judge nothing
                if not won:
                    continue  # owner terminated it; re-judge next pass
            for key, b in list(self._bundles.items()):
                if (key.startswith(pg_id + ":") and b.committed
                        and not b.removed):
                    logger.warning(
                        "returning orphaned committed bundle %s "
                        "(group state=%s)", key, state)
                    from ray_tpu_torch.core import flight

                    if flight.enabled:
                        flight.instant("pg", "pg.rollback", arg=key)
                    self._return_bundle(key)


class _PendingLease:
    def __init__(self, demand: Dict[str, float], is_actor: bool,
                 scheduling_key: str,
                 bundle_key: Optional[str] = None,
                 request_id: Optional[str] = None,
                 spillback_count: int = 0,
                 job_id: Optional[str] = None):
        self.demand = demand
        self.is_actor = is_actor
        self.scheduling_key = scheduling_key
        self.bundle_key = bundle_key
        self.request_id = request_id
        self.spillback_count = spillback_count
        self.job_id = job_id
        self.conn: Optional[ServerConnection] = None
        self.created_at = time.monotonic()
        self.future: asyncio.Future = asyncio.get_event_loop().create_future()


class _PullManager:
    """Admission control for inbound object transfers (reference:
    `object_manager/pull_manager.h:52` — pulls activate under a byte
    budget, the rest queue). Smallest-first wake order: a giant transfer
    must not head-of-line-block the small objects a blocked `get` needs.
    """

    def __init__(self, budget_bytes: int):
        import heapq as _hq  # noqa: F401  (documents the waiter heap)

        self.budget = max(1, int(budget_bytes))
        self.in_use = 0
        self._waiters: list = []   # heap of (size, seq, Event)
        self._seq = 0
        # local_reads counts node-local resolutions that bypassed
        # admission entirely: the byte budget exists to pace inbound
        # REMOTE transfers, and a local shm read must never queue behind
        # them (nor charge the budget) — pinned by
        # tests/test_unit_pull_manager.py.
        self.stats = {"admitted": 0, "queued": 0, "peak_bytes": 0,
                      "active": 0, "local_reads": 0}

    async def admit(self, size: int) -> int:
        """Blocks until `size` bytes of transfer budget are granted.
        Returns the granted size (a single object larger than the whole
        budget is clamped: it transfers alone, not never)."""
        import heapq

        size = min(int(size), self.budget)
        # Purge cancelled waiters first: with nothing in flight there is
        # no future release() to sweep them, and a live heap of only
        # dead entries must not push new admits onto the queue forever.
        while self._waiters and not self._waiters[0][3][0]:
            heapq.heappop(self._waiters)
        if not self._waiters and self.in_use + size <= self.budget:
            self.in_use += size
        else:
            ev = asyncio.Event()
            # Mutable liveness flag: a cancelled waiter marks itself
            # dead so the wake loop skips it WITHOUT charging in_use —
            # a leaked charge here permanently shrinks the pull budget
            # (ADVICE r5 low).
            entry = (size, self._seq + 1, ev, [True])
            self._seq += 1
            heapq.heappush(self._waiters, entry)
            self.stats["queued"] += 1
            try:
                await ev.wait()
            except asyncio.CancelledError:
                if ev.is_set():
                    # Granted between the wake and this resumption: the
                    # bytes were already charged — return them (and wake
                    # anyone they now fit).
                    self._return_bytes(size)
                else:
                    entry[3][0] = False  # still queued: mark dead
                raise
        self.stats["admitted"] += 1
        self.stats["active"] += 1
        self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                       self.in_use)
        return size

    def _return_bytes(self, size: int) -> None:
        import heapq

        self.in_use -= size
        while self._waiters:
            wsize, _, ev, alive = self._waiters[0]
            if not alive[0]:
                heapq.heappop(self._waiters)  # cancelled: drop, no charge
                continue
            if self.in_use + wsize > self.budget:
                break
            heapq.heappop(self._waiters)
            self.in_use += wsize
            ev.set()

    def release(self, size: int) -> None:
        self.stats["active"] -= 1
        self._return_bytes(size)


class Raylet(NodeLedger):
    def __init__(self, *, node_id: str, gcs_address: str,
                 resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 object_store_memory: Optional[int] = None,
                 is_head: bool = False):
        self.node_id = node_id
        self.gcs_address = gcs_address
        self.is_head = is_head
        self.labels = labels or {}
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self._rpc = RpcServer(self, host, port)
        self._gcs = GcsClient(gcs_address)
        self.store = make_store(
            object_store_memory or ray_config().object_store_memory_bytes,
            node_id=node_id)
        self._workers: Dict[str, _Worker] = {}
        self._idle: List[_Worker] = []
        self._pending: List[_PendingLease] = []
        # PG bundles reserved on this node, keyed "pg_id:bundle_index".
        self._bundles: Dict[str, _Bundle] = {}
        # Per-instance GPU ids (reference: resource_instance_set.h):
        # wholly free ones in grant order, and the free fraction of each
        # instance that fractional leases share.
        self._chips_free: List[int] = list(
            range(int(resources.get("GPU", 0))))
        self._gpu_partial: Dict[int, float] = {}
        self._next_lease = 0
        self._cluster_view: Dict[str, Dict[str, Any]] = {}
        self._raylet_clients: Dict[str, RpcClient] = {}
        self._worker_clients: Dict[str, RpcClient] = {}
        self._tasks: List[asyncio.Task] = []
        self._monitors: Dict[str, asyncio.Task] = {}
        # worker_id -> (monotonic push time, app-metric snapshot)
        self._worker_metrics: Dict[str, tuple] = {}
        # lease request_id -> [(lease_id, worker_id), ...], for cancel-
        # after-grant (a client that timed out must not leak the
        # worker); list-valued since one batched request can grant
        # several leases under the same request_id.
        self._recent_grants: Dict[str, list] = {}
        # live lease_id -> (worker_id, granting connection): a client
        # that dies (not merely times out) can never use or return its
        # grants, so disconnect reclaims them.
        self._lease_conns: Dict[str, tuple] = {}
        # At-least-once protection for the lease plane (round 15 chaos):
        # a duplicated/retried request_worker_lease(s) must be served
        # the ORIGINAL grant reply, never a second worker. Grant replies
        # cache by request_id (spillback/error replies are not cached —
        # re-deciding them acquires nothing and a cached spillback
        # could pin a client to a dead verdict forever); concurrent
        # duplicates share the in-flight future.
        self._lease_reply_cache: Dict[str, Dict[str, Any]] = {}
        self._lease_inflight: Dict[str, asyncio.Future] = {}
        # request_ids the client cancelled: a cancel can land BETWEEN
        # the grant (recorded in _recent_grants, future resolved) and
        # the handler coroutine resuming to cache its reply — caching
        # then would serve a later duplicate a grant whose workers the
        # cancel already reclaimed (and possibly re-leased).
        self._cancelled_lease_requests: Dict[str, None] = {}
        self._stopping = False
        # worker_id -> why the raylet killed it ("oom"); lets the task
        # submitter surface a typed retriable OutOfMemoryError instead of
        # a generic crash (reference: worker_killing_policy.h + the
        # OOM-kill task-failure reason in node_manager.cc).
        self._death_causes: Dict[str, str] = {}
        # Object-manager flow control (reference: pull_manager.h
        # admission under a byte budget; push_manager.h bounded
        # concurrent outbound chunks).
        self._pulls = _PullManager(ray_config().object_pull_budget_bytes)
        self._inflight_pulls: Dict[str, asyncio.Future] = {}
        # Extra flight-record sources on this node beyond spawned
        # workers: DRIVER processes register their RPC address here so
        # the dashboard's merged timeline/stall views cover the submit
        # side too (pruned when a scrape finds the process gone).
        self._flight_sources: Dict[str, float] = {}
        self._push_sem: Optional[asyncio.Semaphore] = None
        self._push_waiters = 0
        # Metrics pipeline (round 17): workers' delta batches queue here
        # (already worker/role-labeled) until the next heartbeat folds
        # them — with the raylet's own runtime gauges — into the ONE
        # coalesced `metrics=` payload piggybacked on that heartbeat.
        # Bounded like the per-process ring; cleared only on GCS ack.
        from ray_tpu_torch.core import metrics_ts

        self._metrics_pending: List[Dict[str, Any]] = []
        self._ts_recorder = metrics_ts.Recorder(
            capacity=ray_config().metrics_ts_ring)
        self._last_ts_capture = 0.0
        self._metrics_pushes = 0       # heartbeats that carried metrics
        self._metrics_hb_intervals = 0  # heartbeat-loop iterations

    @property
    def address(self) -> str:
        return self._rpc.address

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        await self._rpc.start()
        # Flight recorder (round 12): GC pauses + loop lag on the
        # raylet's own event loop become attributable events; its
        # dump_flight_record handler fans out to the node's workers.
        from ray_tpu_torch.core import flight

        if not ray_config().flight_recorder:
            flight.enabled = False
        if flight.enabled:
            flight.configure(
                capacity=ray_config().flight_events,
                stall_threshold_ms=ray_config().stall_threshold_ms,
                heartbeat_ms=ray_config().flight_heartbeat_ms)
            flight.set_role("raylet", node_id=self.node_id)
            flight.install_gc_hook()
            self._flight_watch = flight.watch_loop(
                asyncio.get_running_loop(), name="raylet-loop")
        else:
            self._flight_watch = None
        await self._gcs.connect()
        await self._register_with_gcs()
        await self._gcs.subscribe("node", self._on_node_update)
        await self._gcs.subscribe("job", self._on_job_update)
        self._tasks.append(asyncio.ensure_future(self._heartbeat_loop()))
        if ray_config().memory_monitor_refresh_ms > 0:
            self._tasks.append(asyncio.ensure_future(
                self._memory_monitor_loop()))
        self._tasks.append(asyncio.ensure_future(self._log_monitor_loop()))
        # Prestart a few workers so first-task latency is registration-bound,
        # not fork/exec-bound (reference: PrestartWorkers,
        # node_manager.cc:1782).
        for _ in range(min(int(self.resources_total.get("CPU", 1)), 4)):
            self._spawn_worker()
        logger.info("raylet %s listening on %s", self.node_id[:8],
                    self.address)

    async def stop(self) -> None:
        # Gate worker (re)spawning first: a leased worker dying mid-stop
        # otherwise triggers _try_dispatch -> _spawn_worker, and the fresh
        # worker outlives us stuck in a connect-retry loop (orphan).
        self._stopping = True
        if getattr(self, "_flight_watch", None) is not None:
            from ray_tpu_torch.core import flight

            flight.unwatch_loop(self._flight_watch)
        for t in self._tasks + list(self._monitors.values()):
            t.cancel()
        for w in self._workers.values():
            if w.proc.poll() is None:
                w.proc.terminate()
        # One shared grace window for the whole pool: the supervisor
        # SIGKILLs *us* after ~3 s, and any worker still alive at that
        # point would be orphaned — so escalate to SIGKILL well inside
        # that budget rather than waiting per worker.
        deadline = time.monotonic() + 1.5
        for w in self._workers.values():
            try:
                w.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except Exception:
                w.proc.kill()
        self.store.shutdown()
        await self._rpc.stop()
        await self._gcs.close()
        # Final sweep: anything that slipped in between the first loop and
        # the RPC server going down dies hard.
        for w in self._workers.values():
            if w.proc.poll() is None:
                w.proc.kill()

    async def _register_with_gcs(self) -> None:
        reply = await self._gcs.register_node(
            node_id=self.node_id, address=self.address,
            object_store_address=self.address,
            resources=self.resources_total, labels=self.labels,
            is_head=self.is_head)
        if (reply or {}).get("was_dead"):
            # The cluster declared us dead (transient partition) and has
            # already restarted our actors / reconstructed our objects
            # elsewhere. Surviving actor workers here are stale replicas
            # holding chips and CPUs — reap them before resuming.
            logger.warning("re-registered after being declared dead; "
                           "reaping stale actor workers")
            for worker in list(self._workers.values()):
                if worker.actor_id and worker.proc.poll() is None:
                    worker.proc.terminate()

    def _fold_metrics_batch(self) -> Optional[list]:
        """The node's coalesced pipeline payload for this heartbeat:
        the raylet's own runtime gauges (captured at the report
        interval, delta-encoded through the same Recorder workers use)
        plus every queued worker batch. None = nothing to push."""
        from ray_tpu_torch.core import metrics_ts

        if not (metrics_ts.enabled and ray_config().metrics_pipeline):
            return None
        now = time.monotonic()
        if (now - self._last_ts_capture
                >= ray_config().metrics_report_interval_ms / 1000.0):
            self._last_ts_capture = now
            try:
                self._ts_recorder.capture(self._runtime_metrics())
            except Exception:
                logger.warning("runtime metrics capture failed",
                               exc_info=True)
        own = self._ts_recorder.pending()
        if not own and not self._metrics_pending:
            return None
        batch = [{"t": e["t"],
                  "series": [[it[0], it[1], dict(it[2], role="raylet")]
                             + list(it[3:]) for it in e["series"]]}
                 for e in own]
        batch.extend(self._metrics_pending)
        # Remember what was shipped so only THAT is acked — workers may
        # append more while the heartbeat RPC is in flight.
        self._metrics_sent = (len(own), len(self._metrics_pending))
        return batch

    def _ack_metrics_batch(self) -> None:
        n_own, n_workers = getattr(self, "_metrics_sent", (0, 0))
        self._ts_recorder.ack(n_own)
        del self._metrics_pending[:n_workers]
        self._metrics_pushes += 1

    async def _heartbeat_loop(self) -> None:
        period = ray_config().raylet_heartbeat_period_ms / 1000.0
        last_view = 0.0
        while True:
            try:
                metrics_batch = self._fold_metrics_batch()
                self._metrics_hb_intervals += 1
                # Batched worker state (ROADMAP 4d): the whole worker
                # table rides the node heartbeat — one RPC per raylet
                # tick, never one per worker — so at N=1000 the GCS
                # dispatch rate stays O(nodes), not O(workers), and
                # worker churn stays off the HA quorum write path.
                worker_batch = [
                    {"worker_id": w.worker_id, "state": w.state,
                     "actor_id": w.actor_id, "lease_id": w.lease_id}
                    for w in self._workers.values()
                    if w.state != "dead"]
                ok = await self._gcs.heartbeat(
                    self.node_id, self.resources_available,
                    load={"pending": len(self._pending),
                          # Demand shapes drive the autoscaler's
                          # bin-packing (reference: load metrics'
                          # resource_load_by_shape).
                          "pending_demands": [dict(p.demand) for p in
                                              self._pending[:100]]},
                    metrics=metrics_batch,
                    workers=worker_batch)
                if ok is True and metrics_batch:
                    # Clear-on-ack: a failed/unrecognized heartbeat
                    # leaves the batch queued for the next interval.
                    self._ack_metrics_batch()
                if ok is False:
                    # GCS restarted (nodes aren't persisted) or declared
                    # us dead: re-register so scheduling resumes (GCS FT
                    # re-registration contract).
                    logger.info("GCS does not recognize this node; "
                                "re-registering")
                    await self._register_with_gcs()
                # Cluster-view refresh is throttled SEPARATELY from the
                # liveness heartbeat: fetching the full node table per
                # beat is O(N^2) records/s across the fleet and was the
                # GCS dispatch wall at 1000 simulated nodes (PROFILE
                # round 11). Spillback/dead-address consumers tolerate
                # a stale view — their retry discipline re-resolves.
                now = time.monotonic()
                if (now - last_view
                        >= ray_config().cluster_view_refresh_ms / 1000.0):
                    self._cluster_view = {
                        n["node_id"]: n
                        for n in await self._gcs.get_nodes()}
                    last_view = now
            except Exception:
                logger.warning("heartbeat to GCS failed", exc_info=True)
            self._reap_stale_prepares()
            try:
                await self._maybe_reconcile_bundles()
            except Exception:
                logger.warning("bundle reconcile failed", exc_info=True)
            self._spill_infeasible_pending()
            await asyncio.sleep(period)

    # -- OOM defense (reference: memory_monitor.h:52 +
    # worker_killing_policy.h:34) ---------------------------------------
    def _oom_candidates(self):
        from ray_tpu_torch.core.memory_monitor import WorkerCandidate

        out = []
        for w in self._workers.values():
            if w.proc.poll() is not None or w.state not in ("leased",
                                                            "actor"):
                continue
            conn = None
            if w.lease_id is not None:
                pair = self._lease_conns.get(w.lease_id)
                conn = pair[1].conn_id if pair else None
            out.append(WorkerCandidate(
                worker_id=w.worker_id, pid=w.proc.pid,
                task_id=w.actor_id or w.lease_id,
                owner_address=(f"actor:{w.actor_id}" if w.actor_id
                               else f"conn:{conn}"),
                granted_at=w.granted_at,
                # Plain leased tasks are retriable (the submitter's
                # retry loop re-runs them); actors restart through
                # their own max_restarts machinery — last resort.
                retriable=w.actor_id is None))
        return out

    async def _memory_monitor_loop(self) -> None:
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor

        cfg = ray_config()
        monitor = MemoryMonitor(cfg.memory_usage_threshold,
                                self._oom_candidates)
        period = cfg.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                victim = monitor.tick()
            except Exception:
                logger.warning("memory monitor tick failed",
                               exc_info=True)
                continue
            if victim is None:
                continue
            worker = self._workers.get(victim.worker_id)
            if worker is not None and worker.proc.poll() is None:
                self._death_causes[worker.worker_id] = "oom"
                while len(self._death_causes) > 256:
                    self._death_causes.pop(next(iter(self._death_causes)))
                worker.proc.kill()  # _monitor_worker reclaims the lease

    async def handle_worker_death_cause(self, conn: ServerConnection, *,
                                        worker_id: str) -> Optional[str]:
        return self._death_causes.get(worker_id)

    # -- worker log streaming (reference: _private/log_monitor.py:103
    # tails per-worker files and publishes over GCS pubsub; drivers
    # print via _private/worker.py:812) ---------------------------------
    def _collect_new_log_lines(self) -> List[Dict[str, Any]]:
        entries = []
        for w in self._workers.values():
            if not w.log_path:
                continue
            try:
                size = os.path.getsize(w.log_path)
                if size <= w.log_offset:
                    continue
                with open(w.log_path, "rb") as f:
                    f.seek(w.log_offset)
                    chunk = f.read(min(size - w.log_offset, 1 << 20))
            except OSError:
                continue
            # Ship whole lines only; a partial trailing line waits for
            # its newline (next tick). A full 1 MiB chunk with no newline
            # is a pathological line: ship it truncated rather than
            # re-reading the same megabyte forever.
            cut = chunk.rfind(b"\n")
            if cut < 0:
                if len(chunk) < (1 << 20):
                    continue
                cut = len(chunk) - 1
            w.log_offset += cut + 1
            lines = chunk[:cut].decode("utf-8", "replace").splitlines()
            if len(lines) > 200:
                dropped = len(lines) - 200
                lines = [f"... [{dropped} lines truncated by the log "
                         f"monitor]"] + lines[-200:]
            if lines:
                entries.append({
                    "worker_id": w.worker_id, "pid": w.proc.pid,
                    "actor_id": w.actor_id,
                    # Tag with the job the worker serves so a driver
                    # only prints ITS workers (cross-driver isolation).
                    "job_id": w.actor_job_id or w.lease_job_id,
                    "lines": lines,
                })
        return entries

    async def handle_get_worker_logs(self, conn: ServerConnection, *,
                                     worker: Optional[str] = None,
                                     tail_bytes: int = 16384
                                     ) -> List[Dict[str, Any]]:
        """Log aggregation read path (dashboard `/api/logs`): the tail
        of each worker's log file on THIS node, newest bytes first cut
        to whole lines. `worker` filters by worker-id prefix. Distinct
        from the streaming monitor: this reads on demand from offset
        zero of the tail, so lines already shipped to drivers are still
        inspectable."""
        out: List[Dict[str, Any]] = []
        budget = max(1024, min(int(tail_bytes), 1 << 20))
        for w in list(self._workers.values()):
            if worker and not w.worker_id.startswith(worker):
                continue
            if not w.log_path:
                continue
            try:
                size = os.path.getsize(w.log_path)
                with open(w.log_path, "rb") as f:
                    f.seek(max(0, size - budget))
                    chunk = f.read(budget)
            except OSError:
                continue
            if size > budget:
                # Drop the partial first line of a mid-file seek.
                cut = chunk.find(b"\n")
                chunk = chunk[cut + 1:] if cut >= 0 else chunk
            out.append({
                "node_id": self.node_id,
                "worker_id": w.worker_id,
                "pid": w.proc.pid,
                "actor_id": w.actor_id,
                "job_id": w.actor_job_id or w.lease_job_id,
                "path": w.log_path,
                "lines": chunk.decode("utf-8", "replace").splitlines(),
            })
        return out

    async def handle_register_flight_source(
            self, conn: ServerConnection, *, address: str) -> bool:
        """A driver on this node announces its RPC address so
        `dump_flight_record` fans out to it too — workers are known
        from registration, but drivers otherwise never appear in the
        merged timeline (and a driver-loop stall is exactly the kind
        of episode the dashboard must show)."""
        self._flight_sources[address] = time.monotonic()
        return True

    async def handle_dump_flight_record(
            self, conn: ServerConnection, *,
            window_s: Optional[float] = None,
            include_events: bool = True) -> Dict[str, Any]:
        """Node-level flight-record collection (dashboard
        `/api/timeline` + `/api/stalls`, mirror of `get_worker_logs`):
        this raylet's own ring plus, over the same RPC name, every
        live worker's and registered driver's — concurrent fan-out
        with a short per-process timeout, so one wedged process (the
        very thing being debugged) cannot stall the endpoint for the
        rest of the node."""
        from ray_tpu_torch.core import flight

        records: List[Dict[str, Any]] = [
            flight.dump(window_s=window_s,
                        include_events=include_events)]

        async def one(address: str, prune: bool = False):
            try:
                client = await self._worker_client(address)
                return await client.call(
                    "dump_flight_record", window_s=window_s,
                    include_events=include_events, timeout=5.0)
            except Exception:  # noqa: BLE001 — dead/wedged process
                if prune:
                    self._flight_sources.pop(address, None)
                return None

        targets = [one(w.address) for w in self._workers.values()
                   if w.address and w.proc.poll() is None]
        targets += [one(addr, prune=True)
                    for addr in list(self._flight_sources)]
        results = await asyncio.gather(*targets)
        records.extend(r for r in results if isinstance(r, dict))
        return {"node_id": self.node_id, "records": records}

    async def _log_monitor_loop(self) -> None:
        interval = ray_config().log_monitor_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                entries = self._collect_new_log_lines()
                if entries:
                    await self._gcs.publish(
                        "worker_logs",
                        {"node_id": self.node_id, "entries": entries})
            except Exception:
                logger.debug("log monitor tick failed", exc_info=True)

    # A lease queued this long on a locally-feasible-but-busy node gets
    # re-spilled to a remote with room (reference: the cluster task
    # manager re-evaluates queued work against the cluster view; without
    # this, an unlucky spillback distribution strands a lease behind a
    # full node while a sibling node sits idle).
    QUEUE_RESPILL_AFTER_S = 2.0

    def _spill_infeasible_pending(self) -> None:
        """Queued leases this node can never satisfy get redirected once
        the refreshed cluster view shows a viable remote; feasible ones
        that have waited past QUEUE_RESPILL_AFTER_S re-spill too; others
        wait, with a periodic diagnostic (reference: the cluster task
        manager's 'cannot be scheduled' warning)."""
        now = time.monotonic()
        for pending in list(self._pending):
            if self._feasible_locally(pending.demand):
                if pending.spillback_count >= 2:
                    # Anti-ping-pong: a busy-node lease that already
                    # bounced twice settles where it is. (Locally
                    # INFEASIBLE leases are exempt — this node can never
                    # run them, so redirecting is their only way out.)
                    continue
                if now - pending.created_at < self.QUEUE_RESPILL_AFTER_S:
                    continue
                if self._fits(self.resources_available, pending.demand):
                    # Resources are free — we're only waiting on a worker
                    # to finish cold-spawning; re-spilling would strand
                    # it and bounce the lease around the cluster.
                    continue
            remote = self._pick_spillback(pending.demand)
            if remote is not None and not pending.future.done():
                self._pending.remove(pending)
                pending.future.set_result({"spillback": remote})
            elif now - getattr(pending, "last_warn", 0.0) > 10.0:
                pending.last_warn = now
                logger.warning(
                    "lease demand %s cannot be scheduled: no node in the "
                    "cluster has these resources (waiting for the cluster "
                    "to change)", pending.demand)

    def _on_node_update(self, data) -> None:
        if not data.get("alive"):
            from ray_tpu_torch.core import flight

            if flight.enabled:
                # Mirrors the GCS-side node.dead event into a process
                # the dashboard's timeline fan-out actually scrapes.
                flight.instant("node", "node.dead",
                               arg=(data.get("node_id") or "")[:8])
            self._cluster_view.pop(data.get("node_id"), None)

    def _on_job_update(self, data) -> None:
        """Job finished: reap local non-detached actor workers of that
        job (reference: GcsActorManager::OnJobFinished ->
        KillActor on the owning node)."""
        if not data.get("finished"):
            return
        job_id = data.get("job_id")
        for worker in list(self._workers.values()):
            if (worker.actor_id and worker.actor_job_id == job_id
                    and not worker.actor_detached
                    and worker.proc.poll() is None):
                logger.info("reaping actor worker %s (job %s finished)",
                            worker.worker_id[:8], (job_id or "")[:8])
                worker.proc.terminate()

    # ------------------------------------------------------------------
    # worker pool (reference: worker_pool.h)
    # ------------------------------------------------------------------
    def _spawn_worker(self) -> Optional[_Worker]:
        if self._stopping:
            return None
        import uuid

        worker_id = uuid.uuid4().hex
        env = dict(os.environ)
        env["RAY_TPU_NODE_ID"] = self.node_id
        # Unbuffered stdio: a task's print() must reach the log file (and
        # the driver, via the log monitor) while the task runs, not when
        # the worker exits.
        env["PYTHONUNBUFFERED"] = "1"
        # No card until a GPU lease sets this worker's ids (before any
        # CUDA initialisation; see cluster_runtime._apply_visible_chips).
        env["CUDA_VISIBLE_DEVICES"] = ""
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.worker_main",
               "--raylet", self.address, "--gcs", self.gcs_address,
               "--worker-id", worker_id, "--node-id", self.node_id]
        # Workers ALWAYS log to a file: the log monitor tails these and
        # streams lines to drivers (reference: log_monitor.py:103).
        log_dir = os.environ.get("RAY_TPU_LOG_DIR")
        if not log_dir:
            import tempfile

            log_dir = os.path.join(
                tempfile.gettempdir(),
                f"ray_tpu_torch_worker_logs_{self.node_id[:8]}")
            os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{worker_id[:8]}.log")
        out = open(log_path, "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=out)
        out.close()  # the child holds the fd; the tailer reopens by path
        worker = _Worker(worker_id, proc)
        worker.log_path = log_path
        self._workers[worker_id] = worker
        self._monitors[worker_id] = asyncio.ensure_future(
            self._monitor_worker(worker))
        return worker

    async def _monitor_worker(self, worker: _Worker) -> None:
        while worker.proc.poll() is None:
            await asyncio.sleep(0.2)
        code = worker.proc.returncode
        if worker.state != "dead":
            worker.state = "dead"
            if worker in self._idle:
                self._idle.remove(worker)
            if worker.held:
                self._release_lease_resources(worker)
                self._try_dispatch()
            if worker.actor_id:
                try:
                    await self._gcs.update_actor(worker.actor_id, {
                        "state": "DEAD",
                        "death_cause": f"worker exited with code {code}",
                    })
                except Exception:
                    pass
            logger.info("worker %s exited with code %s",
                        worker.worker_id[:8], code)

    async def handle_register_worker(self, conn: ServerConnection, *,
                                     worker_id: str, address: str) -> bool:
        worker = self._workers.get(worker_id)
        if worker is None:
            return False
        worker.address = address
        worker.state = "idle"
        worker.ready.set()
        self._idle.append(worker)
        conn.metadata["worker_id"] = worker_id
        self._try_dispatch()
        return True

    # ------------------------------------------------------------------
    # leasing + scheduling (reference: node_manager.cc:1767 +
    # cluster_task_manager.h:70 + hybrid_scheduling_policy.h:50)
    # ------------------------------------------------------------------
    async def handle_request_worker_lease(
            self, conn: ServerConnection, *,
            req: Optional[dict] = None,
            resources: Optional[Dict[str, float]] = None,
            scheduling_key: str = "", is_actor: bool = False,
            spillback_count: int = 0,
            bundle: Optional[List[Any]] = None,
            request_id: Optional[str] = None,
            job_id: Optional[str] = None) -> Dict[str, Any]:
        if req is not None:
            # Typed wire path (core/wire.py LeaseRequest) — validated
            # decode; the flat-kwarg form stays for in-process callers.
            from ray_tpu_torch.core.wire import from_wire

            lr = from_wire(req, expect="LeaseRequest")
            resources, scheduling_key = lr.resources, lr.scheduling_key
            is_actor, spillback_count = lr.is_actor, lr.spillback_count
            bundle, request_id = lr.bundle, lr.request_id
            job_id = lr.job_id
        return await self._deduped_lease_reply(
            request_id,
            lambda: self._lease_single(
                conn, resources=resources, scheduling_key=scheduling_key,
                is_actor=is_actor, spillback_count=spillback_count,
                bundle=bundle, request_id=request_id, job_id=job_id))

    async def _deduped_lease_reply(self, request_id: Optional[str],
                                   factory) -> Dict[str, Any]:
        """At-least-once lease dispatch: a duplicate delivery (network
        retry, fault-injected redelivery) of a request_id whose grant
        already happened gets the CACHED reply; one racing the original
        awaits the same in-flight future. Without this, each duplicate
        of a batched lease request grants a fresh worker set that no
        client will ever use or return."""
        if not request_id:
            return await factory()
        cached = self._lease_reply_cache.get(request_id)
        if cached is not None:
            return cached
        inflight = self._lease_inflight.get(request_id)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._lease_inflight[request_id] = fut
        try:
            reply = await factory()
            if ((reply.get("granted") or reply.get("grants"))
                    and request_id not in self._cancelled_lease_requests):
                self._lease_reply_cache[request_id] = reply
                while len(self._lease_reply_cache) > 512:
                    self._lease_reply_cache.pop(
                        next(iter(self._lease_reply_cache)))
            if not fut.done():
                fut.set_result(reply)
            return reply
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                # A shielded duplicate may never retrieve it.
                try:
                    fut.exception()
                except Exception:
                    pass
            raise
        finally:
            self._lease_inflight.pop(request_id, None)

    async def _lease_single(
            self, conn: ServerConnection, *,
            resources: Dict[str, float], scheduling_key: str,
            is_actor: bool, spillback_count: int,
            bundle: Optional[List[Any]], request_id: Optional[str],
            job_id: Optional[str]) -> Dict[str, Any]:
        demand = {k: float(v) for k, v in resources.items() if v}
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "lease request %s actor=%s spill=%d avail=%s idle=%d "
                "pending=%d", demand, is_actor, spillback_count,
                {k: round(v, 1)
                 for k, v in self.resources_available.items()
                 if k in ("CPU", "GPU")},
                len(self._idle), len(self._pending))
        if bundle is not None:
            # Leases against a PG bundle are pinned to this node: no
            # spillback, fail fast if the bundle is gone or can't fit.
            key = f"{bundle[0]}:{bundle[1]}"
            b = self._bundles.get(key)
            if b is None or b.removed:
                return {"error": "bundle_missing",
                        "detail": f"bundle {key} not reserved on this node"}
            if not self._fits(b.total, demand):
                return {"error": "infeasible",
                        "detail": f"demand {demand} exceeds bundle total "
                                  f"{b.total}"}
            pending = _PendingLease(demand, is_actor, scheduling_key,
                                    bundle_key=key, request_id=request_id,
                                    spillback_count=spillback_count,
                                    job_id=job_id)
            pending.conn = conn
            self._pending.append(pending)
            self._try_dispatch()
            return await pending.future
        remote = self._maybe_spillback(demand, spillback_count)
        if remote is not None:
            return {"spillback": remote}
        # Locally-infeasible demands queue rather than fail (reference:
        # infeasible tasks wait in the cluster task manager until the
        # cluster changes — e.g. the node with that resource is still
        # registering); the heartbeat loop re-evaluates them for spillback.
        pending = _PendingLease(demand, is_actor, scheduling_key,
                                request_id=request_id,
                                spillback_count=spillback_count,
                                job_id=job_id)
        pending.conn = conn
        self._pending.append(pending)
        self._try_dispatch()
        return await pending.future

    async def handle_request_worker_leases(
            self, conn: ServerConnection, *,
            req: dict) -> Dict[str, Any]:
        """Batched lease grants (round 8): one RPC asks for up to
        `req.count` workers. Everything immediately grantable (idle
        worker + resources, through the SAME `_try_dispatch` machinery
        single leases use) returns at once as a partial grant — the
        client re-pumps for the shortfall; when nothing is grantable
        now, workers are prestarted for the whole burst width and the
        request degrades to the single-lease semantics (queueing,
        hybrid-policy spillback), so contention behavior matches the
        unbatched path — which queued one pending per task and thereby
        spawned the burst's workers in parallel."""
        from ray_tpu_torch.core.wire import from_wire

        lr = from_wire(req, expect="LeaseRequest")
        return await self._deduped_lease_reply(
            lr.request_id, lambda: self._lease_batch(conn, lr))

    async def _lease_batch(self, conn: ServerConnection,
                           lr) -> Dict[str, Any]:
        count = max(1, int(lr.get("count") or 1))
        demand = {k: float(v) for k, v in lr.resources.items() if v}
        # Hybrid-policy parity with the single-lease path: a node past
        # the spread threshold (or that can't fit the demand) spills
        # the whole batch rather than packing onto a local idle worker
        # the unbatched path would have sent away.
        if lr.bundle is None:
            remote = self._maybe_spillback(demand, lr.spillback_count)
            if remote is not None:
                return {"spillback": remote}
        grants: List[Dict[str, Any]] = []
        while lr.bundle is None and len(grants) < count:
            granted = self._try_grant_now(
                demand, lr.is_actor, lr.scheduling_key, conn,
                lr.request_id, lr.job_id)
            if granted is None:
                break
            grants.append(granted)
        if grants:
            return {"grants": grants}
        # Dry node with FREE resources (the shortage is worker
        # processes, not CPUs): prestart workers for the whole burst
        # before degrading to one queued single lease — the probe only
        # ever exposed a pending depth of 1 to _try_dispatch's spawn
        # loop, so without this an N-task cold burst would spawn its
        # workers serially, one per grant round trip (the unbatched
        # path queued N pendings and spawned N at once). When resources
        # are the constraint, spawning would only stack idle processes.
        if (lr.bundle is None
                and self._fits(self.resources_available, demand)):
            starting = sum(1 for w in self._workers.values()
                           if w.state == "starting")
            for _ in range(count - starting):
                if not self._can_start_worker(for_actor=lr.is_actor):
                    break
                self._spawn_worker()
        # Degrade to single-lease semantics — straight to the inner
        # path: this call is already inside the batch's dedup scope.
        return await self._lease_single(
            conn, resources=lr.resources,
            scheduling_key=lr.scheduling_key, is_actor=lr.is_actor,
            spillback_count=lr.spillback_count, bundle=lr.bundle,
            request_id=lr.request_id, job_id=lr.job_id)

    def _try_grant_now(self, demand: Dict[str, float], is_actor: bool,
                       scheduling_key: str, conn, request_id, job_id
                       ) -> Optional[Dict[str, Any]]:
        """One immediate grant through `_try_dispatch`, or None without
        queueing anything (the batch handler withdraws the probe)."""
        pending = _PendingLease(demand, is_actor, scheduling_key,
                                request_id=request_id, job_id=job_id)
        pending.conn = conn
        self._pending.append(pending)
        self._try_dispatch()
        if pending.future.done():
            reply = pending.future.result()
            granted = reply.get("granted")
            if granted is not None:
                return granted
            return None
        try:
            self._pending.remove(pending)
        except ValueError:
            pass
        pending.future.cancel()
        return None

    # ------------------------------------------------------------------
    # metrics (reference: stats/metric_defs.h runtime metrics + the
    # per-node metrics agent, _private/metrics_agent.py)
    # ------------------------------------------------------------------
    async def handle_report_metrics(self, conn: ServerConnection, *,
                                    worker_id: str, snapshot: list,
                                    ts_batch: Optional[list] = None) -> bool:
        """A worker/driver process pushes its app-metric snapshot (and,
        round 17, its delta-encoded time-series batch — queued here
        until the next GCS heartbeat folds the whole node)."""
        self._worker_metrics[worker_id] = (time.monotonic(), snapshot)
        if ts_batch:
            role = ("driver" if worker_id.startswith("driver-")
                    else "worker")
            wid8 = worker_id[:8]
            for entry in ts_batch:
                self._metrics_pending.append({
                    "t": entry.get("t"),
                    "series": [
                        [it[0], it[1],
                         dict(it[2], worker_id=wid8, role=role)]
                        + list(it[3:])
                        for it in entry.get("series", ())]})
            # Bounded like every other ring: a GCS outage must not grow
            # raylet memory without limit. Oldest entries go first.
            cap = max(1, ray_config().metrics_ts_ring) * 4
            overflow = len(self._metrics_pending) - cap
            if overflow > 0:
                del self._metrics_pending[:overflow]
        return True

    def _runtime_metrics(self) -> list:
        """The raylet's own runtime gauges, registry-snapshot shaped
        (shared by the legacy get_metrics scrape and the pushed
        pipeline's per-interval capture)."""
        stats = self.store.stats()
        runtime = [{
            "name": f"ray_tpu_{key}", "type": "gauge", "help": help_,
            "samples": [{"tags": {}, "value": float(value)}],
        } for key, value, help_ in [
            ("object_store_used_bytes", stats.get("used", 0),
             "Bytes resident in the node object store"),
            ("object_store_capacity_bytes", stats.get("capacity", 0),
             "Node object store capacity"),
            ("object_store_num_objects", stats.get("num_objects", 0),
             "Objects tracked by the node store"),
            ("object_store_num_spilled", stats.get("num_spilled", 0),
             "Objects currently spilled to disk"),
            ("raylet_workers", len(self._workers), "Worker processes"),
            ("raylet_idle_workers", len(self._idle),
             "Idle cached workers"),
            ("raylet_pending_leases", len(self._pending),
             "Queued lease requests"),
        ]]
        for res, avail in self.resources_available.items():
            runtime.append({
                "name": "ray_tpu_resource_available", "type": "gauge",
                "help": "Schedulable resource availability",
                "samples": [{"tags": {"resource": res},
                             "value": float(avail)}]})
        return runtime

    async def handle_get_metrics(self, conn: ServerConnection) -> list:
        """Node-wide snapshot: raylet runtime gauges + every live
        process's pushed app metrics, polled by the Serve controller
        where the GCS fold is empty or unavailable."""
        runtime = self._runtime_metrics()
        from ray_tpu_torch.util.metrics import merge_snapshots

        # Stale = missed ~3 push intervals (dead worker); prune, don't
        # just filter, so churned workers can't grow memory unboundedly.
        cutoff = time.monotonic() - max(
            60.0, 3 * ray_config().metrics_report_interval_ms / 1000.0)
        for wid, (ts, _) in list(self._worker_metrics.items()):
            if ts < cutoff:
                del self._worker_metrics[wid]
        per_source = [({"node_id": self.node_id[:8]}, runtime)] + [
            ({"node_id": self.node_id[:8], "worker_id": wid[:8]}, snap)
            for wid, (ts, snap) in self._worker_metrics.items()]
        return merge_snapshots(per_source)

    async def handle_metrics_push_stats(self, conn: ServerConnection
                                        ) -> Dict[str, Any]:
        """Structural accounting for the perf guard: pushes (heartbeats
        that carried a metrics payload) must never exceed heartbeat
        intervals — i.e. one coalesced push RPC per node per interval."""
        return {"node_id": self.node_id,
                "pushes": self._metrics_pushes,
                "intervals": self._metrics_hb_intervals,
                "pending": len(self._metrics_pending),
                "recorder_dropped": self._ts_recorder.dropped}

    async def handle_object_store_stats(self, conn: ServerConnection
                                        ) -> Dict[str, Any]:
        """Plasma inventory for `ray_tpu memory` / state API
        list_objects."""
        return {"node_id": self.node_id, "used": self.store.used,
                "capacity": self.store.capacity,
                "objects": self.store.object_inventory()}

    def _lease_pools(self, pending: "_PendingLease") -> Optional[tuple]:
        """The pools this lease draws from, (resources, free GPU ids,
        shared GPU fractions): a PG bundle's reserved ones, or the
        node's. None = can't run now."""
        if pending.bundle_key is not None:
            b = self._bundles.get(pending.bundle_key)
            if b is None or b.removed:
                if not pending.future.done():
                    pending.future.set_result({
                        "error": "bundle_missing",
                        "detail": f"bundle {pending.bundle_key} was removed"})
                self._pending.remove(pending)
                return None
            pools = (b.available, b.chips, b.gpu_partial)
        else:
            pools = (self.resources_available, self._chips_free,
                     self._gpu_partial)
        if (self._fits(pools[0], pending.demand)
                and _gpus_fit(pools[1], pools[2],
                              pending.demand.get("GPU", 0.0))):
            return pools
        return None

    def _try_dispatch(self) -> None:
        if self._stopping:
            return
        made_progress = True
        while made_progress and self._pending:
            made_progress = False
            for pending in list(self._pending):
                pools = self._lease_pools(pending)
                if pools is None:
                    continue
                worker = self._get_idle_worker(
                    fresh=pending.demand.get("GPU", 0.0) > 0)
                if worker is None:
                    # Spawn enough workers for everything runnable now —
                    # startup is the latency, so batch it (reference:
                    # PrestartWorkers on the lease path).
                    starting = sum(1 for w in self._workers.values()
                                   if w.state == "starting")
                    want_actor = any(p.is_actor for p in self._pending)
                    want_fresh = pending.demand.get("GPU", 0.0) > 0
                    for _ in range(len(self._pending) - starting):
                        if not self._can_start_worker(
                                for_actor=want_actor) and not (
                                    want_fresh and self._retire_used_idle()):
                            break
                        self._spawn_worker()
                    break
                self._pending.remove(pending)
                chips, share = _take_gpus(pools[1], pools[2],
                                          pending.demand.get("GPU", 0.0))
                for k, v in pending.demand.items():
                    pools[0][k] = pools[0].get(k, 0.0) - v
                self._next_lease += 1
                lease_id = f"{self.node_id[:8]}-{self._next_lease}"
                worker.state = "actor" if pending.is_actor else "leased"
                worker.lease_id = lease_id
                worker.granted_at = time.monotonic()
                worker.lease_job_id = pending.job_id
                worker.held = dict(pending.demand)
                worker.bundle_key = pending.bundle_key
                worker.chip_ids = chips
                worker.gpu_share = share
                worker.used = True
                self._lease_conns[lease_id] = (worker.worker_id,
                                               pending.conn)
                if pending.request_id is not None:
                    self._recent_grants.setdefault(
                        pending.request_id, []).append(
                            (lease_id, worker.worker_id))
                    while len(self._recent_grants) > 256:
                        self._recent_grants.pop(
                            next(iter(self._recent_grants)))
                if not pending.future.done():
                    pending.future.set_result({
                        "granted": {
                            "worker_id": worker.worker_id,
                            "worker_address": worker.address,
                            "lease_id": lease_id,
                            "node_id": self.node_id,
                            "resources": pending.demand,
                            "bundle": pending.bundle_key,
                            "chip_ids": chips,
                        }})
                made_progress = True

    def _get_idle_worker(self, fresh: bool = False) -> Optional[_Worker]:
        """An idle worker; with `fresh`, one that never held a lease (a
        GPU lease sets CUDA_VISIBLE_DEVICES, which CUDA reads once). A
        lease without GPUs takes a used worker first, keeping fresh ones
        for GPU leases."""
        self._idle = [w for w in self._idle
                      if w.state == "idle" and w.proc.poll() is None]
        pick = [w for w in self._idle if not w.used] if fresh else (
            [w for w in self._idle if w.used]
            or [w for w in self._idle if not w.used])
        if not pick:
            return None
        self._idle.remove(pick[0])
        return pick[0]

    def _retire_used_idle(self) -> bool:
        """End one idle worker that held a lease, making room under the
        pool's limit for a fresh one that a GPU lease can take."""
        for w in self._idle:
            if w.used:
                self._idle.remove(w)
                w.state = "dead"
                if w.proc.poll() is None:
                    w.proc.terminate()
                return True
        return False

    def _can_start_worker(self, for_actor: bool = False) -> bool:
        """The soft limit caps the TASK worker pool; actors hold
        dedicated workers for their lifetime and must not be starved by
        it (reference: worker_pool.h — the cap applies to pooled idle
        workers, dedicated actor workers allocate past it). Actor
        spawns are still bounded against runaways."""
        limit = ray_config().num_workers_soft_limit or int(
            self.resources_total.get("CPU", 4)) + 2
        if for_actor:
            limit = max(limit * 8, 64)
        alive = sum(1 for w in self._workers.values() if w.state != "dead")
        return alive < limit

    # -- blocked-task CPU release (reference: node_manager.cc
    # HandleNotifyDirectCallTaskBlocked/Unblocked — a task blocked in
    # ray.get releases its CPU so downstream tasks can schedule;
    # without this, N consumers blocked on N producers deadlock a node)
    def _blocked_cpu_pool(self, w: _Worker) -> Optional[Dict[str, float]]:
        """Where a blocked worker's CPU goes back to: its PG bundle's
        available set when leased from one (and the bundle still lives),
        else the node pool."""
        if w.bundle_key is not None:
            b = self._bundles.get(w.bundle_key)
            if b is None or b.removed:
                return None
            return b.available
        return self.resources_available

    async def handle_worker_blocked(self, conn: ServerConnection, *,
                                    worker_id: str) -> bool:
        w = self._workers.get(worker_id)
        if (w is not None and not w.blocked
                and w.state in ("leased", "actor")
                and w.held.get("CPU")):
            pool = self._blocked_cpu_pool(w)
            if pool is not None:
                w.blocked = True
                pool["CPU"] = pool.get("CPU", 0.0) + w.held["CPU"]
                self._try_dispatch()
        return True

    async def handle_worker_unblocked(self, conn: ServerConnection, *,
                                      worker_id: str) -> bool:
        w = self._workers.get(worker_id)
        if w is not None and w.blocked:
            w.blocked = False
            pool = self._blocked_cpu_pool(w)
            if pool is not None:
                # May transiently oversubscribe (go negative) — new
                # leases stop until something frees, as the reference.
                pool["CPU"] = pool.get("CPU", 0.0) - w.held.get("CPU",
                                                               0.0)
        return True

    def _release_lease_resources(self, worker: _Worker) -> None:
        """Return a lease's resources and GPU ids to where they came
        from: the PG bundle if it's still live, else the node pool (a
        removed bundle's in-use share flows back to the pool as its
        leases end)."""
        if worker.blocked:
            # The blocked release already returned the CPU to its pool;
            # re-take it first so the normal release below is exact.
            worker.blocked = False
            pool = self._blocked_cpu_pool(worker)
            if pool is not None:
                pool["CPU"] = pool.get("CPU", 0.0) - worker.held.get(
                    "CPU", 0.0)
        b = (self._bundles.get(worker.bundle_key)
             if worker.bundle_key else None)
        if b is not None and not b.removed:
            for k, v in worker.held.items():
                b.available[k] = min(b.available.get(k, 0.0) + v,
                                     b.total.get(k, v))
            _give_gpus(b.chips, b.gpu_partial, worker.chip_ids,
                       worker.gpu_share)
        else:
            self._release(worker.held)
            _give_gpus(self._chips_free, self._gpu_partial,
                       worker.chip_ids, worker.gpu_share)
            if b is not None:
                # Removed bundle draining: shrink its in-use record and
                # drop the entry once the last lease ends.
                for k, v in worker.held.items():
                    b.total[k] = b.total.get(k, 0.0) - v
                    if b.total[k] <= 1e-9:
                        del b.total[k]
                if not b.total:
                    self._bundles.pop(worker.bundle_key, None)
        worker.held = {}
        worker.chip_ids = []
        worker.gpu_share = 0.0
        worker.bundle_key = None

    async def handle_cancel_lease_request(self, conn: ServerConnection, *,
                                          request_id: str) -> bool:
        """A client gave up on a lease (timeout): drop it from the queue,
        or — if it was granted in the meantime — return the worker so the
        abandoned grant doesn't leak its resources."""
        # A duplicate delivery arriving after the cancel must not be
        # served the cached (now-reclaimed) grants — and a grant whose
        # handler has not yet RESUMED to cache its reply must find the
        # cancellation when it does (the cache-then-cancel race).
        self._lease_reply_cache.pop(request_id, None)
        self._cancelled_lease_requests[request_id] = None
        while len(self._cancelled_lease_requests) > 512:
            self._cancelled_lease_requests.pop(
                next(iter(self._cancelled_lease_requests)))
        for pending in self._pending:
            if pending.request_id == request_id:
                self._pending.remove(pending)
                if not pending.future.done():
                    pending.future.cancel()
                return True
        grants = self._recent_grants.pop(request_id, None)
        if grants:
            for lease_id, worker_id in grants:
                await self.handle_return_worker(
                    conn, lease_id=lease_id, worker_id=worker_id)
            return True
        return False

    async def handle_return_worker(self, conn: ServerConnection, *,
                                   lease_id: str, worker_id: str,
                                   resources: Optional[Dict[str, float]]
                                   = None, dead: bool = False) -> bool:
        self._return_worker_one(lease_id, worker_id, dead)
        self._try_dispatch()
        return True

    async def handle_return_worker_leases(self, conn: ServerConnection, *,
                                          returns: List[Dict[str, Any]]
                                          ) -> bool:
        """Batched lease returns (round 10, ROADMAP 4c): one RPC hands
        back a burst's finished leases — the mirror of the round-8
        grant batch. Each entry recycles through the same single-return
        path; dispatch runs once for the whole batch."""
        for item in returns or ():
            self._return_worker_one(item.get("lease_id"),
                                    item.get("worker_id"),
                                    bool(item.get("dead")))
        self._try_dispatch()
        return True

    def _return_worker_one(self, lease_id: Optional[str],
                           worker_id: Optional[str], dead: bool) -> None:
        self._lease_conns.pop(lease_id, None)
        worker = self._workers.get(worker_id)
        if worker is not None and worker.lease_id == lease_id:
            # A worker that held GPUs cannot be reused: CUDA reads
            # CUDA_VISIBLE_DEVICES once, at its first initialisation, so
            # a recycled process would compute on its OLD card while the
            # raylet leases it to someone else. Retire it instead.
            had_chips = bool(worker.chip_ids)
            # The raylet's own bookkeeping is authoritative for what this
            # lease holds — not the client's view.
            self._release_lease_resources(worker)
            worker.lease_id = None
            if dead or had_chips or worker.proc.poll() is not None:
                worker.state = "dead"
                if worker.proc.poll() is None:
                    worker.proc.terminate()
            else:
                worker.state = "idle"
                worker.actor_id = None
                self._idle.append(worker)

    async def handle_mark_actor_worker(self, conn: ServerConnection, *,
                                       worker_id: str, actor_id: str,
                                       release: Optional[Dict[str, float]]
                                       = None,
                                       job_id: Optional[str] = None,
                                       detached: bool = False) -> bool:
        """Record the actor on its worker; `release` downgrades the lease to
        the actor's running demand (placement CPU released after __init__)."""
        worker = self._workers.get(worker_id)
        if worker is not None:
            # An actor worker's lifetime is governed by actor semantics
            # (GCS liveness, max_restarts, detached), NOT by its creation
            # lease's connection — exempt it from dead-client reclaim.
            if worker.lease_id is not None:
                self._lease_conns.pop(worker.lease_id, None)
            worker.actor_id = actor_id
            worker.actor_job_id = job_id
            worker.actor_detached = detached
            if release:
                b = (self._bundles.get(worker.bundle_key)
                     if worker.bundle_key else None)
                if b is not None and not b.removed:
                    for k, v in release.items():
                        b.available[k] = min(b.available.get(k, 0.0) + v,
                                             b.total.get(k, v))
                else:
                    self._release(release)
                for k, v in release.items():
                    worker.held[k] = worker.held.get(k, 0.0) - v
                    if worker.held[k] <= 1e-9:
                        del worker.held[k]
                self._try_dispatch()
        return True

    # ------------------------------------------------------------------
    # object store RPCs (reference: plasma protocol + object_manager)
    # ------------------------------------------------------------------
    async def _store_io(self, fn, *args):
        """Run a store op on the loop: the Python store is not
        thread-safe and never touches disk (the reference moves its
        native store's spilling ops off the loop)."""
        return fn(*args)

    async def handle_create_object(self, conn: ServerConnection, *,
                                   oid: str, size: int) -> str:
        return await self._store_io(self.store.create, oid, size)

    async def handle_seal_object(self, conn: ServerConnection, *,
                                 oid: str) -> bool:
        # Sealing is a fire-and-forget notify on the put hot path, so a
        # failure cannot surface at the caller — make it loud here and
        # drop the unsealed entry so consumers fail fast (object-lost ->
        # lineage) instead of polling an object that will never seal.
        try:
            self.store.seal(oid)
        except Exception as e:  # noqa: BLE001
            logger.error("seal_object(%s) failed: %s; dropping entry",
                         oid[:16], e)
            try:
                self.store.delete(oid)
            except Exception:
                pass
            return False
        return True

    async def handle_object_info(self, conn: ServerConnection, *,
                                 oid: str) -> Optional[Dict[str, Any]]:
        info = await self._store_io(self.store.info, oid)
        if info is None:
            return None
        name, size = info
        return {"shm_name": name, "size": size}

    async def handle_read_object(self, conn: ServerConnection, *,
                                 oid: str) -> Optional[bytes]:
        """Remote raylet pull (data-plane; single frame, small objects)."""
        if not self.store.contains(oid):
            return None
        try:
            return await self._store_io(self.store.read_bytes, oid)
        except KeyError:
            # Evicted since contains(), or a spilled copy failed to
            # restore: "no longer a holder", the puller tries elsewhere.
            return None

    async def handle_object_meta(self, conn: ServerConnection, *,
                                 oid: str) -> Optional[Dict[str, int]]:
        size = self.store.size_of(oid)
        if size is None:
            return None
        return {"size": size}

    def _push_gate(self) -> asyncio.Semaphore:
        """Push-side backpressure (reference: push_manager.h:30 bounded
        in-flight pushes): at most `object_push_concurrency` chunk serves
        run at once, so an N-way broadcast queues here instead of
        thrashing the store threadpool and starving the lease plane."""
        if self._push_sem is None:
            self._push_sem = asyncio.Semaphore(
                ray_config().object_push_concurrency)
        return self._push_sem

    async def handle_read_object_chunk(self, conn: ServerConnection, *,
                                       oid: str, offset: int,
                                       length: int) -> Optional[bytes]:
        """One chunk of a large object (reference: object_manager.h
        chunked transfer). Returns None if the object vanished."""
        if not self.store.contains(oid):
            return None
        gate = self._push_gate()
        self._push_waiters += 1
        try:
            await gate.acquire()
        finally:
            self._push_waiters -= 1
        try:
            return await self._store_io(
                self.store.read_range, oid, offset, length)
        except KeyError:
            return None
        finally:
            gate.release()

    # Large objects stream in 1 MiB frames so a multi-GB transfer neither
    # doubles peak memory nor monopolizes either event loop.
    @property
    def TRANSFER_CHUNK(self) -> int:
        return ray_config().object_transfer_chunk_bytes

    async def _pull_from_holder(self, remote, oid: str) -> bool:
        """Copy `oid` from a remote raylet into the local store, deduped
        (concurrent pulls of one object share a single transfer) and
        admission-controlled (pull_manager byte budget). Returns False if
        the holder no longer has it."""
        inflight = self._inflight_pulls.get(oid)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight_pulls[oid] = fut
        try:
            ok = await self._pull_from_holder_inner(remote, oid)
            fut.set_result(ok)
            return ok
        except BaseException as e:
            fut.set_exception(e)
            # A shielded waiter may never await the future after its own
            # cancellation; mark retrieved so asyncio doesn't log
            # "exception was never retrieved".
            try:
                fut.exception()
            except Exception:
                pass
            raise
        finally:
            self._inflight_pulls.pop(oid, None)

    async def _pull_from_holder_inner(self, remote, oid: str) -> bool:
        meta = await remote.call("object_meta", oid=oid, timeout=30.0)
        if meta is None:
            return False
        size = meta["size"]
        if size <= self.TRANSFER_CHUNK:
            data = await remote.call("read_object", oid=oid, timeout=60.0)
            if data is None:
                return False
            await self._store_io(self.store.put_bytes, oid, data)
            return True
        if self.store.contains(oid):
            return True
        granted = await self._pulls.admit(size)
        try:
            try:
                await self._store_io(self.store.create, oid, size)
            except FileExistsError:
                # A concurrent pull sealed it between contains() and here.
                return self.store.contains(oid)
            try:
                for offset in range(0, size, self.TRANSFER_CHUNK):
                    chunk = await remote.call(
                        "read_object_chunk", oid=oid, offset=offset,
                        length=self.TRANSFER_CHUNK, timeout=60.0)
                    if chunk is None:
                        raise KeyError(f"{oid[:8]} evicted mid-transfer")
                    await self._store_io(
                        self.store.write_range, oid, offset, chunk)
                self.store.seal(oid)
            except BaseException:
                # Only roll back an entry WE still own unsealed — a
                # concurrent pull may have sealed it and handed readers
                # the mapping (contains() == sealed).
                if not self.store.contains(oid):
                    self.store.delete(oid)
                raise
            return True
        finally:
            self._pulls.release(granted)

    async def handle_put_object(self, conn: ServerConnection, *,
                                oid: str, data: bytes) -> bool:
        await self._store_io(self.store.put_bytes, oid, data)
        return True

    async def handle_delete_objects(self, conn: ServerConnection, *,
                                    oids: List[str]) -> int:
        # Off-loop: native erase() waits out any in-flight restore's
        # disk read before removing the entry.
        n = 0
        for oid in oids:
            if await self._store_io(self.store.delete, oid):
                n += 1
        return n

    async def on_client_disconnect(self, conn: ServerConnection) -> None:
        """Drop queued lease requests from a vanished client so a later
        grant doesn't strand a worker + its resources, and reclaim
        leases it was already granted (a dead client can never use or
        return them)."""
        for pending in [p for p in self._pending if p.conn is conn]:
            self._pending.remove(pending)
            if not pending.future.done():
                pending.future.cancel()
        for lease_id, (worker_id, owner_conn) in list(
                self._lease_conns.items()):
            if owner_conn is not conn:
                continue
            worker = self._workers.get(worker_id)
            if worker is not None and (worker.actor_id
                                       or worker.state == "actor"):
                # Actor lifetimes are actor-managed, never conn-managed.
                self._lease_conns.pop(lease_id, None)
                continue
            # dead=True: the worker may be mid-task for the dead
            # client; terminating is the only safe reset.
            await self.handle_return_worker(
                conn, lease_id=lease_id, worker_id=worker_id, dead=True)

    async def handle_pull_object(self, conn: ServerConnection, *, oid: str,
                                 owner_address: Optional[str],
                                 pull_timeout: Optional[float] = 30.0
                                 ) -> Optional[Dict[str, Any]]:
        """Ensure `oid` is in the local store; returns shm info, inline
        payload, or None. Resolution order: local store -> owner's location
        directory (ownership-based object directory,
        `ownership_based_object_directory.h`) -> remote raylet fetch.

        pull_timeout=None blocks until the object materializes (a blocking
        `ray.get` with no user timeout must not be capped server-side)."""
        deadline = (None if pull_timeout is None
                    else time.monotonic() + pull_timeout)
        owner_unreachable_since: Optional[float] = None
        while deadline is None or time.monotonic() < deadline:
            info = await self._store_io(self.store.info, oid)
            if info is not None:
                # Local hit: never touches pull admission — the budget
                # paces inbound remote transfers only (_pull_from_holder
                # charges it; this path must not).
                self._pulls.stats["local_reads"] += 1
                return {"shm_name": info[0], "size": info[1]}
            if owner_address:
                try:
                    owner = await self._worker_client(owner_address)
                    loc = await owner.call("get_object_locations", oid=oid,
                                           timeout=10.0)
                except Exception as e:
                    # An unreachable owner is transient (restarting GCS,
                    # blip) until it has stayed unreachable for the
                    # grace window — then it is DEAD and the borrower's
                    # get must fail loudly as OwnerDiedError, not hang
                    # in this loop or mislabel the loss as a generic
                    # ObjectLostError (reference: ownership model,
                    # OBJECT_UNRECOVERABLE_OWNER_DIED).
                    now = time.monotonic()
                    if owner_unreachable_since is None:
                        owner_unreachable_since = now
                    if (now - owner_unreachable_since
                            >= ray_config().owner_unreachable_grace_s):
                        return {"error": f"owner unreachable: {e}",
                                "owner_dead": True}
                    await asyncio.sleep(
                        ray_config().object_timeout_ms / 1000.0)
                    continue
                owner_unreachable_since = None
                if loc is None:
                    return {"error": "owner does not know this object"}
                if loc.get("inline") is not None:
                    return {"inline": loc["inline"]}
                for node_addr in loc.get("nodes", []):
                    if node_addr == self.address:
                        # We're listed as a holder but store.info() came up
                        # empty above: our copy was evicted. Prune it so
                        # the owner can recover instead of us spinning on
                        # a stale self-location.
                        try:
                            await owner.notify("prune_object_location",
                                               oid=oid, node=node_addr)
                        except Exception:
                            pass
                        continue
                    try:
                        remote = await self._raylet_client(node_addr)
                        fetched = await self._pull_from_holder(remote, oid)
                    except Exception:
                        # Unreachable holder: if the cluster has declared
                        # its node dead, prune the location so the owner
                        # can start lineage reconstruction; otherwise treat
                        # it as transient and retry.
                        if self._address_is_dead(node_addr):
                            try:
                                await owner.notify("prune_object_location",
                                                   oid=oid, node=node_addr)
                            except Exception:
                                pass
                        continue
                    if fetched:
                        info = await self._store_io(self.store.info, oid)
                        if info is not None:
                            return {"shm_name": info[0], "size": info[1]}
                        continue  # evicted between pull and info: re-resolve
                    # The node answered but no longer holds the object
                    # (LRU-evicted/deleted): tell the owner to prune this
                    # stale location so future pulls skip it.
                    try:
                        await owner.notify("prune_object_location",
                                           oid=oid, node=node_addr)
                    except Exception:
                        pass
                if not loc.get("pending") and not loc.get("nodes"):
                    # No copies and the owner is not currently producing
                    # one. Ask the owner to RECOVER it (lineage
                    # re-execution) before declaring the loss final —
                    # relying on the prune notify alone races this
                    # loop's next locations query against the owner's
                    # reconstruction trigger and failed borrower gets
                    # that lineage could have saved. `recovering=False`
                    # is authoritative: unretained lineage or exhausted
                    # budget, the typed loss stands.
                    try:
                        r = await owner.call("reconstruct_object",
                                             oid=oid, timeout=10.0)
                    except Exception:
                        # Transient owner blip: re-enter the loop; the
                        # owner-unreachable grace above judges real
                        # owner death.
                        await asyncio.sleep(
                            ray_config().object_timeout_ms / 1000.0)
                        continue
                    if r and r.get("recovering"):
                        await asyncio.sleep(
                            ray_config().object_timeout_ms / 1000.0)
                        continue
                    return {"error": "no reachable copy"}
            await asyncio.sleep(ray_config().object_timeout_ms / 1000.0)
        return {"error": "timeout"}

    def _address_is_dead(self, address: str) -> bool:
        """True when the GCS view says no alive node serves `address`."""
        alive = {info.get("address") for info in self._cluster_view.values()
                 if info.get("alive", True)}
        return bool(alive) and address not in alive

    async def _raylet_client(self, address: str) -> RpcClient:
        client = self._raylet_clients.get(address)
        if client is None or not client.connected:
            client = RpcClient(address)
            await client.connect(timeout=5.0)
            self._raylet_clients[address] = client
        return client

    async def _worker_client(self, address: str) -> RpcClient:
        client = self._worker_clients.get(address)
        if client is None or not client.connected:
            client = RpcClient(address)
            await client.connect(timeout=5.0)
            self._worker_clients[address] = client
        return client

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    async def handle_node_stats(self, conn: ServerConnection
                                ) -> Dict[str, Any]:
        return {
            "node_id": self.node_id,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": len([w for w in self._workers.values()
                                if w.state != "dead"]),
            "pending_leases": len(self._pending),
            "workers": [
                {"id": w.worker_id[:8], "state": w.state,
                 "lease_id": w.lease_id, "held": dict(w.held),
                 "actor": w.actor_id, "alive": w.proc.poll() is None}
                for w in self._workers.values()],
            "bundles": {k: {"total": b.total, "available": b.available,
                            "committed": b.committed,
                            "gpu_ids": b.gpu_ids}
                        for k, b in self._bundles.items() if not b.removed},
            "gpus_free": list(self._chips_free),
            "store": self.store.stats(),
            "object_manager": {
                **self._pulls.stats,
                "budget_bytes": self._pulls.budget,
                "in_use_bytes": self._pulls.in_use,
                "inflight_pulls": len(self._inflight_pulls),
                "push_waiters": self._push_waiters,
            },
        }

    async def handle_ping(self, conn: ServerConnection) -> str:
        return "pong"


def main() -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--head", action="store_true")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)

    async def run():
        import signal

        raylet = Raylet(
            node_id=args.node_id, gcs_address=args.gcs,
            resources=json.loads(args.resources),
            object_store_memory=args.object_store_memory or None,
            is_head=args.head, port=args.port)
        await raylet.start()
        print(f"RAYLET_ADDRESS={raylet.address}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        # Clean shutdown: kill the worker pool before exiting, so no
        # orphan workers outlive the node.
        await raylet.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
