"""The distributed core-worker runtime, used by drivers AND workers: the
port of `ray_tpu/core/cluster_runtime.py`.

Left for later slices, each refusing with a message that names it:
worker-direct dispatch rings (`submit_ring`) and sharded puts of device
arrays. Compiled-graph channels ride `cgraph_push` (`cgraph/`). A
lease's GPU ids become the worker's CUDA_VISIBLE_DEVICES
(`_apply_visible_chips`). A task spec's `trace_ctx` parents the worker's
`task.run`/`actor.run` span to its caller's; a worker whose environment
names a trace directory (`util/tracing.py`) writes its spans there.

Reference equivalent: `src/ray/core_worker/` — one library linked into every
process (`core_worker.h`): task submission over leased workers
(`direct_task_transport.cc`), direct actor transport, ownership + in-process
memory store (`memory_store.h`), plasma provider, and the owner-side object
directory (`ownership_based_object_directory.h`).

Call stack parity with SURVEY.md §3.2: submit_task -> lease from raylet
(spillback honored) -> push_task direct to the leased worker -> returns
inline (small) or sealed into the node store (large) -> owner records
locations; `get` merges the memory store and shm store and pulls remote
copies through the local raylet.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple


from ray_tpu_torch.core import attribution, flight, serialization
from ray_tpu_torch.core.config import ray_config
from ray_tpu_torch.core.function_manager import FunctionManager
from ray_tpu_torch.core.gcs.client import GcsClient
from ray_tpu_torch.core.generator import ObjectRefGenerator
from ray_tpu_torch.core.ids import (ActorID, JobID, NodeID, ObjectID, TaskID,
                              WorkerID, _Counter)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import WorkerStoreClient
from ray_tpu_torch.core.runtime_env import env_hash
from ray_tpu_torch.core.wire import (ActorTaskSpec as WireActorTaskSpec,
                               LeaseRequest as WireLeaseRequest,
                               SpecTemplate,
                               TaskSpec as WireTaskSpec, from_wire,
                               from_wire_fast, to_wire)
from ray_tpu_torch.core import lineage as lineage_mod
from ray_tpu_torch.core.lineage import LineageTable
from ray_tpu_torch.core.rpc import (ConnectionLost, EventLoopThread, RpcClient,
                              RpcError, RpcServer, ServerConnection)
from ray_tpu_torch.util.tracing import (current_traceparent, span,
                                  tracing_enabled)
from ray_tpu_torch.exceptions import (ActorDiedError, ActorUnavailableError,
                                GetTimeoutError, ObjectLostError,
                                OwnerDiedError, RayActorError, RayTaskError,
                                TaskCancelledError)

logger = logging.getLogger(__name__)

# Per-thread deserialization context (suppress_borrow while unpacking
# task args — the submitter pins those for the task's duration).
_deser_ctx = threading.local()

# "Not resolvable on this thread" sentinel for _read_resolved_local
# (None is a legitimate stored value).
_MISS = object()

INLINE_LIMIT_KEY = "max_direct_call_object_size"


async def schedule_placement_group(gcs, raylet_client_for, pg_id: str,
                                   info: dict, *, attempts: int = 8
                                   ) -> str:
    """Owner-led placement-group 2PC (reference:
    gcs_placement_group_scheduler.h, run from the creating worker here
    like actor placement): select nodes against the GCS view, PREPARE a
    reservation on each, COMMIT all on success, then CAS the group
    CREATED — rolling back every reservation of a failed attempt,
    committed ones included, so a crash anywhere in the protocol never
    leaks capacity.

    `gcs` needs get_placement_group/get_nodes/update_placement_group;
    `raylet_client_for(address)` returns an object with `.call`.
    Returns the terminal state written ("CREATED"/"INFEASIBLE"), or
    the observed foreign state when someone else terminated the group
    (e.g. "REMOVED"), or "UNKNOWN" when the control plane stayed
    unreachable past every retry."""
    from ray_tpu_torch.core import flight
    from ray_tpu_torch.core.pg_scheduler import select_pg_nodes

    bundles = info["bundles"]
    detail = "no feasible placement"
    for attempt in range(attempts):
        try:
            # The user may have removed the group while we were
            # retrying; never resurrect it.
            current = await gcs.get_placement_group(pg_id)
            state = (current or {}).get("state")
            if state != "PENDING":
                return state or "UNKNOWN"
            nodes = [n for n in await gcs.get_nodes()
                     if n.get("alive")]
            placement = select_pg_nodes(bundles, nodes,
                                        info["strategy"],
                                        info.get("target_node_ids"))
            if placement is None and select_pg_nodes(
                    bundles,
                    [dict(n, resources_available=n.get("resources_total",
                                                       {}))
                     for n in nodes],
                    info["strategy"], info.get("target_node_ids")) is None:
                # Not even the live nodes' TOTAL resources hold it: no
                # release of a reservation can make it fit, so waiting
                # out the retries would only delay the verdict.
                detail = ("infeasible: no placement fits the live nodes' "
                          "total resources")
                break
            if placement is None:
                await asyncio.sleep(0.25 * (attempt + 1))
                continue
            prepared: List[Tuple[int, dict]] = []
            failure = None
            try:
                for idx, node in enumerate(placement):
                    client = await raylet_client_for(node["address"])
                    r = await client.call(
                        "prepare_bundle", pg_id=pg_id, bundle_index=idx,
                        resources=bundles[idx], timeout=10.0)
                    if not r.get("ok"):
                        failure = r.get("reason", "prepare rejected")
                        break
                    prepared.append((idx, node))
                if failure is None:
                    for idx, node in prepared:
                        client = await raylet_client_for(node["address"])
                        ok = await client.call("commit_bundle",
                                               pg_id=pg_id,
                                               bundle_index=idx,
                                               timeout=10.0)
                        if not ok:
                            # Reservation vanished between prepare and
                            # commit (raylet restart, concurrent
                            # return): a CREATED verdict over it would
                            # be a group nothing can lease against.
                            failure = (f"commit rejected for bundle "
                                       f"{idx}")
                            break
                if failure is None:
                    # CAS on PENDING, INSIDE the try: a CAS that raises
                    # must reach this attempt's rollback below — an
                    # escaped exception here once leaked every committed
                    # bundle when a later attempt landed on different
                    # nodes (invisible to the reconciler, which skips
                    # CREATED groups).
                    ok = await gcs.update_placement_group(pg_id, {
                        "state": "CREATED",
                        "bundle_locations": [
                            {"node_id": n["node_id"],
                             "address": n["address"]} for n in placement],
                    }, expect_state="PENDING")
                    if ok:
                        return "CREATED"
                    failure = "cas rejected"
            except Exception as e:  # noqa: BLE001
                failure = str(e)
            # CAS miss or error: only this owner ever writes CREATED, so
            # a CREATED read means OUR update applied (at-least-once
            # retry whose first ack was lost) — don't roll back a live
            # group. Any other state (REMOVED by the user, INFEASIBLE by
            # a reconciling raylet) means roll back and let the terminal
            # state stand.
            try:
                cur = await gcs.get_placement_group(pg_id)
                if (cur or {}).get("state") == "CREATED":
                    return "CREATED"
            except Exception:
                pass  # unreachable: roll back; the reconciler re-syncs
            # Roll back EVERYTHING reserved this attempt — including
            # already-committed bundles — or the reservation leaks
            # (neither the reaper nor remove would ever see it). A
            # rollback that cannot reach its raylet (node died
            # mid-2PC) is safe to skip: the dead node's ledger died
            # with it, and a NOT-dead-but-partitioned raylet returns
            # the orphan itself via _maybe_reconcile_bundles.
            detail = failure or "removed concurrently"
            if flight.enabled:
                flight.instant("pg", "pg.rollback",
                               arg=f"{pg_id[:8]} n={len(prepared)}")
            for idx, node in prepared:
                try:
                    client = await raylet_client_for(node["address"])
                    await client.call("return_bundle", pg_id=pg_id,
                                      bundle_index=idx, timeout=10.0)
                except Exception:
                    pass
            await asyncio.sleep(0.25 * (attempt + 1))
        except Exception as e:  # noqa: BLE001
            detail = str(e)
            await asyncio.sleep(0.25 * (attempt + 1))
    try:
        ok = await gcs.update_placement_group(
            pg_id, {"state": "INFEASIBLE", "detail": detail},
            expect_state="PENDING")
        if ok:
            return "INFEASIBLE"
        # CAS miss: someone else terminated the group (user remove, a
        # reconciling raylet) while we backed off — report the state
        # that actually stands, not a verdict that never wrote.
        cur = await gcs.get_placement_group(pg_id)
        return (cur or {}).get("state") or "UNKNOWN"
    except Exception:
        # Control plane unreachable for the whole schedule + final
        # verdict: raylet-side reconciliation returns any committed
        # bundles of the still-PENDING group after PG_STUCK_COMMIT_S.
        logger.warning("could not record INFEASIBLE for pg %s", pg_id,
                       exc_info=True)
        return "UNKNOWN"


def _pg_id_of(pg: Any) -> Optional[str]:
    """Normalize a placement-group option value (PlacementGroup object or
    hex id string) to the hex id, or None."""
    if pg is None:
        return None
    if isinstance(pg, str):
        return pg
    pid = getattr(pg, "id", None)
    if isinstance(pid, str):
        return pid
    if pid is not None and hasattr(pid, "hex"):
        return pid.hex()
    raise ValueError(f"invalid placement_group option: {pg!r}")


class _Owned:
    """Owner-side record of one object (reference: reference_count.h entry +
    memory-store slot)."""

    __slots__ = ("fut", "nodes", "refcount", "is_stored")

    def __init__(self):
        self.fut: concurrent.futures.Future = concurrent.futures.Future()
        self.nodes: List[str] = []
        self.refcount = 0
        self.is_stored = False  # True once sealed into a node store


class _ActorState:
    def __init__(self, actor_id_hex: str):
        self.actor_id_hex = actor_id_hex
        self.address: Optional[str] = None
        self.state = "PENDING"
        self.client: Optional[RpcClient] = None
        self.restarts_remaining = 0
        self.task_retries = 0     # max_task_retries (system failures)
        self.creation: Optional[dict] = None  # for owner-led restart
        self.lock = None  # asyncio.Lock, created lazily on the loop
        self.alive_event: Optional[object] = None
        self.restart_inflight = False  # guards concurrent restart attempts
        self.pinned_args: List[ObjectID] = []  # ctor-arg refs, pinned until DEAD


def _prepared_env(rt, opts):
    env = getattr(opts, "runtime_env", None)
    if not env:
        return None
    from ray_tpu_torch.core.runtime_env import prepare_spec_env

    return prepare_spec_env(rt, env)


class _TaskCancelledBeforePush(Exception):
    """Internal: cancel() landed while the task was queued for a lease."""


class _WorkerOOMKilled(RpcError):
    """Internal: the raylet's memory monitor killed the worker mid-task.
    Retryable like any worker death, but surfaces as a typed
    OutOfMemoryError when retries run out (reference: the OOM task
    failure reason from worker_killing_policy.h)."""


class _LeasePool:
    """Per-scheduling-key worker leases (reference: direct_task_transport
    SchedulingKey entries + pipelined lease requests,
    max_pending_lease_requests_per_scheduling_category)."""

    @property
    def MAX_INFLIGHT(self) -> int:
        # Snapshot on first read: a config attribute read costs an
        # os.environ lookup, and this sits on the per-submit path.
        v = self._max_inflight
        if v is None:
            from ray_tpu_torch.core.config import ray_config

            v = self._max_inflight = ray_config(
            ).max_pending_lease_requests_per_scheduling_category
        return v

    def __init__(self):
        self.idle: List[dict] = []
        # Grants expected from in-flight lease RPCs (a batched request
        # counts for its whole `count`); the RPC count itself is
        # bounded separately by MAX_INFLIGHT via inflight_rpcs.
        self.inflight_leases = 0
        self.inflight_rpcs = 0          # lease RPCs in flight to raylets
        self.waiters: List[Any] = []    # futures of queued acquires
        self.pump_scheduled = False     # a coalesced pump is queued
        self._max_inflight: Optional[int] = None


# Inline cost model v2 (round 16): arg-size buckets for the per-fn exec
# EMA. Boundaries are coarse on purpose — the gate estimates sizes from
# raw args (pre-serialization) while the EMA keys on the serialized
# blob length, and wide buckets keep boundary-crossing mismatches rare.
_SIZE_BUCKETS = (1024, 16 * 1024, 256 * 1024)


def _size_bucket(nbytes: int) -> int:
    for i, bound in enumerate(_SIZE_BUCKETS):
        if nbytes <= bound:
            return i
    return len(_SIZE_BUCKETS)


def _no_line_trace(frame, event, arg):
    """The thread's trace function while a swallowed cancel is re-armed:
    it traces no new frame (the armed frame has its own)."""
    return None


class ClusterRuntime:
    is_local_mode = False

    # ==================================================================
    # construction
    # ==================================================================
    def __init__(self, *, gcs_address: str, raylet_address: str,
                 mode: str = "driver", worker_id: Optional[str] = None,
                 node_id: Optional[str] = None,
                 namespace: Optional[str] = None, node=None,
                 log_to_driver: bool = True):
        self.mode = mode
        self._log_to_driver = log_to_driver and mode == "driver"
        self.namespace = namespace or "default"
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.job_id = JobID.from_int(os.getpid() % 2**31)
        self.worker_id = (WorkerID(bytes.fromhex(worker_id))
                          if worker_id and len(worker_id) == 56
                          else WorkerID.from_random())
        # The id the RAYLET knows this worker by (spawn-time id) — the
        # blocked/unblocked notifications key on it.
        self._raylet_worker_id = worker_id or self.worker_id.hex()
        self._blocked_depth = 0
        self._blocked_lock = threading.Lock()
        self.node_id = (NodeID(bytes.fromhex(node_id))
                        if node_id else None)
        self._node = node  # owned process supervisor (head driver only)

        self._loop = EventLoopThread(name=f"{mode}-rpc")
        # Must run on the importing (main) thread: signal.signal rejects
        # non-main threads, and _async_start runs on the loop thread.
        self._install_task_dumper()
        self._gcs = GcsClient(gcs_address)
        self._raylet = RpcClient(raylet_address)
        self._server = RpcServer(self)
        self._loop.run(self._async_start())

        self._shm = WorkerStoreClient()
        self._shm_by_oid: Dict[str, str] = {}  # fetched oid -> segment
        # Releases queued by ObjectRef finalizers (see deferred_release).
        from collections import deque as _deque

        self._pending_releases: Any = _deque()
        self._release_drain_scheduled = False
        # Submit coalescing (see submit_task): queued submissions drained
        # by ONE loop wakeup per burst instead of one self-pipe write per
        # task (a syscall that costs 20+ us on virtualized hosts).
        self._pending_submits: Any = _deque()
        self._submit_drain_scheduled = False
        # Template-spec caches (wire.SpecTemplate): invariant wire dicts
        # for repeated task/actor-method submissions, keyed by every
        # invariant field so an options/runtime-env change misses.
        self._spec_templates: Dict[tuple, Tuple[SpecTemplate, str]] = {}
        self._actor_templates: Dict[tuple, SpecTemplate] = {}
        # Node-local shm objects this process wrote (put path): get()
        # reads them back without the raylet pull_object round trip.
        self._local_shm: Dict[str, dict] = {}
        # Syscall caches: getpid costs ~20 us on virtualized hosts and
        # the task path reads it 3x per task; config attribute reads do
        # an os.environ lookup each. Snapshot both per process.
        self._pid = os.getpid()
        cfg = ray_config()
        self._pipeline_depth = cfg.worker_pipeline_depth
        self._pipeline_svc_threshold = cfg.pipeline_service_threshold_s
        # Task-plane fast paths: same-process inline execution (gated
        # by an arg-size-conditional cost model) and batched lease
        # grants and returns.
        self._inline_threshold_s = cfg.task_inline_threshold_ms / 1000.0
        self._lease_batch_max = max(1, cfg.lease_batch_max)
        if cfg.submit_ring:
            raise NotImplementedError(
                "submit_ring: worker-direct dispatch rings (core/ring.py) "
                "come with a later slice of the port")
        # Flight recorder (round 12): always-on event ring + loop-lag
        # watchdog on this process's RPC loop. The config flag gates
        # the whole subsystem per process (workers read it through the
        # inherited RAY_TPU_FLIGHT_RECORDER env; _system_config applies
        # driver-side only).
        if not cfg.flight_recorder:
            flight.enabled = False
        if flight.enabled:
            # Workers/raylets inherit RAY_TPU_LOG_DIR; the head driver
            # owns the session and points its reports at the same logs
            # dir, so every process's stall reports land together.
            flight.configure(capacity=cfg.flight_events,
                             stall_threshold_ms=cfg.stall_threshold_ms,
                             heartbeat_ms=cfg.flight_heartbeat_ms,
                             report_dir=(node.log_dir if node is not None
                                         else None))
            flight.set_role(mode, worker_id=self.worker_id.hex(),
                            node_id=node_id)
            flight.install_gc_hook()
            self._flight_watch = flight.watch_loop(
                self._loop.loop, name=f"{mode}-loop")
            if mode == "driver":
                # Workers reach the merged timeline through their
                # raylet's registration table; a driver must announce
                # itself or its submit-side ring (and its stall
                # episodes) never show up at /api/timeline.
                try:
                    self._loop.run(self._raylet.notify(
                        "register_flight_source", address=self.address),
                        timeout=5)
                except Exception:
                    pass  # observability must not fail bring-up
        else:
            self._flight_watch = None
        # Per-function exec-time EMA (seconds), fed by exec_us riding
        # every task reply and by inline runs; the inline gate admits
        # only functions whose EMA is KNOWN and below the threshold, so
        # a long or blocking task is never inlined on spec.
        self._fn_cost: Dict[Tuple[str, int], float] = {}
        # Batched lease returns (round 10): raylet address -> pending
        # batch, flushed by one deferred pump per burst.
        self._pending_lease_returns: Dict[str, dict] = {}
        # Strong refs for fire-and-forget return tasks: the event
        # loop only keeps WEAK task references (the _BatchQueue
        # rationale) — a collected flush task would strand its batch's
        # awaiters and leak the leases at the raylet.
        self._bg_tasks: set = set()
        # Every granted task lease, until returned — the lease watchdog
        # sweeps this for orphans (see _lease_watchdog).
        self._live_leases: List[dict] = []
        self._owned: Dict[str, _Owned] = {}
        self._owned_lock = threading.Lock()
        # Refs this process BORROWS (owner elsewhere): oid -> [owner
        # address, local count, owner-ACKed]; zero -> release_borrow.
        self._borrowed: Dict[str, list] = {}
        self._borrowed_lock = threading.Lock()
        self._generators: Dict[str, ObjectRefGenerator] = {}
        self._put_counter = _Counter()
        self._lease_pools: Dict[str, _LeasePool] = {}
        # Placement groups: pg_id -> its CREATED record (bundle
        # locations), and the round-robin cursor of bundle index -1.
        self._pg_cache: Dict[str, dict] = {}
        self._pg_rr: Dict[str, int] = {}
        # cancel(): owner-side cancel flags + where each task is running
        # (address, is_actor_task).
        self._cancel_requested: set = set()
        self._inflight_task_workers: Dict[str, Tuple[str, bool]] = {}
        # worker-side: task_id -> executing thread ident (for async-raise)
        self._running_task_threads: Dict[str, int] = {}
        # worker-side: task_id -> run_coroutine_threadsafe future (async
        # actor methods cancel through the coroutine, not the thread)
        self._running_task_cfuts: Dict[str, Any] = {}
        # worker-side: cancels that arrived before their task started
        self._cancelled_pending: set = set()
        # worker-side: task_id -> thread ident while that thread runs the
        # task's own code (`_run_user_code`), the cancels sent to running
        # tasks, those Python swallowed and not yet re-delivered, the
        # frames armed to re-raise them, the lock that orders a cancel's
        # send against the thread's leaving, and the unraisablehook that
        # `_on_unraisable` replaced (see `_run_user_code`).
        self._user_code_threads: Dict[str, int] = {}
        self._cancel_sent: set = set()
        self._cancel_swallowed: set = set()
        self._cancel_armed: Dict[int, Any] = {}    # thread -> armed frame
        self._cancel_lock = threading.Lock()
        self._prev_unraisablehook = None
        # worker-side actor sequencing: caller address -> {next, cond}
        self._actor_seq: Dict[str, dict] = {}
        # driver-side: actor_id -> next seq to stamp
        self._actor_call_seq: Dict[str, int] = {}
        self._actor_seq_lock = threading.Lock()
        self._raylet_clients: Dict[str, RpcClient] = {self.raylet_address:
                                                      self._raylet}
        self._actors: Dict[str, _ActorState] = {}
        self._actor_meta: Dict[str, Tuple[str, dict]] = {}
        self._fn = FunctionManager(
            kv_put=lambda k, v, ow: self._loop.run(
                self._gcs.kv_put(k, v, ow)),
            kv_get=lambda k: self._loop.run(self._gcs.kv_get(k)))

        # worker-mode execution state
        self._exec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        self._actor_instance: Any = None
        self._actor_executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._actor_group_executors: Dict[str, Any] = {}
        self._actor_loop = None
        self._actor_id_hex: Optional[str] = None
        self._shutdown = False
        # Set at shutdown: threads that poll through this runtime (Serve's
        # routers) wait on it and end.
        self.shutdown_event = threading.Event()

        self._job_envs_applied: set = set()
        self._job_env_lock = threading.Lock()
        # Lineage: return-oid -> shared task record, kept while any return
        # ref lives so lost objects can be re-executed (reference:
        # task_manager.h:424 RetryTaskIfPossible + lineage pinning).
        # Policy (retention gate, budget, inflight dedup) lives in
        # core/lineage.py so the simcluster harness exercises the same
        # state machine.
        self._lineage = LineageTable()
        if mode == "driver":
            import sys
            # sys_path lets workers import driver-local modules (test files,
            # scripts) so functions pickle by reference (reference:
            # runtime-env working_dir / job_config code paths).
            self._loop.run(self._gcs.add_job(self.job_id.hex(), {
                "driver_pid": os.getpid(), "namespace": self.namespace,
                "sys_path": [p for p in sys.path if p],
                "cwd": os.getcwd()}))

    async def _async_start(self) -> None:
        await self._server.start()
        await self._gcs.connect()
        await self._raylet.connect()
        self.address = self._server.address
        self._event_flusher = asyncio.ensure_future(
            self._flush_task_events_loop())
        # Proactive location pruning: learn of node deaths from the GCS
        # instead of waiting for a puller to trip over a stale location
        # (reference: ownership-based object directory subscribes to
        # node removal).
        try:
            await self._gcs.subscribe("node", self._on_node_event)
        except Exception:
            logger.warning("node-event subscription failed", exc_info=True)
        self._lease_watchdog_task = asyncio.ensure_future(
            self._lease_watchdog())
        if self._log_to_driver:
            # Remote prints/tracebacks stream to this driver's stderr
            # (reference: _private/worker.py:812 print_logs over GCS
            # pubsub, fed by log_monitor.py:103 tails on each node).
            try:
                await self._gcs.subscribe("worker_logs",
                                          self._on_worker_logs)
            except Exception:
                logger.warning("worker-log subscription failed",
                               exc_info=True)
        self._start_metrics_push()

    def _on_worker_logs(self, data: dict) -> None:
        import sys

        if not isinstance(data, dict):
            return
        my_job = self.job_id.hex()
        for entry in data.get("entries", ()):
            job = entry.get("job_id")
            if job and job != my_job:
                continue  # another driver's worker
            tag = entry.get("actor_id") or entry.get("worker_id", "?")[:8]
            prefix = f"({tag}, pid={entry.get('pid', '?')})"
            for line in entry.get("lines", ()):
                print(f"{prefix} {line}", file=sys.stderr)

    def _install_task_dumper(self) -> None:
        """SIGUSR2 prints every asyncio task's stack on the RPC loop —
        faulthandler (SIGUSR1) shows only THREAD frames, and scheduling
        wedges live in coroutines (reference affordance: ray stack)."""
        import signal as _signal

        def _dump() -> None:
            import sys
            import traceback

            # sys.__stderr__: bypass pytest/driver capture so the dump
            # is visible even when the process dies before reporting.
            err = sys.__stderr__ or sys.stderr
            tasks = asyncio.all_tasks(self._loop.loop)
            print(f"=== {len(tasks)} asyncio tasks ===", file=err,
                  flush=True)
            for t in tasks:
                print(f"-- {t.get_coro()}", file=err, flush=True)
                for frame in t.get_stack(limit=4):
                    traceback.print_stack(frame, limit=1, file=err)

        def _on_sig(*_a) -> None:
            try:
                self._loop.call_soon(_dump)
            except Exception:
                pass

        try:
            _signal.signal(_signal.SIGUSR2, _on_sig)
        except (ValueError, OSError):
            pass  # not the main thread / unsupported: debug-only

    async def _on_node_event(self, data: dict) -> None:
        if not isinstance(data, dict) or data.get("alive", True):
            return
        node_id = data.get("node_id")
        addr = data.get("address")
        if not addr:
            # Older event shape: resolve via the node table.
            try:
                for n in await self._gcs.get_nodes():
                    if n.get("node_id") == node_id:
                        addr = n.get("address")
                        break
            except Exception:
                return
        if not addr:
            return
        # Drop cached placement-group location tables naming the dead
        # node: the GCS is rescheduling those bundles, and the next
        # _pg_location refetches (waiting out RESCHEDULING) instead of
        # leasing against a dead address forever.
        for pg_id, info in list(self._pg_cache.items()):
            if any(loc.get("address") == addr or loc.get("node_id")
                   == node_id
                   for loc in info.get("bundle_locations") or []):
                self._pg_cache.pop(pg_id, None)
        lost = []
        with self._owned_lock:
            for oid, entry in self._owned.items():
                if addr in entry.nodes:
                    entry.nodes = [n for n in entry.nodes if n != addr]
                    if not entry.nodes and entry.is_stored:
                        lost.append(oid)
        for oid in lost:
            self._trigger_reconstruction(oid)

    def _start_metrics_push(self) -> None:
        """Flush this process's app metrics (`ray_tpu_torch.util.metrics`) to
        the node's raylet on the configured interval (reference: the
        worker->metrics-agent export path). With the round-17 pipeline
        on, the same push carries the process's delta-encoded
        time-series batch; the raylet folds every process's batch into
        ONE payload on its next GCS heartbeat."""
        from ray_tpu_torch.core import metrics_ts
        from ray_tpu_torch.core.config import ray_config
        from ray_tpu_torch.util.metrics import start_metrics_push

        wid = (self.worker_id.hex() if self.worker_id is not None
               else f"driver-{os.getpid()}")
        pipeline = metrics_ts.enabled and ray_config().metrics_pipeline
        if pipeline:
            metrics_ts.recorder().configure(ray_config().metrics_ts_ring)

        def push(snapshot):
            ts_batch = None
            if pipeline:
                metrics_ts.capture(snapshot)
                ts_batch = metrics_ts.pending() or None
            # Outer timeout bounds the push thread even when shutdown
            # halts the event loop mid-call (no future to resolve).
            self._loop.run(self._raylet.call(
                "report_metrics", worker_id=wid, snapshot=snapshot,
                ts_batch=ts_batch, timeout=5.0), timeout=10.0)
            if ts_batch:
                # Clear-on-ack: a raylet hiccup leaves the batch queued
                # (bounded ring) for the next interval's retry.
                metrics_ts.ack(len(ts_batch))

        start_metrics_push(
            push, ray_config().metrics_report_interval_ms / 1000.0)

    # -- task events (reference: task_event_buffer.h flush loop) --------
    def _record_task_event(self, task_id: str, name: str, event: str,
                           job_id: Optional[str] = None, **extra) -> None:
        from ray_tpu_torch.core.task_events import task_event_buffer

        task_event_buffer().record(
            task_id, name, event, job_id=job_id or self.job_id.hex(),
            node_id=self.node_id.hex(), worker_id=self.address,
            pid=self._pid, **extra)

    async def _flush_task_events_loop(self) -> None:
        from ray_tpu_torch.core.task_events import task_event_buffer

        while True:
            await asyncio.sleep(1.0)
            events = task_event_buffer().drain()
            if not events:
                continue
            try:
                await self._gcs.add_task_events(events)
            except Exception:
                pass  # GCS down: events drop (bounded-loss contract)

    def task_events(self, job_id: Optional[str] = None):
        """Flush this process's buffer and fetch the job's events from
        the GCS store (the single entry used by timeline + state API)."""
        from ray_tpu_torch.core.task_events import task_event_buffer

        local = task_event_buffer().drain()
        if local:
            try:
                self._loop.run(self._gcs.add_task_events(local),
                               timeout=10)
            except Exception:
                pass
        return self._loop.run(
            self._gcs.get_task_events(job_id), timeout=30)

    def timeline(self, filename: Optional[str] = None):
        """Chrome-trace export of this job's task events (reference:
        ray timeline / state_api timeline)."""
        from ray_tpu_torch.core.task_events import (events_to_chrome_trace,
                                              write_trace)

        trace = events_to_chrome_trace(
            self.task_events(self.job_id.hex()))
        return write_trace(trace, filename)

    # -- bring-up helpers ----------------------------------------------
    @classmethod
    def connect_or_start(cls, address: Optional[str] = None,
                         num_cpus: Optional[int] = None,
                         num_gpus: Optional[int] = None,
                         resources: Optional[dict] = None,
                         namespace: Optional[str] = None,
                         object_store_memory: Optional[int] = None,
                         log_to_driver: bool = True,
                         **_: Any) -> "ClusterRuntime":
        from ray_tpu_torch.core.node import NodeSupervisor

        if address in (None, "local"):
            node = NodeSupervisor.start_head(
                num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
                object_store_memory=object_store_memory)
            return cls(gcs_address=node.gcs_address,
                       raylet_address=node.raylet_address,
                       namespace=namespace, node=node,
                       node_id=node.node_id,
                       log_to_driver=log_to_driver)
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        # Connect to an existing cluster: find this machine's raylet (or the
        # head raylet) from the GCS node table. `address` may be an HA
        # replica set ("host:p0,host:p1,host:p2"): the probe and every
        # client built from it rotate the set and follow NOT_LEADER
        # redirects onto whichever replica currently leads.
        probe = GcsClient(address)
        loop = EventLoopThread(name="probe")
        try:
            loop.run(probe.connect())
            nodes = loop.run(probe.get_nodes())
            loop.run(probe.close())
        finally:
            loop.stop()
        alive = [n for n in nodes if n.get("alive")]
        if not alive:
            raise ConnectionError(f"no alive nodes at GCS {address}")
        head = next((n for n in alive if n.get("is_head")), alive[0])
        return cls(gcs_address=address, raylet_address=head["address"],
                   namespace=namespace, node_id=head["node_id"],
                   log_to_driver=log_to_driver)

    def check_alive(self) -> bool:
        """Cheap liveness probe: is our GCS still answering?

        Used by init(ignore_reinit_error=True) to avoid silently reusing a
        runtime whose cluster has been torn down (stale function caches,
        leaked leases). Reference contract: ray.init reconnects rather than
        reusing a dead worker (_private/worker.py:1152).
        """
        if self._shutdown:
            return False
        try:
            self._loop.run(self._gcs.get_nodes(), timeout=5)
            return True
        except Exception:
            return False

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self.shutdown_event.set()
        if (self._prev_unraisablehook is not None
                and sys.unraisablehook == self._on_unraisable):
            sys.unraisablehook = self._prev_unraisablehook
        if self._flight_watch is not None:
            # Stop the heartbeat before the loop dies: a stale entry
            # would read as a permanent stall to the watchdog thread.
            flight.unwatch_loop(self._flight_watch)
        try:
            from ray_tpu_torch.util.metrics import stop_metrics_push

            stop_metrics_push()
        except Exception:
            pass
        try:
            if self.mode == "driver":
                self._loop.run(self._gcs.mark_job_finished(
                    self.job_id.hex()), timeout=2)
        except Exception:
            pass
        try:
            self._loop.run(self._server.stop(), timeout=2)
        except Exception:
            pass
        try:
            self._loop.run(self._close_clients(), timeout=2)
        except Exception:
            pass
        self._shm.close()
        self._exec_pool.shutdown(wait=False, cancel_futures=True)
        pool = getattr(self, "_cgraph_deposit_pool", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        if self._node is not None:
            self._node.stop()
        self._loop.stop()

    async def _close_clients(self) -> None:
        """Close every RPC client on the loop, before it stops."""
        clients = (list(getattr(self, "_worker_clients", {}).values())
                   + list(self._raylet_clients.values()))
        for client in clients:
            try:
                await client.close()
            except Exception:
                pass
        try:
            await self._gcs.close()
        except Exception:
            pass

    # ==================================================================
    # ownership / reference counting
    # ==================================================================
    def _owned_entry(self, oid_hex: str) -> _Owned:
        with self._owned_lock:
            entry = self._owned.get(oid_hex)
            if entry is None:
                entry = _Owned()
                self._owned[oid_hex] = entry
            return entry

    def add_local_reference(self, object_id: ObjectID) -> None:
        oid = object_id.hex()
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None:
                entry.refcount += 1
                return
        with self._borrowed_lock:
            if oid in self._borrowed:
                self._borrowed[oid][1] += 1

    def deferred_release(self, object_id: ObjectID) -> None:
        """Lock-free release entry point for ObjectRef.__del__.

        A finalizer can fire at ANY allocation in ANY thread — including
        while this runtime's own locks are held (observed: GC during
        handle_get_object_locations, which holds _owned_lock, fired a
        ref's __del__ whose remove_local_reference re-acquired
        _owned_lock and self-deadlocked the entire RPC loop). Finalizers
        therefore only APPEND (GIL-atomic) here; the real release runs
        on the event loop outside any lock."""
        if self._shutdown:
            # Nothing to release any more, and a callback scheduled on
            # the stopped loop would sit in its queue for good, holding
            # the context of whatever code ran the collector.
            return
        self._pending_releases.append(object_id)
        if not self._release_drain_scheduled:
            self._release_drain_scheduled = True
            try:
                self._loop.call_soon(self._drain_releases)
            except Exception:
                pass  # loop stopping at shutdown: releases are moot

    def _drain_releases(self) -> None:
        self._release_drain_scheduled = False
        while self._pending_releases:
            try:
                self.remove_local_reference(
                    self._pending_releases.popleft())
            except IndexError:
                break
            except Exception:
                pass

    def remove_local_reference(self, object_id: ObjectID) -> None:
        if self._shutdown:
            return
        oid = object_id.hex()
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is None:
                self._release_borrow(oid)
                return
            entry.refcount -= 1
            if entry.refcount > 0 or not entry.fut.done():
                return
            del self._owned[oid]
            nodes = list(entry.nodes)
        self._release_shm_mapping(oid)
        lineage_pins = self._lineage.release(oid)
        if lineage_pins:
            # Last return ref gone: lineage no longer needs the task's
            # argument objects pinned.
            self._unpin_args(lineage_pins)
        if nodes:
            async def _delete():
                for addr in nodes:
                    try:
                        client = await self._raylet_client(addr)
                        await client.call("delete_objects", oids=[oid],
                                          timeout=5.0)
                    except Exception:
                        pass
            self._loop.spawn(_delete())

    def on_ref_deserialized(self, ref: ObjectRef) -> None:
        oid = ref.hex()
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None:
                entry.refcount += 1
                return
        # A ref we do NOT own (e.g. embedded in a task's return value):
        # register a borrow with its owner so the object outlives the
        # owner process's own local references (reference:
        # reference_count.h borrowing protocol). The owner's escrow pin
        # (_escrow_pin) bridges the gap until this lands. Refs inside
        # TASK ARGS take a *local-only* pin instead — the submitter pins
        # them for the task's whole duration, so no owner RPC is needed
        # on the hot path; if the task retains the ref past completion,
        # _commit_arg_borrows upgrades the pin to a real owner-registered
        # borrow before the reply releases the submitter's pin
        # (reference: the borrowed-refs report in the task reply,
        # reference_count.h).
        owner = ref._owner
        if getattr(_deser_ctx, "suppress_borrow", False):
            if isinstance(owner, str) and owner != self.address:
                with self._borrowed_lock:
                    rec = self._borrowed.get(oid)
                    if rec is None:
                        # [owner, local count, owner ACKed the borrow]
                        self._borrowed[oid] = [owner, 1, False]
                    else:
                        rec[1] += 1
                collected = getattr(_deser_ctx, "arg_refs", None)
                if collected is not None:
                    collected.append((oid, owner))
            return
        if not isinstance(owner, str) or owner == self.address:
            return
        register = False
        with self._borrowed_lock:
            rec = self._borrowed.get(oid)
            if rec is None:
                # [owner, local count, owner ACKed the borrow]
                rec = self._borrowed[oid] = [owner, 1, False]
                register = True
            else:
                rec[1] += 1
        if register:
            async def _register(rec=rec):
                try:
                    client = await self._worker_client(owner)
                    ok = await client.call("register_borrow", oid=oid,
                                           timeout=30.0)
                except Exception:
                    return  # never ACKed: matching release stays local
                with self._borrowed_lock:
                    alive = self._borrowed.get(oid) is rec
                    if alive:
                        rec[2] = bool(ok)
                if not alive and ok:
                    # Released locally while the ACK was in flight: the
                    # owner counted us, so compensate now.
                    try:
                        await client.call("release_borrow", oid=oid,
                                          timeout=30.0)
                    except Exception:
                        pass

            self._loop.spawn(_register())

    def _release_shm_mapping(self, oid: str) -> None:
        """Unmap the local view of a fetched object once the last local
        reference drops; deferred (object_store._deferred) while
        deserialized zero-copy views still alias the mapping."""
        name = self._shm_by_oid.pop(oid, None)
        local = self._local_shm.pop(oid, None)
        if name is None and local is not None:
            # Locally-put object that was only ever read via the bypass:
            # release the probe attachment too.
            name = local["shm_name"]
        if name is not None:
            try:
                self._shm.release(name)
            except Exception:
                pass

    def _release_borrow(self, oid: str) -> None:
        with self._borrowed_lock:
            rec = self._borrowed.get(oid)
            if rec is None:
                return
            rec[1] -= 1
            if rec[1] > 0:
                return
            del self._borrowed[oid]
            owner = rec[0]
        self._release_shm_mapping(oid)
        if not rec[2]:
            # The owner never ACKed our register_borrow: sending a
            # release would decrement a count that was never
            # incremented (premature free at the owner).
            return

        async def _release():
            try:
                client = await self._worker_client(owner)
                await client.call("release_borrow", oid=oid, timeout=30.0)
            except Exception:
                pass

        self._loop.spawn(_release())

    async def handle_register_borrow(self, conn, *, oid: str) -> bool:
        """A remote process holds a ref to an object we own."""
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is None:
                # Likely an escrow window that lapsed before the consumer
                # first deserialized the containing object — the borrow
                # cannot be honored and the consumer's get will fail.
                logger.warning(
                    "register_borrow for already-freed object %s "
                    "(escrow window borrow_escrow_s=%.0fs lapsed?)",
                    oid[:16], ray_config().borrow_escrow_s)
                return False
            entry.refcount += 1
        return True

    async def handle_release_borrow(self, conn, *, oid: str) -> bool:
        self.remove_local_reference(ObjectID(bytes.fromhex(oid)))
        return True

    # ==================================================================
    # objects: put / get / wait
    # ==================================================================
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        if type(value).__name__ == "DTensor":
            raise NotImplementedError(
                "put of a sharded tensor: the sharded put (one store object "
                "per shard, the reference's _put_sharded) comes with a "
                "later slice of the port")
        task_id = TaskID.for_task(self.job_id)
        object_id = ObjectID.for_put(task_id, self._put_counter.next())
        oid = object_id.hex()
        so = serialization.serialize(value)
        entry = self._owned_entry(oid)
        self._store_serialized(oid, so, entry)
        return ObjectRef(object_id, owner=self.address, runtime=self)

    def _store_serialized(self, oid: str, so, entry: _Owned) -> None:
        size = so.total_size()
        if size <= ray_config().max_direct_call_object_size:
            entry.fut.set_result(("inline", so.to_bytes()))
            return
        shm_name = self._loop.run(
            self._raylet.call("create_object", oid=oid, size=size))
        self._shm.write_chunks(shm_name, so.chunks())
        # Fire-and-forget: frames are processed in order on this
        # connection, and remote pulls poll until the seal lands
        # (handle_pull_object), so nothing needs the round trip.
        self._loop.run(self._raylet.notify("seal_object", oid=oid))
        # Remember the segment so a local get() reads it back without a
        # raylet round trip (pull_object exists for REMOTE resolution;
        # a node-local read needs neither the RPC nor any pull-manager
        # bookkeeping). Invalidation: try_attach fails after eviction.
        # The writer also keeps the segment MAPPED (plasma clients keep
        # their store files mmapped): a local get of a just-put object
        # is then a dict hit + np view — no shm_open/mmap on the read
        # path. `_release_shm_mapping` drops it with the last local ref.
        self._local_shm[oid] = {"shm_name": shm_name, "size": size}
        self._shm.try_attach(shm_name)
        if self.raylet_address not in entry.nodes:
            entry.nodes.append(self.raylet_address)
        entry.is_stored = True
        entry.fut.set_result(("node", self.raylet_address))

    def _deserialize_payload(self, data) -> Any:
        return serialization.deserialize(data)

    def _read_local_shm(self, info: dict, oid: Optional[str] = None) -> Any:
        view = self._shm.read(info["shm_name"], info["size"])
        if oid is not None:
            # Remember the mapping so the segment can be unmapped when
            # the last local reference to this object drops (deferred if
            # zero-copy views still alias it).
            self._shm_by_oid[oid] = info["shm_name"]
        return self._deserialize_payload(view)

    async def _resolve_async(self, ref: ObjectRef,
                             timeout: Optional[float]):
        """The IO half of a fetch (local future / raylet pull); returns
        ("inline", bytes) or ("shm", info) without deserializing, so a
        multi-ref get can gather many of these concurrently on the RPC
        loop (reference: batched plasma Get, core_worker.cc:1358-1430)
        and deserialize on the caller's thread."""
        oid = ref.hex()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is not None:
            # NOT wait_for: cancelling the wrapper on timeout propagates
            # into entry.fut (wrap_future chains cancellation), which
            # would permanently poison the ref — a later get() must
            # still be able to succeed. Waiting is SLICED because
            # reconstruction REPLACES entry.fut with a fresh Future
            # without resolving the old one (the same trap
            # _resolve_dependencies polls around): re-read the entry
            # each slice so a reconstructed object still materializes.
            wrapped = asyncio.wrap_future(entry.fut)
            wrapped_fut = entry.fut
            while True:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                slice_t = (0.5 if remaining is None
                           else min(0.5, remaining))
                done, _ = await asyncio.wait({wrapped}, timeout=slice_t)
                if done:
                    kind, payload = wrapped.result()
                    break
                if remaining is not None and remaining <= slice_t:
                    raise GetTimeoutError(f"timed out waiting for {ref}")
                with self._owned_lock:
                    latest = self._owned.get(oid)
                if latest is not None:
                    entry = latest
                # Re-wrap ONLY when the underlying future was replaced
                # (reconstruction): wrapping per slice would chain one
                # callback + abandoned wrapper onto entry.fut per 0.5s
                # of waiting, unboundedly.
                if entry.fut is not wrapped_fut:
                    wrapped = asyncio.wrap_future(entry.fut)
                    wrapped_fut = entry.fut
            if kind == "inline":
                return ("inline", payload, oid)
            # Node-local fast path: an object THIS process wrote to the
            # local store is read straight from its shm segment — no
            # pull_object RPC, no pull-manager admission (the budget is
            # for genuinely remote transfers). try_attach doubles as the
            # eviction check: an unlinked segment fails to attach and we
            # fall through to the raylet, which restores/re-pulls.
            info = self._local_shm.get(oid)
            if info is not None:
                if self._shm.try_attach(info["shm_name"]):
                    if attribution.enabled:
                        attribution.count("get.local_shm")
                    return ("shm", info, oid)
                self._local_shm.pop(oid, None)   # evicted: re-resolve
            # stored on some node; pull through the local raylet
            owner_addr = self.address
        else:
            owner = ref.owner_address
            owner_addr = (owner.decode() if isinstance(owner, bytes)
                          else owner)
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        if attribution.enabled:
            attribution.count("get.pull_rpc")
        try:
            res = await asyncio.wait_for(self._raylet.call(
                "pull_object", oid=oid, owner_address=owner_addr,
                pull_timeout=remaining, timeout=None), remaining)
        except (asyncio.TimeoutError, TimeoutError):
            raise GetTimeoutError(f"timed out fetching {ref}")
        if res is None:
            raise ObjectLostError(oid)
        if res.get("error"):
            if res.get("owner_dead"):
                # The raylet held the pull through the owner-unreachable
                # grace window and the owner never came back: fail the
                # borrower's get LOUDLY with the typed cause instead of
                # a generic loss (reference: owner-died unrecoverable).
                raise OwnerDiedError(oid)
            if "timeout" in res["error"]:
                raise GetTimeoutError(f"timed out fetching {ref}: "
                                      f"{res['error']}")
            raise ObjectLostError(oid)
        if "inline" in res and res["inline"] is not None:
            return ("inline", res["inline"], oid)
        return ("shm", res, oid)

    def _materialize(self, resolved) -> Any:
        kind, payload, oid = resolved
        if kind == "inline":
            return self._deserialize_payload(payload)
        return self._read_local_shm(payload, oid)

    def _read_resolved_local(self, oid: str) -> Any:
        """Thread-local read of an already-landed owned object (inline
        result, or a node-local shm segment we wrote): no event-loop
        round trip — that costs a self-pipe write plus a futex wait per
        call and dominated the sequential-get p50 on syscall-expensive
        hosts. Returns the `_MISS` sentinel when resolution needs IO."""
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is None or not entry.fut.done():
            return _MISS
        kind, payload = entry.fut.result()
        if kind == "inline":
            return self._deserialize_payload(payload)
        info = self._local_shm.get(oid)
        if info is not None and self._shm.try_attach(info["shm_name"]):
            if attribution.enabled:
                attribution.count("get.local_shm")
            return self._read_local_shm(info, oid)
        return _MISS

    def _fetch(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        """Blocking fetch of one object's value (resolved-owned objects
        read on the caller's thread via `_read_resolved_local`)."""
        value = self._read_resolved_local(ref.hex())
        if value is not _MISS:
            return value
        return self._materialize(
            self._loop.run(self._resolve_async(ref, timeout),
                           timeout=None))

    def _in_executing_task(self) -> bool:
        return (self.mode == "worker" and threading.get_ident()
                in self._running_task_threads.values())

    def _notify_block_state(self, blocked: bool) -> None:
        """Tell our raylet this worker's task is blocked in get() (CPU
        released for downstream work) / resumed. Reference:
        NotifyDirectCallTaskBlocked — without it, consumers blocked on
        not-yet-scheduled producers hold every CPU and the node
        deadlocks."""
        method = "worker_blocked" if blocked else "worker_unblocked"
        try:
            self._loop.run(self._raylet.notify(
                method, worker_id=self._raylet_worker_id), timeout=5)
        except Exception:
            pass

    def _get_would_wait(self, refs) -> bool:
        """Cheap pre-check: does this get have a chance of blocking on a
        not-yet-produced object? Resolved owned refs skip the
        blocked/unblocked raylet round trips entirely."""
        ref_list = ([refs] if isinstance(refs, ObjectRef)
                    else refs if isinstance(refs, (list, tuple)) else None)
        if ref_list is None:
            return True
        for ref in ref_list:
            if not isinstance(ref, ObjectRef):
                return True
            with self._owned_lock:
                entry = self._owned.get(ref.hex())
            if entry is None or not entry.fut.done():
                return True
        return False

    def get(self, refs, timeout: Optional[float] = None):
        if self._in_executing_task() and self._get_would_wait(refs):
            with self._blocked_lock:
                self._blocked_depth += 1
                fire = self._blocked_depth == 1
            if fire:
                self._notify_block_state(True)
            try:
                return self._get_inner(refs, timeout)
            finally:
                with self._blocked_lock:
                    self._blocked_depth -= 1
                    fire = self._blocked_depth == 0
                if fire:
                    self._notify_block_state(False)
        return self._get_inner(refs, timeout)

    def _get_inner(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, (ObjectRef, ObjectRefGenerator))
        if not single and not hasattr(refs, "__iter__"):
            raise TypeError(
                "get() expects an ObjectRef or a list of ObjectRefs, got "
                f"{type(refs).__name__}")
        ref_list = [refs] if single else list(refs)
        for ref in ref_list:
            if isinstance(ref, ObjectRefGenerator):
                raise TypeError(
                    "Cannot get() an ObjectRefGenerator; iterate it.")
            if not isinstance(ref, ObjectRef):
                raise TypeError(
                    f"get() expects ObjectRef(s), got {type(ref).__name__}")
        if single or len(ref_list) == 1:
            value = self._fetch(ref_list[0], timeout)
            return value if single else [value]
        # All-resolved fast path: a batched get over refs that are all
        # locally landed (the shape every inline burst produces) reads
        # on the caller thread — no event-loop round trip, no gather of
        # N no-op coroutines. ANY miss falls back to the concurrent
        # resolve below.
        values: List[Any] = []
        for ref in ref_list:
            got = self._read_resolved_local(ref.hex())
            if got is _MISS:
                values = None
                break
            values.append(got)
        if values is not None:
            return values

        async def _resolve_all():
            # Concurrent: N remote objects cost one round-trip latency,
            # not N (the round-3 sequential-get finding).
            return await asyncio.gather(
                *(self._resolve_async(r, timeout) for r in ref_list))

        resolved = self._loop.run(_resolve_all(), timeout=None)
        return [self._materialize(r) for r in resolved]

    async def _ask_owner_locations_batch(self, owner_addr: str,
                                         oids: List[str]):
        client = await self._worker_client(owner_addr)
        return await client.call("get_object_locations_batch", oids=oids,
                                 timeout=10.0)

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        refs = list(refs)
        if len(set(refs)) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        ready: List[ObjectRef] = []
        pending = list(refs)
        tick = 0.002
        while len(ready) < num_returns:
            # Owned refs resolve on local futures (no RPC); borrowed refs
            # are batched into one locations RPC per owner per tick.
            borrowed: Dict[str, List[ObjectRef]] = {}
            for ref in list(pending):
                oid = ref.hex()
                with self._owned_lock:
                    entry = self._owned.get(oid)
                if entry is not None:
                    if entry.fut.done():
                        ready.append(ref)
                        pending.remove(ref)
                    continue
                owner = ref.owner_address
                owner = (owner.decode() if isinstance(owner, bytes)
                         else owner)
                borrowed.setdefault(owner, []).append(ref)
            for owner, owner_refs in borrowed.items():
                if len(ready) >= num_returns:
                    break
                try:
                    locs = self._loop.run(self._ask_owner_locations_batch(
                        owner, [r.hex() for r in owner_refs]), timeout=15)
                except Exception:
                    continue
                for ref in owner_refs:
                    loc = locs.get(ref.hex())
                    if loc is not None and not loc.get("pending"):
                        ready.append(ref)
                        pending.remove(ref)
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(tick)
            tick = min(tick * 2, 0.05)  # back off toward 50 ms
        # Reference contract: ready holds at most num_returns; anything
        # extra that completed in the same scan stays in pending.
        if len(ready) > num_returns:
            extra = ready[num_returns:]
            ready = ready[:num_returns]
            pending = extra + pending
        return ready, pending

    # ==================================================================
    # task submission (reference: direct_task_transport.cc)
    # ==================================================================
    def submit_task(self, remote_function, opts, args, kwargs):
        _t0 = time.perf_counter() if attribution.enabled else 0.0
        fn_key = self._fn.export(remote_function._function)
        if self._inline_eligible(fn_key, opts, args, kwargs):
            return self._submit_inline(remote_function, fn_key, opts,
                                       args, kwargs)
        if attribution.enabled:
            attribution.count("submit.remote")
        if flight.enabled:
            flight.instant("task", "submit",
                           arg=remote_function._function_name)
        task_id = TaskID.for_task(self.job_id)
        streaming = opts.num_returns in ("streaming", "dynamic")
        num_returns = 1 if streaming else opts.num_returns
        args_blob, pinned = self._serialize_args(args, kwargs)
        # Propagate the caller's span so the worker-side execution span
        # parents across the process boundary — INCLUDING unsampled
        # contexts: the head decision must ride the flags byte, or the
        # worker would re-roll sampling per task and record orphan
        # roots. Unsampled propagation is near-free since span() takes
        # the PRNG fast path for it (util/tracing.py).
        trace_ctx = current_traceparent() if tracing_enabled() else None
        spec, sched_key = self._encode_task_spec(
            remote_function, opts, fn_key, num_returns, streaming,
            task_id=task_id.hex(), args=args_blob,
            # TOP-LEVEL arg refs only, for pre-lease dependency
            # resolution (reference: dependency_resolver.h — deps resolve
            # BEFORE a worker is leased, so a blocked dependency never
            # holds a worker slot hostage). Nested refs (inside
            # lists/dicts) are pass-by-reference — the worker never
            # fetches them, so submission must not block on them.
            arg_oids=[a.hex() for a in
                      list(args) + list(kwargs.values())
                      if isinstance(a, ObjectRef)],
            trace_ctx=trace_ctx)
        if attribution.enabled:
            attribution.record("submit.encode", time.perf_counter() - _t0)
        refs = self._make_return_refs(task_id, num_returns)
        gen = None
        if streaming:
            gen = ObjectRefGenerator()
            self._generators[task_id.hex()] = gen
        self._record_task_event(task_id.hex(),
                                remote_function._function_name,
                                "SUBMITTED")
        rec = None
        if not streaming and opts.num_returns != 0 and opts.max_retries > 0:
            # Retain the spec (and keep its arg refs pinned) for lineage
            # re-execution; released when the last return ref is freed —
            # or early, when the reply shows every result landed inline
            # (owner-future values cannot be lost). None when the
            # lineage_reconstruction flag is off.
            rec = self._lineage.retain([r.hex() for r in refs], spec,
                                       pinned, opts.max_retries)
        self._enqueue_submit(
            ("task", spec, refs, pinned if rec is None else None,
             sched_key))
        if streaming:
            return gen
        if opts.num_returns == 0:
            return None
        return refs[0] if opts.num_returns == 1 else refs

    # -- same-process inline fast path (round 8) -----------------------
    def _inline_eligible(self, fn_key: str, opts, args, kwargs) -> bool:
        """Per-task dynamic inline decision (reference: the local-mode
        short circuit, promoted to a cost-model gate). True only when
        the scheduler would co-locate the task anyway AND it is known
        to be tiny:

        - exec-time EMA for this function is KNOWN and below the
          threshold (first calls always go remote and report exec_us in
          their replies — a long or blocking task is never inlined on
          spec);
        - pure-default demand (1 CPU, nothing else): any explicit
          resource/env/placement request means the user asked for a
          scheduling decision, which inlining would bypass;
        - every top-level ObjectRef arg is locally resolved (owned,
          value landed) — anything else needs IO the worker path
          overlaps with other tasks;
        - not streaming (generators hold the caller arbitrarily long).

        `.options(_metadata={"inline": False})` opts a call site out
        (perf.py uses it to keep measuring the remote plane).

        The EMA is arg-size-conditional: keyed by (fn, size bucket).
        """
        ema = self._fn_cost_lookup(fn_key, args, kwargs)
        if ema is None or ema > self._inline_threshold_s:
            return False
        if opts.num_returns in ("streaming", "dynamic"):
            return False
        if (opts.num_cpus != 1.0 or opts.num_gpus or opts.resources
                or opts.memory or opts.runtime_env
                or opts.placement_group is not None
                or opts.scheduling_strategy is not None
                or opts.accelerator_type):
            return False
        md = opts._metadata
        if md is not None and (md.get("inline") is False
                               or md.get("profile")):
            # Profiled tasks always go remote: the pstats dump belongs
            # next to a WORKER log where /api/logs can surface it.
            return False
        for a in args:
            if isinstance(a, ObjectRef) and not self._resolved_locally(a):
                return False
        for a in kwargs.values():
            if isinstance(a, ObjectRef) and not self._resolved_locally(a):
                return False
        return True

    def _resolved_locally(self, ref: ObjectRef) -> bool:
        """True only when the arg's VALUE is readable on this node with
        no IO: an inline payload, or a node-local shm segment we wrote.
        A done future whose copy lives on a REMOTE node is not enough —
        inlining would turn .remote() into a blocking cross-node pull
        on the caller thread."""
        oid = ref.hex()
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is None or not entry.fut.done():
            return False
        kind, _payload = entry.fut.result()
        if kind == "inline":
            return True
        # Stored object: local only if this process holds the segment
        # (liveness re-checked by try_attach at read time; a rare
        # eviction just makes the inline run pull like a worker would).
        return oid in self._local_shm

    def _update_fn_cost(self, fn_key: str, dt: float,
                        arg_bytes: int) -> None:
        """Feed the exec-time EMA, keyed by (fn, arg-size bucket) of the
        serialized args' length."""
        key = (fn_key, _size_bucket(arg_bytes))
        prev = self._fn_cost.get(key)
        self._fn_cost[key] = (dt if prev is None
                              else 0.7 * prev + 0.3 * dt)
        if len(self._fn_cost) > 4096:
            self._fn_cost.clear()  # bounded, simple (re-learns)

    def _fn_cost_lookup(self, fn_key: str, args, kwargs
                        ) -> Optional[float]:
        """Gate-side EMA lookup: estimate the call's arg footprint
        cheaply (no serialization — this runs per submit) and read the
        matching bucket; an unknown bucket inherits *downward* from a
        known-tiny LARGER bucket (a fn observed cheap on bigger args is
        cheap on smaller ones — the converse never holds, so small-arg
        evidence can't promote big-arg calls)."""
        b = _size_bucket(self._arg_size_estimate(args, kwargs))
        ema = self._fn_cost.get((fn_key, b))
        if ema is not None:
            return ema
        for bigger in range(b + 1, len(_SIZE_BUCKETS) + 1):
            bema = self._fn_cost.get((fn_key, bigger))
            if bema is not None and bema <= self._inline_threshold_s:
                return bema
        return None

    @staticmethod
    def _arg_size_estimate(args, kwargs) -> int:
        """Cheap (non-serializing) arg-footprint estimate for bucket
        selection: exact for bytes/str/arrays, shallow for small
        containers, a fixed opaque default otherwise. Only needs to
        land in the right coarse bucket, not be right."""
        total = 0
        items = list(args) + list(kwargs.values())
        for a in items:
            if isinstance(a, (bytes, bytearray, str)):
                total += len(a)
            elif isinstance(a, (int, float, bool)) or a is None:
                total += 8
            elif isinstance(a, ObjectRef):
                total += 64  # passed by reference
            elif hasattr(a, "nbytes"):
                try:
                    total += int(a.nbytes)
                except Exception:
                    total += 512
            elif isinstance(a, (list, tuple, set)) and len(a) <= 64:
                for x in a:
                    if isinstance(x, (bytes, bytearray, str)):
                        total += len(x)
                    elif isinstance(x, (int, float, bool)) or x is None:
                        total += 8
                    else:
                        total += 512
            elif isinstance(a, dict) and len(a) <= 64:
                total += 64 * (len(a) + 1)
            else:
                total += 512
        return total

    def _submit_inline(self, remote_function, fn_key: str, opts,
                       args, kwargs):
        """Execute an inline-eligible task on the caller thread through
        the SAME `_execute_task` the worker runs: task_events and the
        execution span are emitted exactly once, exceptions take the
        identical typed packaging (`_package_error` → RayTaskError
        surfacing at `get`), and results land as real owned ObjectRefs
        — already resolved, no lease, no push, no store round trip for
        inline-sized values."""
        task_id = TaskID.for_task(self.job_id)
        num_returns = opts.num_returns
        args_blob, pinned = self._serialize_args(args, kwargs)
        trace_ctx = current_traceparent() if tracing_enabled() else None
        spec = {
            "task_id": task_id.hex(),
            "job_id": self.job_id.hex(),
            "name": remote_function._function_name,
            "fn_key": fn_key,
            "args": args_blob,
            "num_returns": num_returns,
            "trace_ctx": trace_ctx,
        }
        refs = self._make_return_refs(task_id, num_returns)
        self._record_task_event(task_id.hex(), spec["name"], "SUBMITTED")
        if attribution.enabled:
            attribution.count("submit.inline")
        reply = self._execute_task(spec)
        # Feed the cost model from exec_us (user-code wall time), the
        # same signal remote replies carry — NOT the full inline wall
        # time, whose first run carries one-time costs (job-env fetch,
        # import warmup) that would evict a genuinely tiny function
        # from the inline tier for the next ~7 calls.
        exec_us = reply.get("exec_us")
        if exec_us is not None:
            self._update_fn_cost(fn_key, exec_us / 1e6, len(args_blob))
        if attribution.enabled:
            split = reply.pop("attr_exec", None)
            if split:
                # The caller-thread analogue of the worker split — NOT
                # folded under worker.* so the snapshot keeps the
                # inline-vs-remote budget separable.
                attribution.fold(split, prefix="inline.")
        else:
            reply.pop("attr_exec", None)
        self._record_task_reply(spec, reply)
        # Lineage parity: inline results that were large enough to be
        # sealed into the node store are as losable as remote ones —
        # retain the (lazily wire-encoded) spec for reconstruction and
        # keep the arg pins alive with it, exactly like submit_task's
        # retain branch. Purely-inline results live in the owner future
        # and cannot be lost, so they skip the bookkeeping.
        stored = any(r.get("node") for r in reply.get("results", ()))
        rec = None
        if (stored and opts.max_retries > 0 and num_returns != 0
                and self._lineage.enabled()):
            wire_spec, _ = self._encode_task_spec(
                remote_function, opts, fn_key, num_returns, False,
                task_id=task_id.hex(), args=args_blob,
                arg_oids=[a.hex() for a in
                          list(args) + list(kwargs.values())
                          if isinstance(a, ObjectRef)],
                trace_ctx=trace_ctx)
            rec = self._lineage.retain([r.hex() for r in refs], wire_spec,
                                       pinned, opts.max_retries)
        if rec is None:
            self._unpin_args(pinned)
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def _encode_task_spec(self, remote_function, opts, fn_key: str,
                          num_returns: int, streaming: bool, *,
                          task_id: str, args: bytes, arg_oids: list,
                          trace_ctx: Optional[str]
                          ) -> Tuple[dict, str, Optional[SpecTemplate]]:
        """Wire dict + lease scheduling key for one task submission.

        Template-spec encoding (reference: the TaskSpec invariants
        `direct_task_transport` re-ships unchanged thousands of times):
        the first submission of a (function, options, runtime-env) shape
        builds a fully-validated WireTaskSpec and caches its wire dict;
        repeats copy the template and overwrite only task_id/args/
        arg_oids/trace_ctx. The cache key carries every invariant field,
        so ANY options or runtime-env change misses and re-validates —
        that is the invalidation contract tests/test_unit_spec_template
        pins down."""
        from ray_tpu_torch.core.options import resource_demand

        raw_env = getattr(opts, "runtime_env", None)
        # working_dir/pip envs re-prepare per call (their content can
        # change under the same raw spec — a template would freeze a
        # stale upload key); env_vars-only envs are value-stable and
        # cacheable via their hash.
        cacheable = not raw_env or set(raw_env) <= {"env_vars"}
        resources = resource_demand(opts)
        md = getattr(opts, "_metadata", None)
        profile = bool(md and md.get("profile"))
        tkey = (fn_key, num_returns, streaming, opts.max_retries,
                env_hash(raw_env) if raw_env else "",
                _pg_id_of(getattr(opts, "placement_group", None)),
                getattr(opts, "placement_group_bundle_index", -1),
                tuple(sorted(resources.items())), profile)
        hit = self._spec_templates.get(tkey) if cacheable else None
        if hit is None:
            env = _prepared_env(self, opts)
            pg = tkey[5]
            # Typed wire message (core/wire.py TaskSpec): field presence
            # and types are enforced at construction AND on the
            # receiver's validated decode.
            proto = WireTaskSpec(
                task_id=task_id,
                job_id=self.job_id.hex(),
                fn_key=fn_key,
                name=remote_function._function_name,
                args=args,
                arg_oids=arg_oids,
                num_returns=num_returns,
                streaming=streaming,
                owner=self.address,
                resources=resources,
                max_retries=opts.max_retries,
                runtime_env=env or None,
                pg=(None if pg is None else {
                    "pg_id": pg, "bundle_index": tkey[6]}),
                trace_ctx=trace_ctx,
                profile=profile or None,
            )
            sched_key = self._sched_key_of(proto)
            hit = (SpecTemplate(proto), sched_key)
            if cacheable:
                if len(self._spec_templates) >= 512:
                    self._spec_templates.clear()  # bounded, simple
                self._spec_templates[tkey] = hit
        tmpl, sched_key = hit
        return (tmpl.encode(task_id=task_id, args=args,
                            arg_oids=arg_oids, trace_ctx=trace_ctx),
                sched_key)

    @staticmethod
    def _sched_key_of(spec) -> str:
        """Lease scheduling key (worker-compatibility class) of a task
        spec. Distinct runtime envs never share a leased worker."""
        pg = spec.get("pg")
        key = (f"{spec['fn_key']}:{sorted(spec['resources'].items())}"
               f":{pg['pg_id']}:{pg['bundle_index']}" if pg else
               f"{spec['fn_key']}:{sorted(spec['resources'].items())}")
        return key + f":{env_hash(spec.get('runtime_env'))}"

    def _enqueue_submit(self, item: tuple) -> None:
        """Queue a submission for the RPC loop, coalescing loop wakeups.

        `loop.spawn` per task means one `call_soon_threadsafe` — and one
        self-pipe write syscall — per submission; at 20+ us/syscall on
        virtualized hosts that alone capped the submit rate (measured
        round 5). Appends are GIL-atomic (same discipline as
        deferred_release); one scheduled drain spawns every queued
        submission in FIFO order, so a burst pays one wakeup."""
        if self._shutdown:
            # Unlike dropped releases, a dropped SUBMISSION has
            # observable results — the caller already holds ObjectRefs
            # and a later get() would hang forever. Fail loudly at the
            # submit site. (A stopped-but-not-closed loop accepts the
            # call_soon below and simply never runs it — same silent
            # outcome loop.spawn had — so the flag check, not the
            # except, is what actually covers the shutdown race.)
            raise RuntimeError("runtime is shut down; cannot submit")
        self._pending_submits.append(item)
        if not self._submit_drain_scheduled:
            self._submit_drain_scheduled = True
            try:
                self._loop.call_soon(self._drain_submits)
            except Exception:
                self._submit_drain_scheduled = False
                raise  # loop closed: surface at the submit call site

    def _drain_submits(self) -> None:
        while True:
            while self._pending_submits:
                item = self._pending_submits.popleft()
                if item[0] == "task":
                    _, spec, refs, pinned, sched_key = item
                    asyncio.ensure_future(self._submit_async(
                        spec, refs, pinned, sched_key=sched_key))
                else:
                    _, spec, refs, pinned = item
                    asyncio.ensure_future(
                        self._submit_actor_async(spec, refs, pinned))
            # Going idle: clear the armed flag FIRST, then re-check the
            # queue. An enqueue racing the final empty check either saw
            # the flag still armed (caught by this re-check — the
            # burst's LAST submission must not wait for the next
            # enqueue's wakeup) or saw it cleared and scheduled a fresh
            # drain itself. The previous scheme cleared at drain ENTRY,
            # which made every mid-drain enqueue schedule a spurious
            # extra wakeup — one self-pipe syscall per task in a
            # sustained cross-thread burst.
            self._submit_drain_scheduled = False
            if not self._pending_submits:
                return
            self._submit_drain_scheduled = True

    def _make_return_refs(self, task_id: TaskID,
                          num_returns: int) -> List[ObjectRef]:
        """Create owner entries BEFORE the ObjectRefs so each ref's
        constructor registers a local reference (baseline refcount 1);
        otherwise a later pin/unpin cycle can free a still-live ref."""
        refs = []
        for i in range(max(num_returns, 1)):
            oid = ObjectID.for_return(task_id, i + 1)
            self._owned_entry(oid.hex())
            refs.append(ObjectRef(oid, owner=self.address, runtime=self))
        return refs

    _empty_args_blob: Optional[bytes] = None

    def _serialize_args(self, args, kwargs) -> Tuple[bytes, List[ObjectID]]:
        """Serialize task arguments, pinning every contained ObjectRef so the
        owner does not free it while the task spec is in flight (reference:
        reference_count.h submitted-task counts)."""
        if not args and not kwargs:
            # Zero-arg calls share one precomputed blob: nothing to pin,
            # and the ~25 us cloudpickle pass is identical every time.
            blob = ClusterRuntime._empty_args_blob
            if blob is None:
                blob = ClusterRuntime._empty_args_blob = (
                    serialization.serialize(((), {})).to_bytes())
            return blob, []
        pinned: List[ObjectID] = []
        blob = serialization.serialize(
            (args, kwargs),
            ref_serializer=lambda r: pinned.append(r.id())).to_bytes()
        for oid in pinned:
            self.add_local_reference(oid)
        return blob, pinned

    def _unpin_args(self, pinned: List[ObjectID]) -> None:
        for oid in pinned:
            self.remove_local_reference(oid)

    async def _resolve_dependencies(self, spec: dict) -> None:
        """Wait until every OWNED arg object exists (inline value or a
        stored copy) before leasing a worker (reference:
        dependency_resolver.h via direct_task_transport.cc:24). Without
        this, a task whose upstream is being reconstructed occupies a
        worker slot while it pulls — and a chain of such tasks can
        starve the very re-executions that would unblock them
        (chaos-suite deadlock). Borrowed refs (owned elsewhere) resolve
        worker-side as before."""
        for oid in spec.get("arg_oids", ()):
            while True:
                with self._owned_lock:
                    entry = self._owned.get(oid)
                    ready = entry is None or entry.fut.done()
                if ready:
                    break
                # Poll: entry.fut can be REPLACED by a reconstruction
                # reset, so awaiting one future instance would hang.
                await asyncio.sleep(0.02)

    async def _submit_async(self, spec: dict, refs: List[ObjectRef],
                            pinned: Optional[List[ObjectID]] = None,
                            sched_key: Optional[str] = None) -> None:
        retries = spec.get("max_retries", 0)
        attempt = 0
        try:
            while True:
                try:
                    # (Re-)resolve on every attempt: a retry often means
                    # a node died, taking this task's upstream objects
                    # with it.
                    await self._resolve_dependencies(spec)
                    await self._run_on_leased_worker(spec, sched_key)
                    return
                except (ConnectionLost, RpcError, TimeoutError,
                        asyncio.TimeoutError, OSError) as e:
                    # TimeoutError/OSError cover leases stranded on a
                    # node that died while the request was queued there
                    # — transient cluster faults, retryable like a
                    # dropped connection (chaos-suite finding).
                    if spec["task_id"] in self._cancel_requested:
                        # A force-cancel kills the worker mid-task; that
                        # must surface as cancellation, not retry.
                        self._fail_task_cancelled(spec, refs)
                        return
                    attempt += 1
                    if attempt > max(retries, 0):
                        oom = isinstance(e, _WorkerOOMKilled)
                        self._fail_task(
                            spec, refs,
                            ("killed by the memory monitor (node OOM); "
                             "retries exhausted" if oom else
                             f"worker died ({e}); retries exhausted"),
                            oom=oom)
                        return
                    logger.info("retrying task %s (attempt %d): %s",
                                spec["name"], attempt, e)
                    delay = ray_config().task_retry_delay_ms / 1000.0
                    if delay:
                        await asyncio.sleep(delay)
                except _TaskCancelledBeforePush:
                    self._fail_task_cancelled(spec, refs)
                    return
                except Exception as e:  # noqa: BLE001
                    self._fail_task(spec, refs, f"submission failed: {e}")
                    return
        finally:
            if pinned:
                self._unpin_args(pinned)

    def _fail_task_cancelled(self, spec: dict,
                             refs: List[ObjectRef]) -> None:
        self._cancel_requested.discard(spec["task_id"])
        err = serialization.serialize_error(
            TaskCancelledError(spec["task_id"]))
        blob = err.to_bytes()
        for r in refs:
            entry = self._owned_entry(r.hex())
            if not entry.fut.done():
                entry.fut.set_result(("inline", blob))
        gen = self._generators.pop(spec["task_id"], None)
        if gen is not None:
            gen._finish(TaskCancelledError(spec["task_id"]))

    async def _worker_was_oom_killed(self, worker: dict) -> bool:
        # Short dial: if the worker died because its whole NODE died,
        # this probe must cost ~2s, not a full connect window per retry.
        try:
            client = await self._raylet_client(worker["raylet_address"],
                                               connect_timeout=2.0)
            cause = await client.call("worker_death_cause",
                                      worker_id=worker["worker_id"],
                                      timeout=5.0)
        except Exception:
            return False
        return cause == "oom"

    def _fail_task(self, spec: dict, refs: List[ObjectRef],
                   message: str, oom: bool = False) -> None:
        from ray_tpu_torch.exceptions import OutOfMemoryError, WorkerCrashedError
        exc_cls = OutOfMemoryError if oom else WorkerCrashedError
        err = serialization.serialize_error(
            exc_cls(f"task {spec['name']}: {message}"))
        blob = err.to_bytes()
        for r in refs:
            entry = self._owned_entry(r.hex())
            if not entry.fut.done():
                entry.fut.set_result(("inline", blob))
        gen = self._generators.pop(spec["task_id"], None)
        if gen is not None:
            from ray_tpu_torch.exceptions import WorkerCrashedError as WCE
            gen._finish(WCE(f"task {spec['name']}: {message}"))

    async def _run_on_leased_worker(self, spec: dict,
                                    sched_key: Optional[str] = None
                                    ) -> None:
        # The submit path hands the template-cached scheduling key down;
        # resubmits (lineage re-execution) recompute it.
        key = sched_key if sched_key is not None else self._sched_key_of(
            spec)
        _t0 = time.perf_counter() if attribution.enabled else 0.0
        _m0 = time.monotonic() if flight.enabled else 0.0
        worker = await self._acquire_worker(key, spec["resources"],
                                            pg=spec.get("pg"))
        if attribution.enabled:
            attribution.record("submit.lease", time.perf_counter() - _t0)
        if flight.enabled:
            flight.record("lease", "acquire",
                          dur_us=int((time.monotonic() - _m0) * 1e6),
                          arg=worker.get("worker_id", "")[:8], t=_m0)
        if spec["task_id"] in self._cancel_requested:
            # Cancelled while queued for a lease: never push.
            self._offer_worker(key, worker)
            raise _TaskCancelledBeforePush()
        if worker.get("chip_ids"):
            spec = (spec.replace(visible_chips=worker["chip_ids"])
                    if hasattr(spec, "replace")
                    else dict(spec, visible_chips=worker["chip_ids"]))
        self._inflight_task_workers[spec["task_id"]] = (
            worker["worker_address"], False)
        worker["pipeline"] = worker.get("pipeline", 0) + 1
        push_t0 = time.monotonic()
        worker["push_started"] = push_t0
        worker["push_task_name"] = spec.get("name")
        try:
            client = await self._worker_client(worker["worker_address"])
            # Pipelining: once the push is on the wire the lease goes
            # back into circulation (bounded by worker_pipeline_depth),
            # so the worker's execution queue stays fed across the
            # push/reply round trip instead of idling one RTT per task.
            # _offer_worker gates this on the worker's observed service
            # time — queueing behind a LONG task would serialize work
            # that fresh leases (and spillback) could run in parallel.
            self._offer_worker(key, worker)
            reply = await client.call(
                "push_task",
                spec=(to_wire(spec) if hasattr(spec, "_wire_name")
                      else spec),
                timeout=None)
        except BaseException as push_err:
            # BaseException on purpose: a CancelledError that skipped the
            # decrement would wedge the lease at pipeline>0 forever — the
            # linger loop then never returns it and the raylet's CPUs
            # leak (observed as a cluster-wide scheduling stall).
            worker["pipeline"] -= 1
            if isinstance(push_err, Exception):
                worker["dead"] = True
                if not worker.get("returned"):
                    worker["returned"] = True
                    # Fire-and-forget: retrying against a DEAD raylet
                    # takes tens of seconds; the task's resubmission
                    # must not stall behind it.
                    self._loop.spawn(
                        self._return_worker(worker, dead=True))
                if await self._worker_was_oom_killed(worker):
                    raise _WorkerOOMKilled(str(push_err)) from push_err
            raise
        finally:
            self._inflight_task_workers.pop(spec["task_id"], None)
        # Only a completed task clears its cancel flag — on a push
        # failure _submit_async must still see it to suppress the retry.
        self._cancel_requested.discard(spec["task_id"])
        worker["pipeline"] -= 1
        # Per-worker service-time EMA (push->reply, which bounds task
        # duration): drives the deep-pipelining gate in _offer_worker.
        rtt = time.monotonic() - push_t0
        prev = worker.get("svc_ema")
        worker["svc_ema"] = (rtt if prev is None
                             else 0.7 * prev + 0.3 * rtt)
        if attribution.enabled:
            attribution.record("submit.push_rtt", rtt)
        if flight.enabled:
            flight.record("task", "push_rtt", dur_us=int(rtt * 1e6),
                          arg=spec.get("name"), t=push_t0)
        # Feed the inline cost model: exec_us rides every task reply (a
        # single int), so the EMA converges to the TRUE exec time — a
        # function that went remote because of one slow run can earn
        # its way back under the inline threshold.
        exec_us = reply.get("exec_us") if isinstance(reply, dict) else None
        if exec_us is not None and spec.get("fn_key"):
            args_blob = spec.get("args")
            self._update_fn_cost(spec["fn_key"], exec_us / 1e6,
                                 len(args_blob) if args_blob else 0)
        self._record_task_reply(spec, reply)
        self._offer_worker(key, worker)

    def _spawn_bg(self, coro) -> None:
        """ensure_future with a strong reference held until done (must
        run on the loop thread)."""
        t = asyncio.ensure_future(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    def _record_task_reply(self, spec: dict, reply: dict) -> None:
        task_id = spec["task_id"]
        if attribution.enabled:
            attr = reply.get("attr")
            if attr:
                # Worker-side decode/execute timings ride the reply (a
                # couple of ints, only in attribution mode) so the
                # driver's snapshot covers both sides of the wire.
                attribution.fold(attr)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("task reply %s (%s): %s", spec.get("name"),
                         task_id[:12],
                         [(r.get("oid", "")[:16], r.get("node"),
                           ("inline" if r.get("inline") is not None
                            else "-")) for r in reply.get("results", [])])
        results = reply.get("results", [])
        for res in results:
            entry = self._owned_entry(res["oid"])
            if res.get("node"):
                if res["node"] not in entry.nodes:
                    entry.nodes.append(res["node"])
                entry.is_stored = True
                if not entry.fut.done():
                    entry.fut.set_result(("node", res["node"]))
            else:
                if not entry.fut.done():
                    entry.fut.set_result(("inline", res["inline"]))
        if results and not any(res.get("node") for res in results):
            # Every result landed inline: the owner futures hold the
            # values and nothing is ever losable — release the lineage
            # record (and its arg pins) now instead of carrying the spec
            # until the refs die. Retention is for STORE-SEALED results.
            rec = self._lineage.get(results[0]["oid"])
            if rec is not None:
                self._unpin_args(self._lineage.drop_record(rec))
        if spec.get("streaming") and reply.get("done"):
            gen = self._generators.pop(task_id, None)
            if gen is not None:
                err = reply.get("error_blob")
                if err is not None:
                    try:
                        self._deserialize_payload(err)
                        exc = None
                    except BaseException as e:  # noqa: BLE001
                        exc = e
                    gen._finish(exc)
                else:
                    gen._finish()

    # -- lease pool ----------------------------------------------------
    async def _acquire_worker(self, key: str, resources: Dict[str, float],
                              pg: Optional[dict] = None) -> dict:
        """Grab a leased worker for this scheduling key: an idle one
        immediately, else queue and keep up to MAX_INFLIGHT lease
        requests pipelined to the raylet. Completed tasks hand their
        worker straight to the next waiter (no raylet round trip) — this
        is what makes a burst of small same-shape tasks run at worker
        speed instead of lease-RPC speed."""
        pool = self._lease_pools.setdefault(key, _LeasePool())
        while pool.idle:
            worker = pool.idle.pop()
            if worker.get("dead"):
                continue  # died while idling (e.g. OOM-killed mid-pipeline)
            worker["avail"] = False
            return worker
        fut = asyncio.get_running_loop().create_future()
        pool.waiters.append(fut)
        # Coalesced pump (same discipline as _drain_submits): a burst
        # of acquires lands as N waiters in THIS loop pass, and the one
        # deferred pump then sees them all — that is what lets a
        # batched lease RPC carry the whole burst instead of want=1
        # per waiter.
        self._schedule_pump(pool, resources, pg)
        return await fut

    def _schedule_pump(self, pool: _LeasePool,
                       resources: Dict[str, float],
                       pg: Optional[dict]) -> None:
        if pool.pump_scheduled:
            return
        pool.pump_scheduled = True

        def _run() -> None:
            pool.pump_scheduled = False
            self._pump_leases(pool, resources, pg)

        asyncio.get_running_loop().call_soon(_run)

    def _pump_leases(self, pool: _LeasePool,
                     resources: Dict[str, float],
                     pg: Optional[dict]) -> None:
        """Keep lease requests pipelined for every queued waiter: RPCs
        are bounded by MAX_INFLIGHT, and each asks for up to
        lease_batch_max grants (one round trip leases a whole burst's
        workers; a PG-bundle lease stays single-grant)."""
        batch_max = self._lease_batch_max if pg is None else 1
        # Expected grants are bounded by min(waiters, MAX_INFLIGHT):
        # batching collapses the RPC count for a burst, never
        # multiplies the raylet's queue churn past what single grants
        # would have caused.
        allowance = min(len(pool.waiters), pool.MAX_INFLIGHT)
        while (pool.inflight_rpcs < pool.MAX_INFLIGHT
               and pool.inflight_leases < allowance):
            want = min(allowance - pool.inflight_leases, batch_max)
            pool.inflight_leases += want
            pool.inflight_rpcs += 1
            asyncio.ensure_future(
                self._fetch_lease(pool, resources, pg, want))

    async def _fetch_lease(self, pool: _LeasePool,
                           resources: Dict[str, float],
                           pg: Optional[dict], want: int = 1) -> None:
        try:
            bundle = None
            address = None
            if pg is not None:
                address, idx = await self._pg_location(
                    pg["pg_id"], pg["bundle_index"], demand=resources)
                bundle = (pg["pg_id"], idx)
            workers = await self._lease_request_loop(
                resources, want, bundle=bundle, address=address)
        except Exception as e:  # noqa: BLE001
            pool.inflight_rpcs -= 1
            pool.inflight_leases -= want
            for i, fut in enumerate(pool.waiters):
                if not fut.done():
                    pool.waiters.pop(i)
                    fut.set_exception(e)
                    break
            # Surplus waiters beyond MAX_INFLIGHT still need lease
            # requests of their own — without this re-pump they would
            # wait forever once every inflight request has failed.
            self._pump_leases(pool, resources, pg)
            return
        pool.inflight_rpcs -= 1
        pool.inflight_leases -= want
        if attribution.enabled and want > 1:
            attribution.value("lease.batch_size", len(workers))
        for worker in workers:
            self._hand_worker(pool, worker)
        # Partial grant ONLY (the raylet had fewer immediately-
        # grantable workers than asked): the shortfall's waiters lost
        # their expected grant and need fresh requests. A full grant
        # never re-pumps — surplus waiters beyond the pipelining cap
        # are served by lease REUSE, the contract
        # tests/test_unit_lease_pool pins.
        if len(workers) < want and pool.waiters:
            self._pump_leases(pool, resources, pg)

    def _offer_worker(self, key: str, worker: dict) -> None:
        """Put a leased worker (back) into circulation if it is alive,
        not already circulating, and has pipeline window left. Workers
        whose tasks are slow (or of unknown duration beyond the first)
        only circulate when their queue is empty — fresh leases and
        spillback handle the parallelism instead."""
        if worker.get("dead") or worker.get("avail"):
            return
        pipeline = worker.get("pipeline", 0)
        if pipeline >= self._pipeline_depth:
            return
        if pipeline > 0:
            ema = worker.get("svc_ema")
            # Deep pipelining (offering a still-executing worker) only
            # pays off for tasks shorter than a lease round trip.
            if ema is None or ema > self._pipeline_svc_threshold:
                return  # don't queue behind an unknown/slow task
        pool = self._lease_pools.setdefault(key, _LeasePool())
        self._hand_worker(pool, worker)

    def _hand_worker(self, pool: _LeasePool, worker: dict) -> None:
        if worker.get("dead"):
            return
        while pool.waiters:
            fut = pool.waiters.pop(0)
            if not fut.done():
                worker["avail"] = False  # exclusively promised
                fut.set_result(worker)
                return
        worker["avail"] = True
        pool.idle.append(worker)
        asyncio.ensure_future(self._linger_then_return(pool, worker))

    async def _linger_then_return(self, pool: _LeasePool,
                                  worker: dict) -> None:
        """An idle lease is kept briefly for reuse, then returned so the
        raylet can reschedule its resources."""
        await asyncio.sleep(ray_config().lease_idle_linger_s)
        lingered = 0.0
        while worker in pool.idle and worker.get("pipeline", 0) > 0:
            # Pipelined pushes still executing: the lease cannot be
            # returned yet. Bounded wait — a pipeline counter that never
            # drains (accounting bug, wedged push) must not pin the
            # raylet's resources forever; force-return past the cap.
            if lingered > 10.0:
                logger.warning(
                    "lease %s idle with pipeline=%s for %.0fs; "
                    "force-returning it",
                    worker.get("lease_id"), worker.get("pipeline"),
                    lingered)
                break
            await asyncio.sleep(0.25)
            lingered += 0.25
        if worker not in pool.idle:
            return
        pool.idle.remove(worker)
        worker["avail"] = False
        if not worker.get("returned"):
            worker["returned"] = True
            await self._return_worker(worker)

    async def _lease_request_loop(self, resources: Dict[str, float],
                                  n: int, is_actor: bool = False,
                                  bundle: Optional[Tuple[str, int]] = None,
                                  address: Optional[str] = None
                                  ) -> List[dict]:
        """The one lease-request state machine, single or batched
        (n > 1 → request_worker_leases; the reply may be a partial
        grant, and the caller re-pumps): connect dial policy, spillback
        chain, cancel-on-timeout and grant bookkeeping live HERE so the
        two paths can never drift."""
        address = address or self.raylet_address
        # PG-bundle leases are pinned to their reserved node; everything
        # else reached via a non-local address is a spillback target.
        pinned_address = address != self.raylet_address
        spillbacks = 0
        request_id = uuid.uuid4().hex
        while True:
            try:
                # Spillback targets get a short dial: a freshly-dead node
                # (stale cluster view) must cost ~2s, not a full connect
                # window per retry — fall back to the local raylet, whose
                # view refreshes within the health-check period.
                # Local and PG-pinned addresses keep the full window.
                is_spillback_target = (not pinned_address
                                       and address != self.raylet_address)
                client = await self._raylet_client(
                    address,
                    connect_timeout=2.0 if is_spillback_target else 10.0)
            except (ConnectionLost, OSError):
                if pinned_address or address == self.raylet_address:
                    raise
                address = self.raylet_address
                spillbacks += 1
                continue
            try:
                reply = await client.call(
                    "request_worker_lease" if n == 1
                    else "request_worker_leases",
                    req=to_wire(WireLeaseRequest(
                        resources=resources, is_actor=is_actor,
                        spillback_count=spillbacks,
                        bundle=list(bundle) if bundle else None,
                        request_id=request_id,
                        job_id=self.job_id.hex(), count=n)),
                    timeout=ray_config().worker_lease_timeout_ms / 1000.0)
            except (TimeoutError, asyncio.TimeoutError):
                # Tell the raylet we gave up: drop the queued request, or
                # return the worker(s) if granted concurrently — the
                # raylet records every grant of this request_id, so one
                # cancel covers a whole batch (a timed-out client must
                # not leak N workers).
                try:
                    await client.call("cancel_lease_request",
                                      request_id=request_id, timeout=5.0)
                except Exception:
                    pass
                raise
            grants = reply.get("grants") or (
                [reply["granted"]] if reply.get("granted") else None)
            if grants:
                for info in grants:
                    info["raylet_address"] = address
                    if not is_actor:
                        # Actor leases live as long as the actor; only
                        # task leases are watchdog-swept for orphaning.
                        self._live_leases.append(info)
                return grants
            if reply.get("spillback"):
                address = reply["spillback"]
                spillbacks += 1
                continue
            raise RpcError(f"lease failed: {reply}")

    async def _lease_watchdog(self) -> None:
        """Self-healing for leaked leases: any granted lease that is not
        circulating (not in a pool, no waiter promise), has no in-flight
        push, and has sat that way for 20s is orphaned — some
        acquire/offer path lost track of it — and pins raylet resources
        forever, starving every other scheduling key. Force-return it
        and log loudly so the underlying leak is visible."""
        while True:
            await asyncio.sleep(5.0)
            now = time.monotonic()
            for worker in list(self._live_leases):
                if worker.get("returned"):
                    try:
                        self._live_leases.remove(worker)
                    except ValueError:
                        pass
                    continue
                if worker.get("pipeline", 0) > 0:
                    # Push(es) in flight: healthy — unless one has been
                    # outstanding implausibly long; then report the
                    # connection state so wedges are diagnosable.
                    started = worker.get("push_started", now)
                    if now - started > 30.0:
                        client = (self._worker_clients or {}).get(
                            worker.get("worker_address"))
                        logger.warning(
                            "lease %s: push of %r in flight for %.0fs "
                            "(worker %s, client_connected=%s, "
                            "pipeline=%s)",
                            worker.get("lease_id"),
                            worker.get("push_task_name"),
                            now - started, worker.get("worker_address"),
                            None if client is None else client.connected,
                            worker.get("pipeline"))
                    worker.pop("wd_idle_since", None)
                    continue
                if worker.get("dead") or worker.get("avail"):
                    worker.pop("wd_idle_since", None)
                    continue
                since = worker.get("wd_idle_since")
                if since is None:
                    worker["wd_idle_since"] = now
                    continue
                if now - since < 20.0:
                    continue
                logger.warning(
                    "lease %s orphaned for %.0fs (not circulating, no "
                    "in-flight push); force-returning it",
                    worker.get("lease_id"), now - since)
                worker["dead"] = True  # never recirculate
                worker["returned"] = True
                try:
                    self._live_leases.remove(worker)
                except ValueError:
                    pass
                await self._return_worker(worker)

    async def _return_worker(self, worker: dict, dead: bool = False) -> None:
        item = {"lease_id": worker["lease_id"],
                "worker_id": worker["worker_id"],
                "resources": worker.get("resources", {}),
                "dead": dead}
        address = worker["raylet_address"]
        # Batched lease returns: a burst's returns land as N items in
        # THIS loop pass and the one deferred flush sends them as a
        # single return_worker_leases RPC — the mirror of the grant
        # batch, same deferred-pump discipline as _schedule_pump.
        batch = self._pending_lease_returns.get(address)
        if batch is None:
            batch = self._pending_lease_returns[address] = {
                "items": [],
                "fut": asyncio.get_running_loop().create_future()}
            asyncio.get_running_loop().call_soon(
                lambda: self._spawn_bg(
                    self._flush_lease_returns(address)))
        batch["items"].append(item)
        await batch["fut"]

    async def _flush_lease_returns(self, address: str) -> None:
        batch = self._pending_lease_returns.pop(address, None)
        if batch is None:
            return
        if attribution.enabled and len(batch["items"]) > 1:
            attribution.value("lease.return_batch", len(batch["items"]))
        if flight.enabled:
            flight.instant("lease", "return", arg=len(batch["items"]))
        try:
            await self._send_lease_returns(address, batch["items"])
        finally:
            if not batch["fut"].done():
                batch["fut"].set_result(None)

    async def _send_lease_returns(self, address: str,
                                  items: List[dict]) -> None:
        # A lost return leaks the lease's resources at the raylet FOREVER
        # (observed: returns timing out against a raylet busy with bulk
        # object IO starved a whole module's scheduling). Retry with
        # backoff — both return handlers are idempotent — and log loudly
        # if the lease(s) could not be returned.
        last: Optional[Exception] = None
        for attempt in range(4):
            if attempt:
                await asyncio.sleep(0.5 * attempt)
            try:
                client = await self._raylet_client(address)
                if len(items) == 1:
                    it = items[0]
                    await client.call("return_worker",
                                      lease_id=it["lease_id"],
                                      worker_id=it["worker_id"],
                                      resources=it["resources"],
                                      dead=it["dead"], timeout=10.0)
                else:
                    await client.call("return_worker_leases",
                                      returns=items, timeout=10.0)
                return
            except Exception as e:  # noqa: BLE001
                last = e
        logger.warning("could not return lease(s) %s to %s after retries "
                       "(%s); their resources may be stranded",
                       [it.get("lease_id") for it in items],
                       address, last)

    # -- clients -------------------------------------------------------
    async def _raylet_client(self, address: str,
                             connect_timeout: float = 10.0) -> RpcClient:
        client = self._raylet_clients.get(address)
        if client is not None and client.connected:
            return client
        async with self._client_lock(address):
            client = self._raylet_clients.get(address)
            if client is None or not client.connected:
                client = RpcClient(address)
                await client.connect(timeout=connect_timeout)
                self._raylet_clients[address] = client
        return client

    _worker_client_cache: Dict[str, RpcClient]

    async def _worker_client(self, address: str,
                             connect_timeout: float = 10.0) -> RpcClient:
        cache = getattr(self, "_worker_clients", None)
        if cache is None:
            cache = self._worker_clients = {}
        client = cache.get(address)
        if client is not None and client.connected:
            return client
        # One connect per address at a time: concurrent first calls
        # (a burst of streams to one owner) would each make a client,
        # and all but the cached one would live on only through their
        # callers' frames, a cycle the collector may end mid-call (an
        # asyncio stream reader is held weakly by its protocol).
        async with self._client_lock(address):
            client = cache.get(address)
            if client is None or not client.connected:
                # A peer that was reached before and dropped its
                # connection has died: one second of retries finds that
                # out (the full window is for a worker still starting).
                timeout = (connect_timeout if client is None
                           else min(connect_timeout, 1.0))
                client = RpcClient(address)
                await client.connect(timeout=timeout)
                cache[address] = client
        return client

    def _client_lock(self, address: str) -> asyncio.Lock:
        locks = getattr(self, "_client_locks", None)
        if locks is None:
            locks = self._client_locks = {}
        lock = locks.get(address)
        if lock is None:
            lock = locks[address] = asyncio.Lock()
        return lock

    # ==================================================================
    # actors (reference: actor lifecycle gcs_actor_manager.h:251, direct
    # actor transport; creation here is owner-led)
    # ==================================================================
    def create_actor(self, actor_class, opts, args, kwargs):
        from ray_tpu_torch.core.actor import ActorHandle
        from ray_tpu_torch.core.options import resource_demand

        actor_id = ActorID.of(self.job_id)
        aid = actor_id.hex()
        cls_key = self._fn.export(actor_class._cls)
        meta = actor_class.method_meta()
        # Placement needs 1 CPU when nothing is specified; the running actor
        # then holds only its explicit demand (reference actor defaults).
        running_demand = resource_demand(opts)
        demand = running_demand or {"CPU": 1.0}
        detached = opts.lifetime == "detached"
        if opts.lifetime not in (None, "detached", "non_detached"):
            raise ValueError(
                f"lifetime must be None, 'detached' or 'non_detached', "
                f"got {opts.lifetime!r}")
        if detached and not opts.name:
            raise ValueError(
                "detached actors must be named: they are reached via "
                "get_actor(name) after their creator exits")
        info = {
            "class_name": actor_class._class_name,
            "name": opts.name,
            "namespace": (self.namespace if opts.namespace is None
                          else opts.namespace),
            "owner": self.address,
            "state": "PENDING",
            "max_restarts": opts.max_restarts,
            "max_task_retries": opts.max_task_retries,
            "job_id": self.job_id.hex(),
            "detached": detached,
            "method_meta": {k: {kk: vv for kk, vv in m.items()}
                            for k, m in meta.items()},
        }
        reply = self._loop.run(self._gcs.register_actor(aid, info))
        if not reply.get("ok"):
            raise ValueError(reply.get("error", "actor registration failed"))

        state = _ActorState(aid)
        state.restarts_remaining = opts.max_restarts
        state.task_retries = opts.max_task_retries
        args_blob, pinned = self._serialize_args(args, kwargs)
        state.creation = {
            "cls_key": cls_key,
            "args": args_blob,
            "detached": detached,
            "demand": demand,
            "release_after_start": {} if running_demand else demand,
            "max_concurrency": opts.max_concurrency,
            "concurrency_groups": opts.concurrency_groups,
            "runtime_env": _prepared_env(self, opts),
            "class_name": actor_class._class_name,
            "pg": ({"pg_id": _pg_id_of(opts.placement_group),
                    "bundle_index": getattr(
                        opts, "placement_group_bundle_index", -1)}
                   if getattr(opts, "placement_group", None) is not None
                   else None),
        }
        self._actors[aid] = state
        # Constructor-arg refs stay pinned for the actor's whole life: a
        # restart replays creation["args"], so they must survive until the
        # actor is terminally DEAD (r2 review finding).
        state.pinned_args = pinned
        self._actor_meta[aid] = (actor_class._class_name, meta)
        try:
            self._loop.run(self._create_actor_async(state))
        except BaseException:
            self._unpin_actor(state)
            raise
        if state.state == "DEAD":
            self._unpin_actor(state)
        return ActorHandle(actor_id, actor_class._class_name, meta,
                           runtime=self)

    def _unpin_actor(self, state: _ActorState) -> None:
        pinned, state.pinned_args = state.pinned_args, []
        self._unpin_args(pinned)

    async def _create_actor_async(self, state: _ActorState) -> None:
        creation = state.creation
        pg = creation.get("pg")
        bundle = None
        address = None
        if pg is not None:
            address, idx = await self._pg_location(
                pg["pg_id"], pg["bundle_index"], demand=creation["demand"])
            bundle = (pg["pg_id"], idx)
        # Lease timeouts are transient (busy/recovering cluster): retry a
        # few times before declaring the creation failed, like task
        # submission does.
        attempt = 0
        while True:
            try:
                worker = (await self._lease_request_loop(
                    creation["demand"], 1, is_actor=True, bundle=bundle,
                    address=address))[0]
                break
            except (TimeoutError, asyncio.TimeoutError, OSError,
                    ConnectionLost):
                # RpcError refusals (infeasible demand, missing bundle)
                # are deterministic — retrying them only delays the real
                # error.
                attempt += 1
                if attempt > 3:
                    raise
                await asyncio.sleep(
                    ray_config().task_retry_delay_ms / 1000.0 or 0.2)
        client = await self._worker_client(worker["worker_address"])
        try:
            reply = await client.call(
                "actor_init", actor_id=state.actor_id_hex,
                cls_key=creation["cls_key"], args=creation["args"],
                max_concurrency=creation["max_concurrency"],
                owner=self.address, job_id=self.job_id.hex(),
                visible_chips=worker.get("chip_ids") or None,
                concurrency_groups=creation.get("concurrency_groups"),
                runtime_env=creation.get("runtime_env"),
                timeout=120.0)
        except Exception as e:
            await self._return_worker(worker, dead=True)
            await self._gcs.update_actor(state.actor_id_hex, {
                "state": "DEAD", "death_cause": f"init push failed: {e}"})
            raise
        if reply.get("error_blob") is not None:
            await self._return_worker(worker, dead=False)
            await self._gcs.update_actor(state.actor_id_hex, {
                "state": "DEAD", "death_cause": "exception in __init__"})
            state.state = "DEAD"
            # Surface the constructor error to the caller now.
            self._deserialize_payload(reply["error_blob"])
            return
        raylet_client = await self._raylet_client(worker["raylet_address"])
        await raylet_client.call(
            "mark_actor_worker", worker_id=worker["worker_id"],
            actor_id=state.actor_id_hex,
            release=creation.get("release_after_start") or None,
            job_id=self.job_id.hex(),
            detached=creation.get("detached", False), timeout=5.0)
        state.address = worker["worker_address"]
        state.client = client
        state.state = "ALIVE"
        await self._gcs.update_actor(state.actor_id_hex, {
            "state": "ALIVE", "address": worker["worker_address"],
            "node_id": worker["node_id"], "worker_id": worker["worker_id"],
        })

    def submit_actor_task(self, handle, method_name, opts, args, kwargs):
        _t0 = time.perf_counter() if attribution.enabled else 0.0
        aid = handle._ray_actor_id.hex()
        task_id = TaskID.for_actor_task(handle._ray_actor_id)
        streaming = opts.num_returns in ("streaming", "dynamic")
        num_returns = 1 if streaming else opts.num_returns
        args_blob, pinned = self._serialize_args(args, kwargs)
        with self._actor_seq_lock:
            seq = self._actor_call_seq.get(aid, 0)
            self._actor_call_seq[aid] = seq + 1
        trace_ctx = current_traceparent() if tracing_enabled() else None
        tkey = (aid, method_name, num_returns, streaming)
        tmpl = self._actor_templates.get(tkey)
        if tmpl is None:
            proto = WireActorTaskSpec(
                task_id=task_id.hex(),
                job_id=self.job_id.hex(),
                actor_id=aid,
                method=method_name,
                name=f"{handle._class_name}.{method_name}",
                args=args_blob,
                num_returns=num_returns,
                streaming=streaming,
                owner=self.address,
                seq=seq,
                concurrency_group=(handle._method_meta or {}).get(
                    method_name, {}).get("concurrency_group"),
                trace_ctx=trace_ctx,
            )
            if len(self._actor_templates) >= 1024:
                self._actor_templates.clear()
            tmpl = self._actor_templates[tkey] = SpecTemplate(proto)
        spec = tmpl.encode(task_id=task_id.hex(), args=args_blob,
                           seq=seq, trace_ctx=trace_ctx)
        if attribution.enabled:
            attribution.record("submit.encode", time.perf_counter() - _t0)
        refs = self._make_return_refs(task_id, num_returns)
        self._record_task_event(task_id.hex(), spec["name"], "SUBMITTED",
                                actor_id=aid)
        gen = None
        if streaming:
            gen = ObjectRefGenerator()
            self._generators[task_id.hex()] = gen
        self._enqueue_submit(("actor", spec, refs, pinned))
        if streaming:
            return gen
        if opts.num_returns == 0:
            return None
        return refs[0] if opts.num_returns == 1 else refs

    async def _actor_client(self, aid: str) -> RpcClient:
        state = self._actors.get(aid)
        if state is None or state.address is None or state.state != "ALIVE":
            # Borrowed handle or restarting actor: resolve via GCS, waiting
            # briefly for PENDING/RESTARTING actors to come up.
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                info = await self._gcs.get_actor(actor_id=aid)
                if info is None:
                    raise ActorDiedError(error_msg="unknown actor")
                if info["state"] == "ALIVE":
                    if state is None:
                        state = _ActorState(aid)
                        state.task_retries = info.get(
                            "max_task_retries", 0) or 0
                        self._actors[aid] = state
                    state.address = info["address"]
                    state.state = "ALIVE"
                    break
                if info["state"] == "DEAD":
                    raise ActorDiedError(
                        error_msg=f"actor is dead: "
                                  f"{info.get('death_cause', 'unknown')}")
                await asyncio.sleep(0.1)
            else:
                raise ActorUnavailableError(
                    error_msg="timed out waiting for actor to become ALIVE")
        return await self._worker_client(state.address)

    async def _submit_actor_async(self, spec: dict, refs: List[ObjectRef],
                                  pinned: Optional[List[ObjectID]] = None
                                  ) -> None:
        aid = spec["actor_id"]
        # Per-task retry budget for SYSTEM failures (reference:
        # direct_actor_task_submitter.h — client queues resubmit through
        # an actor restart when max_task_retries allows; -1 = infinite).
        state = self._actors.get(aid)
        retries_left = state.task_retries if state is not None else 0
        try:
            if spec["task_id"] in self._cancel_requested:
                # Cancelled before the push left this process: resolve the
                # refs AND tell the worker to skip this seq so the next
                # call doesn't stall behind the hole.
                self._fail_task_cancelled(spec, refs)
                try:
                    client = await self._actor_client(aid)
                    await client.notify("actor_seq_skip",
                                        owner=self.address,
                                        seq=spec.get("seq"))
                except Exception:
                    pass  # 60s gate timeout is the backstop
                return
            while True:
                pushed_addr = None
                try:
                    client = await self._actor_client(aid)
                    state = self._actors.get(aid)
                    if state is not None and state.address:
                        pushed_addr = state.address
                        self._inflight_task_workers[spec["task_id"]] = (
                            state.address, True)
                    reply = await client.call(
                        "push_actor_task",
                        spec=(to_wire(spec) if hasattr(spec, "_wire_name")
                              else spec),
                        timeout=None)
                    self._record_task_reply(spec, reply)
                    return
                except RayActorError as e:
                    self._fail_actor_task(spec, refs, e)
                    return
                except (ConnectionLost, RpcError) as e:
                    state = self._actors.get(aid)
                    if (state is not None and state.state == "ALIVE"
                            and (pushed_addr is None
                                 or state.address == pushed_addr)):
                        # We are first to observe this death; a concurrent
                        # handler that already restarted the actor (fresh
                        # address) must not be knocked back to RESTARTING.
                        state.state = "RESTARTING"
                        state.address = None
                    if state is None or retries_left == 0:
                        # No retry budget: fail the call, restart (if
                        # allowed) in the background for FUTURE calls.
                        if state is not None:
                            asyncio.ensure_future(
                                self._maybe_restart_actor(state))
                        self._fail_actor_task(
                            spec, refs, ActorDiedError(
                                error_msg=f"actor connection lost: {e}"))
                        return
                    if retries_left > 0:
                        retries_left -= 1
                    if not await self._restart_and_wait(state):
                        self._fail_actor_task(
                            spec, refs, ActorDiedError(
                                error_msg="actor died and could not be "
                                          f"restarted: {e}"))
                        return
                    # Actor is ALIVE again: resubmit this task to the new
                    # incarnation (same seq; the fresh worker adopts the
                    # first seq it sees).
        except Exception as e:  # noqa: BLE001
            self._fail_actor_task(
                spec, refs, RayActorError(error_msg=str(e)))
        finally:
            self._inflight_task_workers.pop(spec["task_id"], None)
            self._cancel_requested.discard(spec["task_id"])
            if pinned:
                self._unpin_args(pinned)

    async def _restart_and_wait(self, state: "_ActorState",
                                timeout: float = 120.0) -> bool:
        """Drive (or wait out a concurrent) actor restart; True when the
        actor is ALIVE again. Runs on the single RPC event loop, so the
        restart_inflight check-then-act below cannot interleave."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if state.state == "ALIVE":
                return True
            if state.state == "DEAD":
                return False
            if not state.restart_inflight:
                return await self._maybe_restart_actor(state)
            await asyncio.sleep(0.05)
        return state.state == "ALIVE"

    async def _maybe_restart_actor(self, state: Optional[_ActorState]
                                   ) -> bool:
        """Owner-led actor restart (reference: GCS restarts up to
        max_restarts, gcs_actor_manager.h RESTARTING). Guarded so concurrent
        triggers (kill + in-flight ConnectionLost) run exactly one attempt."""
        if state is None:
            return False
        if state.restart_inflight or state.state == "ALIVE":
            return state.state == "ALIVE"
        if state.creation is None or state.restarts_remaining == 0:
            if state.creation is not None:
                await self._gcs.update_actor(state.actor_id_hex, {
                    "state": "DEAD", "death_cause": "worker died"})
            state.state = "DEAD"
            self._unpin_actor(state)
            return False
        state.restart_inflight = True
        try:
            if state.restarts_remaining > 0:
                state.restarts_remaining -= 1
            state.state = "RESTARTING"
            await self._gcs.update_actor(state.actor_id_hex,
                                         {"state": "RESTARTING"})
            await asyncio.sleep(
                ray_config().actor_restart_backoff_ms / 1000.0)
            try:
                await self._create_actor_async(state)
            except Exception:
                state.state = "DEAD"
            if state.state == "DEAD":
                self._unpin_actor(state)
            return state.state == "ALIVE"
        finally:
            state.restart_inflight = False

    def _fail_actor_task(self, spec, refs, exc) -> None:
        blob = serialization.serialize_error(exc).to_bytes()
        for r in refs:
            entry = self._owned_entry(r.hex())
            if not entry.fut.done():
                entry.fut.set_result(("inline", blob))
        gen = self._generators.pop(spec["task_id"], None)
        if gen is not None:
            gen._finish(exc)

    def kill_actor(self, handle, no_restart: bool = True) -> None:
        aid = handle._ray_actor_id.hex()
        state = self._actors.get(aid)
        # ray.kill(no_restart=False) lets a restartable actor come back
        # (reference: gcs_actor_manager destroys vs restarts on KillActor).
        restartable = (not no_restart and state is not None
                       and state.creation is not None
                       and state.restarts_remaining != 0)
        if no_restart and state is not None:
            state.restarts_remaining = 0
            state.creation = None
        if no_restart:
            with self._actor_seq_lock:
                self._actor_call_seq.pop(aid, None)

        async def _kill():
            try:
                info = await self._gcs.get_actor(actor_id=aid)
                if restartable:
                    # Publish RESTARTING before the worker exits so borrowers
                    # never resolve the stale ALIVE address of a dead worker
                    # during the kill->restart window.
                    await self._gcs.update_actor(aid, {
                        "state": "RESTARTING", "address": None})
                else:
                    await self._gcs.update_actor(aid, {
                        "state": "DEAD", "death_cause": "ray.kill"})
                if info and info.get("address"):
                    # A worker that is gone refuses at once: one second
                    # of retries, not the default ten, before giving up
                    # on telling it to exit (the caller waits on this).
                    client = await self._worker_client(info["address"],
                                                       connect_timeout=1.0)
                    await client.notify("exit_worker")
            except Exception:
                pass

        self._loop.run(_kill(), timeout=10)
        if state is None:
            return
        if restartable:
            state.state = "RESTARTING"
            state.address = None
            self._loop.spawn(self._maybe_restart_actor(state))
        else:
            state.state = "DEAD"
            self._unpin_actor(state)

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.core.actor import ActorHandle

        info = self._loop.run(self._gcs.get_actor(
            name=name, namespace=namespace or self.namespace))
        if info is None or info.get("state") == "DEAD":
            raise ValueError(f"Failed to look up actor with name '{name}'")
        actor_id = ActorID(bytes.fromhex(info["actor_id"]))
        return ActorHandle(actor_id, info.get("class_name", "Actor"),
                           info.get("method_meta", {}), runtime=self)

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True) -> None:
        """Cancel the task that produces `ref` (reference:
        core_worker cancellation: queued tasks are dropped; running
        tasks get TaskCancelledError raised in their thread; force=True
        kills the executing worker process)."""
        task_hex = ref.id().task_id().hex()
        with self._owned_lock:
            entry = self._owned.get(ref.hex())
        if entry is not None and entry.fut.done():
            # Already finished: cancel is a no-op (reference semantics) —
            # and must not leave a flag that would poison a later lineage
            # re-execution of this same task id.
            return
        inflight = self._inflight_task_workers.get(task_hex)
        if inflight is not None and inflight[1] and force:
            # Reference parity: force-killing an actor task would kill
            # the whole actor (collateral damage to every other caller).
            raise ValueError(
                "force=True is not supported for actor tasks; use "
                "ray_tpu.kill on the actor instead")
        self._cancel_requested.add(task_hex)
        if inflight is None:
            return  # queued (or already done): handled at push time
        address = inflight[0]

        async def _cancel():
            try:
                client = await self._worker_client(address)
                await client.call("cancel_task", task_id=task_hex,
                                  force=force, timeout=10.0)
            except Exception:
                pass  # worker already gone

        self._loop.run(_cancel(), timeout=15)

    async def handle_cancel_task(self, conn: ServerConnection, *,
                                 task_id: str,
                                 force: bool = False) -> dict:
        """Worker-side: interrupt the execution of `task_id` — cancel its
        coroutine (async actor methods), async-raise in its thread (sync
        code), or mark it cancelled-before-start."""
        thread_id = self._running_task_threads.get(task_id)
        if thread_id is None:
            # Not started yet (queued behind the actor's concurrency or
            # seq gate): poison it so execution aborts immediately.
            self._cancelled_pending.add(task_id)
            return {"found": False}
        if force:
            # Reference force-cancel kills the worker process; the raylet
            # monitor reaps it and the owner sees ConnectionLost.
            os._exit(137)
        cfut = self._running_task_cfuts.get(task_id)
        if cfut is not None:
            # Async method: the executor thread is parked in
            # cfut.result() where an async-raise cannot land — cancel
            # the coroutine instead.
            cfut.cancel()
            return {"found": True}
        if self._prev_unraisablehook is None:
            self._prev_unraisablehook = sys.unraisablehook
            sys.unraisablehook = self._on_unraisable
        self._cancel_sent.add(task_id)
        with self._cancel_lock:
            thread_id = self._user_code_threads.get(task_id)
            if thread_id is not None:
                import ctypes

                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(thread_id),
                    ctypes.py_object(TaskCancelledError))
        return {"found": True}

    # A cancel is raised once in the task's thread, as the reference does.
    # Where it lands in code whose exceptions Python reports as "Exception
    # ignored" (a `gc.callbacks` hook such as the flight recorder's, a
    # `__del__`, a weakref callback), Python swallows it and the task would
    # run on. `_on_unraisable` sees that report and re-raises the cancel
    # in the frame that was interrupted, at its next line; if that frame
    # is `_run_user_code` itself, its return raises instead.

    def _on_unraisable(self, unraisable) -> None:
        """sys.unraisablehook: a TaskCancelledError swallowed in a thread
        that runs a cancelled task's code is re-armed; anything else goes
        to the hook this one replaced."""
        if (unraisable.exc_type is not None
                and issubclass(unraisable.exc_type, TaskCancelledError)):
            tid = threading.get_ident()
            task_id = next(
                (t for t, th in tuple(self._user_code_threads.items())
                 if th == tid and t in self._cancel_sent), None)
            if task_id is not None:
                self._cancel_swallowed.add(task_id)
                self._rearm_cancel(task_id, tid, sys._getframe().f_back)
                return
        self._prev_unraisablehook(unraisable)

    def _rearm_cancel(self, task_id: str, tid: int, frame) -> None:
        if (frame.f_code is _RUN_USER_CODE or tid in self._cancel_armed
                or sys.gettrace() is not None):
            return      # leaving (the return raises), armed, or a debugger

        def _raise_swallowed(frame, event, arg):
            self._cancel_swallowed.discard(task_id)
            raise TaskCancelledError(task_id)

        self._cancel_armed[tid] = frame
        sys.settrace(_no_line_trace)
        frame.f_trace_lines = True
        frame.f_trace = _raise_swallowed

    def _run_user_code(self, task_id: str, call):
        """`call()`, the task's own code, in this thread, cancellable.

        The thread marks itself, then looks for a cancel; a cancel is added
        first, then sent under `_cancel_lock` to a marked thread, so one of
        the two sees the other. Leaving, the thread drops its mark; if a
        cancel was sent, it waits out a send in progress under the lock,
        disarms a re-armed frame and clears a pending cancel, so none lands
        after it has left. One that lands while it leaves, or was swallowed
        and never re-raised, makes the return raise TaskCancelledError."""
        tid = threading.get_ident()
        try:
            self._user_code_threads[task_id] = tid
            if task_id in self._cancel_sent:
                raise TaskCancelledError(task_id)
            value = call()
        finally:
            while True:
                try:
                    self._user_code_threads.pop(task_id, None)
                    if task_id in self._cancel_sent:
                        self._leave_cancelled(tid)
                    break
                except TaskCancelledError:
                    self._cancel_swallowed.add(task_id)
        if task_id in self._cancel_swallowed:
            raise TaskCancelledError(task_id)
        return value

    def _leave_cancelled(self, tid: int) -> None:
        import ctypes

        with self._cancel_lock:
            pass        # a send that read this thread's mark has ended
        frame = self._cancel_armed.pop(tid, None)
        if frame is not None:
            frame.f_trace = None
            del frame
        if sys.gettrace() is _no_line_trace:
            sys.settrace(None)
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)

    # ==================================================================
    # placement groups (reference: python/ray/util/placement_group.py:41 +
    # gcs_placement_group_scheduler.h 2PC; owner-led here, like actors)
    # ==================================================================
    def create_placement_group(self, bundles: List[Dict[str, float]],
                               strategy: str = "PACK", name: str = "",
                               target_node_ids: Optional[List[str]] = None
                               ) -> str:
        from ray_tpu_torch.core.ids import PlacementGroupID
        from ray_tpu_torch.core.pg_scheduler import validate_pg_args

        validate_pg_args(bundles, strategy)
        pg_id = PlacementGroupID.of(self.job_id).hex()
        info = {
            "bundles": [dict(b) for b in bundles],
            "strategy": strategy,
            "name": name,
            "state": "PENDING",
            "owner": self.address,
            "target_node_ids": target_node_ids,
            # A group created in an actor lives as long as that actor:
            # the GCS removes it when the actor dies, and the raylets'
            # reconcile returns its bundles.
            "creator_actor_id": self._actor_id_hex,
        }
        self._loop.run(self._gcs.register_placement_group(pg_id, info))
        self._loop.spawn(self._schedule_pg_async(pg_id, info))
        return pg_id

    async def _schedule_pg_async(self, pg_id: str, info: dict) -> None:
        await schedule_placement_group(self._gcs, self._raylet_client,
                                       pg_id, info)

    def placement_group_wait(self, pg_id: str,
                             timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            info = self._loop.run(self._gcs.get_placement_group(pg_id))
            state = (info or {}).get("state")
            if state == "CREATED":
                return True
            if state in ("INFEASIBLE", "REMOVED", None):
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def remove_placement_group(self, pg_id: str) -> None:
        info = self._loop.run(self._gcs.get_placement_group(pg_id))
        if info is None or info.get("state") == "REMOVED":
            return

        async def _remove():
            # Record REMOVED FIRST, then return the bundles: any return
            # that fails (dead raylet, dropped message, owner crash
            # mid-loop) is mopped up by raylet-side reconciliation
            # against the terminal state (_maybe_reconcile_bundles).
            # The reverse order strands committed bundles behind a
            # forever-CREATED record nobody will ever reclaim.
            await self._gcs.update_placement_group(
                pg_id, {"state": "REMOVED"})
            for idx, loc in enumerate(info.get("bundle_locations") or []):
                try:
                    client = await self._raylet_client(loc["address"])
                    await client.call("return_bundle", pg_id=pg_id,
                                      bundle_index=idx, timeout=10.0)
                except Exception:
                    pass

        self._loop.run(_remove(), timeout=30)
        self._pg_cache.pop(pg_id, None)

    def placement_group_table(self, pg_id: Optional[str] = None):
        if pg_id is not None:
            return self._loop.run(self._gcs.get_placement_group(pg_id))
        return {p["pg_id"]: p
                for p in self._loop.run(self._gcs.list_placement_groups())}

    async def _pg_location(self, pg_id: str, bundle_index: int,
                           demand: Optional[Dict[str, float]] = None
                           ) -> Tuple[str, int]:
        """Resolve (raylet_address, bundle_index) for a lease against a PG,
        waiting for a still-scheduling group. bundle_index -1 → round-robin
        over the bundles whose spec can hold `demand` (reference:
        any-feasible-bundle semantics)."""

        info = self._pg_cache.get(pg_id)
        if info is None or info.get("state") != "CREATED":
            # Generous deadline: the owner-side scheduler terminates in
            # CREATED or INFEASIBLE after bounded attempts — but if the
            # owner process died mid-scheduling the record stays PENDING
            # forever, so don't spin unbounded on someone else's PG.
            deadline = time.monotonic() + 300.0
            while True:
                info = await self._gcs.get_placement_group(pg_id)
                state = (info or {}).get("state")
                if state == "CREATED":
                    self._pg_cache[pg_id] = info
                    break
                if state in ("REMOVED", "INFEASIBLE", None):
                    raise ValueError(
                        f"placement group {pg_id} is unusable "
                        f"(state={state}: "
                        f"{(info or {}).get('detail', '')})")
                if time.monotonic() >= deadline:
                    raise ValueError(
                        f"placement group {pg_id} stuck PENDING for 300s "
                        "(owner died mid-scheduling?)")
                await asyncio.sleep(0.1)
        locs = info["bundle_locations"]
        if bundle_index is None or bundle_index < 0:
            specs = info.get("bundles", [])
            feasible = [i for i in range(len(locs))
                        if not demand or not specs
                        or all(specs[i].get(k, 0.0) + 1e-9 >= v
                               for k, v in demand.items())]
            if not feasible:
                raise ValueError(
                    f"no bundle of placement group {pg_id} can hold "
                    f"{demand}; bundles: {specs}")
            self._pg_rr[pg_id] = self._pg_rr.get(pg_id, -1) + 1
            bundle_index = feasible[self._pg_rr[pg_id] % len(feasible)]
        if bundle_index >= len(locs):
            raise ValueError(
                f"bundle index {bundle_index} out of range for placement "
                f"group with {len(locs)} bundles")
        return locs[bundle_index]["address"], bundle_index

    # ==================================================================
    # owner-side RPC service (reference: CoreWorkerService pubsub/locations)
    # ==================================================================
    async def handle_get_object_locations(self, conn: ServerConnection, *,
                                          oid: str) -> Optional[dict]:
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is None:
            return None
        if not entry.fut.done():
            return {"pending": True, "nodes": []}
        kind, payload = entry.fut.result()
        if kind == "inline":
            return {"inline": payload}
        return {"nodes": list(entry.nodes)}

    async def handle_get_object_locations_batch(
            self, conn: ServerConnection, *,
            oids: List[str]) -> Dict[str, Optional[dict]]:
        """Batched location query: one RPC resolves every ref this caller
        is waiting on (reference: batched WaitRequest — kills the
        per-ref-per-tick polling storm)."""
        out: Dict[str, Optional[dict]] = {}
        for oid in oids:
            out[oid] = await self.handle_get_object_locations(conn,
                                                              oid=oid)
        return out

    async def handle_generator_item(self, conn: ServerConnection, *,
                                    task_id: str, oid: str,
                                    inline: Optional[bytes] = None,
                                    node: Optional[str] = None) -> bool:
        entry = self._owned_entry(oid)
        if node:
            if node not in entry.nodes:
                entry.nodes.append(node)
            entry.is_stored = True
            if not entry.fut.done():
                entry.fut.set_result(("node", node))
        elif not entry.fut.done():
            entry.fut.set_result(("inline", inline))
        gen = self._generators.get(task_id)
        if gen is not None:
            gen._push(ObjectRef(ObjectID(bytes.fromhex(oid)),
                                owner=self.address, runtime=self))
        return True

    async def handle_prune_object_location(self, conn: ServerConnection, *,
                                           oid: str, node: str) -> bool:
        """A raylet discovered `node` no longer holds `oid` (evicted or
        died): drop the stale location; when the LAST copy is gone,
        re-execute the producing task if its lineage is retained
        (reference: object_recovery_manager.h:41)."""
        lost = False
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None and node in entry.nodes:
                entry.nodes = [n for n in entry.nodes if n != node]
                lost = not entry.nodes and entry.is_stored
        if lost:
            self._trigger_reconstruction(oid)
        return True

    def _trigger_reconstruction(self, oid: str) -> bool:
        """Re-execute the task that produced `oid` (owner-side; runs on the
        RPC loop). Pullers observing `pending` keep waiting meanwhile.
        Returns True when a re-execution is running (started now or
        already inflight); False means the loss is final (unretained
        lineage or exhausted budget) and the typed error stands."""
        verdict, rec = self._lineage.begin_reexec(oid)
        if verdict == lineage_mod.INFLIGHT:
            return True
        if verdict != lineage_mod.STARTED:
            if verdict == lineage_mod.EXHAUSTED:
                logger.warning("object %s lost and reconstruction budget "
                               "exhausted", oid[:16])
            return False
        refs = []
        with self._owned_lock:
            for roid in rec["ref_oids"]:
                entry = self._owned.get(roid)
                if entry is None:
                    continue
                if entry.is_stored and entry.nodes:
                    continue  # sibling return with healthy copies: keep it
                # Reset to pending: directory answers "pending" until the
                # re-executed task stores fresh copies.
                entry.fut = concurrent.futures.Future()
                entry.nodes = []
                entry.is_stored = False
        for roid in rec["ref_oids"]:
            refs.append(ObjectRef(ObjectID(bytes.fromhex(roid)),
                                  owner=self.address, runtime=self))
        logger.info("reconstructing %s via re-execution of %s (%d budget "
                    "left)", oid[:16], rec["spec"].get("name"), rec["left"])

        async def _resubmit():
            try:
                await self._submit_async(rec["spec"], refs, None)
            except BaseException as e:  # noqa: BLE001
                logger.warning("reconstruction resubmit for %s aborted: "
                               "%r", oid[:16], e)
                raise
            finally:
                self._lineage.end_reexec(rec)
                if logger.isEnabledFor(logging.DEBUG):
                    with self._owned_lock:
                        e = self._owned.get(oid)
                        logger.debug(
                            "reconstruction resubmit finished for %s: "
                            "done=%s nodes=%s stored=%s", oid[:16],
                            e is not None and e.fut.done(),
                            e.nodes if e else None,
                            e.is_stored if e else None)

        self._loop.spawn(_resubmit())
        return True

    async def handle_reconstruct_object(self, conn: ServerConnection, *,
                                        oid: str) -> Dict[str, Any]:
        """A raylet's pull found no reachable copy of an object we own:
        decide recovery. `recovering=True` tells the puller to keep
        polling (a value is pending, copies reappeared, or a lineage
        re-execution just started); False means the loss is final and
        the borrower's get must fail with the typed error. This closes
        the notify race where a prune was still in flight when the
        puller's next locations query saw an empty directory."""
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is None:
                return {"recovering": False, "known": False}
            if not entry.fut.done():
                return {"recovering": True}
            if entry.nodes:
                # Copies (re)appeared since the puller looked — or the
                # puller's view raced a fresh seal. Re-resolve.
                return {"recovering": True}
            kind, _ = entry.fut.result()
            if kind == "inline":
                # Inline values live in the owner future; the next
                # locations query returns the payload itself.
                return {"recovering": True}
        return {"recovering": self._trigger_reconstruction(oid)}

    async def handle_ping(self, conn: ServerConnection) -> str:
        return "pong"

    async def handle_dump_flight_record(
            self, conn: ServerConnection, *,
            window_s: Optional[float] = None,
            include_events: bool = True) -> dict:
        """This process's flight-recorder ring + stall episodes (the
        raylet's fan-out handler of the same name collects these from
        every worker on its node; the dashboard merges nodes)."""
        return flight.dump(window_s=window_s,
                           include_events=include_events)

    # ==================================================================
    # worker-mode execution (reference: core_worker.cc:2596 ExecuteTask +
    # _raylet.pyx task_execution_handler)
    # ==================================================================
    def _ensure_job_env(self, job_id: Optional[str]) -> None:
        """Extend sys.path with the driver's entries so driver-local modules
        (test files, scripts) resolve when unpickling by reference."""
        if not job_id:
            return
        if self.mode == "worker" and len(job_id) == len(self.job_id.hex()):
            # Adopt the job we execute for — on EVERY push, since a reused
            # worker can serve different jobs across leases: tasks/actors
            # submitted FROM this worker (e.g. a Tune trial spawning its
            # training gang) must carry the original driver's job so their
            # workers resolve driver-local modules too (reference: job_id
            # rides the TaskSpec end-to-end).
            self.job_id = JobID(bytes.fromhex(job_id))
        if job_id in self._job_envs_applied:
            return
        try:
            info = self._loop.run(self._gcs.get_job(job_id), timeout=10)
        except Exception:
            return  # transient GCS error: leave unmarked so we retry
        import sys
        with self._job_env_lock:
            if job_id in self._job_envs_applied:
                return
            for p in (info or {}).get("sys_path", []):
                if p not in sys.path:
                    sys.path.append(p)
            # The driver's relative paths resolve from its directory.
            cwd = (info or {}).get("cwd")
            if cwd and os.path.isdir(cwd):
                os.chdir(cwd)
            # A falsy record is memoized too: the job is simply gone from
            # the GCS table and won't come back, so don't re-query per task.
            self._job_envs_applied.add(job_id)

    def _resolve_task_args(self, args_blob: bytes):
        """Returns (args, kwargs, arg_refs) where arg_refs is the list of
        (oid, owner) pairs for every ref deserialized from the payload —
        the input for _commit_arg_borrows at task completion."""
        if args_blob is ClusterRuntime._empty_args_blob:
            # Inline fast path: the shared zero-arg blob (identity, not
            # equality — a wire copy never matches) decodes to a known
            # constant; skip the unpickle.
            return (), {}, []
        _deser_ctx.suppress_borrow = True
        _deser_ctx.arg_refs = []
        try:
            args, kwargs = self._deserialize_payload(args_blob)
        finally:
            _deser_ctx.suppress_borrow = False
            arg_refs = _deser_ctx.arg_refs
            _deser_ctx.arg_refs = None
        args = [self.get(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: self.get(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        return args, kwargs, arg_refs

    def _dump_task_profile(self, profiler, task_id: str,
                           name: str) -> None:
        """Per-task cProfile dump (off unless the call site opted in
        with `.options(_metadata={"profile": True})`). The pstats text
        lands in two places: a file next to this worker's log (same
        directory the raylet tails for `/api/logs`), and — top lines
        only — on stdout, i.e. IN the worker log itself, so the
        existing log surfaces point at the full dump. Profiling output
        must never fail the task."""
        try:
            import io
            import pstats

            buf = io.StringIO()
            stats = pstats.Stats(profiler, stream=buf)
            stats.sort_stats("cumulative").print_stats(30)
            text = buf.getvalue()
            # Same resolution as the stall reports: RAY_TPU_LOG_DIR
            # when inherited (the raylet's log dir — where /api/logs
            # reads), created if missing.
            log_dir = flight.report_dir()
            wid = (self._raylet_worker_id or self.worker_id.hex())[:8]
            path = os.path.join(
                log_dir, f"worker-{wid}-profile-{task_id[:8]}.pstats.txt")
            with open(path, "w") as f:
                f.write(f"# task {name} ({task_id})\n")
                f.write(text)
            head = "\n".join(text.splitlines()[:12])
            print(f"[profile] task {name} ({task_id[:8]}) -> {path}\n"
                  f"{head}", flush=True)
        except Exception:
            logger.debug("task profile dump failed", exc_info=True)

    def _commit_arg_borrows(self, arg_refs) -> None:
        """Upgrade still-held arg-ref pins to owner-registered borrows.

        Called after task completion with args/kwargs/value dropped: any
        arg oid whose local pin count survived is retained (actor state,
        a live generator, result escrow) and the owner must count the
        borrow BEFORE our reply lets the submitter's pin lapse, or the
        owner may free the object while we still hold it (reference:
        reference_count.h — borrowed refs are reported in the task
        reply). Synchronous on purpose; costs RPCs only for tasks that
        actually retain arg refs.
        """
        pending = []  # (oid, owner, rec) needing an owner round-trip
        seen = set()
        for oid, owner in arg_refs:
            if oid in seen:
                continue
            seen.add(oid)
            with self._borrowed_lock:
                rec = self._borrowed.get(oid)
                if rec is None or rec[2]:
                    continue  # fully released during the task / registered
            pending.append((oid, owner, rec))
        if not pending:
            return

        async def _register(oid, owner):
            client = await self._worker_client(owner)
            return bool(await client.call("register_borrow", oid=oid,
                                          timeout=30.0))

        async def _register_all():
            # Concurrent: the RPCs are independent, and a dead owner must
            # cost one timeout total, not one per retained oid.
            return await asyncio.gather(
                *(_register(oid, owner) for oid, owner, _ in pending),
                return_exceptions=True)

        try:
            results = self._loop.run(
                _register_all(),
                timeout=ray_config().borrow_commit_timeout_s)
        except Exception:
            results = [False] * len(pending)
        for (oid, owner, rec), res in zip(pending, results):
            ok = res is True
            if not ok:
                # The retained ref is now unprotected: once the
                # submitter's pin lapses the owner may free the object
                # and a later get on it will fail. Leave a trail.
                logger.warning(
                    "could not register retained arg borrow for %s with "
                    "owner %s (%s); object may be freed while still held",
                    oid[:16], owner,
                    res if isinstance(res, Exception) else "refused")
            with self._borrowed_lock:
                cur = self._borrowed.get(oid)
                if cur is rec:
                    if ok:
                        rec[2] = True
                    continue
            if ok:
                # Pin released while our registration was in flight: the
                # owner counted us, so compensate.
                async def _release(oid=oid, owner=owner):
                    try:
                        client = await self._worker_client(owner)
                        await client.call("release_borrow", oid=oid,
                                          timeout=30.0)
                    except Exception:
                        pass

                self._loop.spawn(_release())

    def _escrow_pin(self, ref) -> None:
        """Pin a ref embedded in an outgoing result until consumers had
        ample time to register their borrow (window: config
        borrow_escrow_s; reference: the borrowing protocol of
        reference_count.h, here time-bounded rather than tracked per
        containing object)."""
        oid = ref.hex()
        with self._owned_lock:
            known = oid in self._owned
        if not known:
            with self._borrowed_lock:
                known = oid in self._borrowed
        if known:
            self.add_local_reference(ref.id())
        else:
            # A pass-through ref (arrived as a task arg under
            # suppress_borrow, now re-exported in our result): register
            # a real borrow with its owner so the pin actually holds.
            self.on_ref_deserialized(ref)

        async def _release_later(object_id=ref.id()):
            await asyncio.sleep(ray_config().borrow_escrow_s)
            self.remove_local_reference(object_id)

        self._loop.spawn(_release_later())

    def _package_result(self, oid: str, value: Any,
                        is_error: bool = False) -> dict:
        so = (serialization.serialize_error(value) if is_error
              else serialization.serialize(
                  value, ref_serializer=self._escrow_pin))
        size = so.total_size()
        if size <= ray_config().max_direct_call_object_size:
            return {"oid": oid, "inline": so.to_bytes()}
        shm_name = self._loop.run(
            self._raylet.call("create_object", oid=oid, size=size))
        self._shm.write_chunks(shm_name, so.chunks())
        # See _store_serialized: seal needs no round trip.
        self._loop.run(self._raylet.notify("seal_object", oid=oid))
        return {"oid": oid, "node": self.raylet_address}

    def _execute_task(self, spec: dict) -> dict:
        from ray_tpu_torch.runtime_context import (_reset_task_context,
                                             _set_task_context)

        task_id = spec["task_id"]
        num_returns = spec["num_returns"]
        name = spec.get("name", "task")
        results: List[dict] = []
        token = _set_task_context(
            task_id=TaskID(bytes.fromhex(task_id)))
        self._record_task_event(task_id, name, "RUNNING",
                                job_id=spec.get("job_id"))
        self._running_task_threads[task_id] = threading.get_ident()
        ok = False
        arg_refs: List[tuple] = []
        args = kwargs = value = None
        # Worker-side attribution split: arg-resolution vs exec vs
        # result-packaging, so a copy regression in either data-plane
        # half (arg fetch, return store) is attributable separately
        # from user compute (rides the reply as attr_exec).
        attr_on = attribution.enabled
        split = {"arg_resolve": 0, "exec": 0, "result_pack": 0}
        _tmark = time.perf_counter() if attr_on else 0.0
        # exec_us rides EVERY successful reply (one int, two clock
        # reads): it feeds the owner's per-fn cost EMA that gates the
        # inline fast path (_inline_eligible).
        exec_us: Optional[int] = None
        try:
            if task_id in self._cancelled_pending:
                raise TaskCancelledError(task_id)
            self._apply_visible_chips(spec.get("visible_chips"))
            self._ensure_job_env(spec.get("job_id"))
            if spec.get("runtime_env"):
                from ray_tpu_torch.core.runtime_env import apply_runtime_env

                apply_runtime_env(self, spec["runtime_env"])
            fn = self._fn.fetch(spec["fn_key"])
            args, kwargs, arg_refs = self._resolve_task_args(spec["args"])
            if attr_on:
                now = time.perf_counter()
                split["arg_resolve"] = int((now - _tmark) * 1e6)
                _tmark = now
            # Per-task cProfile opt-in (.options(_metadata={"profile":
            # True})): wraps ONLY the user-code call; the pstats text
            # dumps next to the worker log so /api/logs surfaces it.
            profiler = None
            if spec.get("profile"):
                import cProfile

                profiler = cProfile.Profile()
            _e0 = time.perf_counter()
            if tracing_enabled() or spec.get("trace_ctx"):
                # Execution span parents to the CALLER's span via the
                # propagated traceparent (reference: tracing_helper's
                # _function_span on the worker side).
                with span(f"task.run {name}",
                          parent=spec.get("trace_ctx"),
                          attributes={"task_id": task_id,
                                      "component": "worker"}):
                    value = self._run_user_code(
                        task_id, lambda: (
                            profiler.runcall(fn, *args, **kwargs)
                            if profiler is not None
                            else fn(*args, **kwargs)))
            else:
                value = self._run_user_code(
                    task_id, lambda: (
                        profiler.runcall(fn, *args, **kwargs)
                        if profiler is not None else fn(*args, **kwargs)))
            exec_us = int((time.perf_counter() - _e0) * 1e6)
            if profiler is not None:
                self._dump_task_profile(profiler, task_id, name)
            if flight.enabled:
                flight.record("task", f"exec:{name}", dur_us=exec_us,
                              arg=task_id[:8],
                              t=time.monotonic() - exec_us / 1e6)
            if attr_on:
                now = time.perf_counter()
                split["exec"] = int((now - _tmark) * 1e6)
                _tmark = now
            args = kwargs = None
            results = self._package_returns(task_id, num_returns, name,
                                            value)
            if attr_on:
                split["result_pack"] = int(
                    (time.perf_counter() - _tmark) * 1e6)
            ok = True
        except BaseException as e:  # noqa: BLE001
            self._die_if_orphaned()
            results = self._package_error(task_id, num_returns, name, e)
        finally:
            # Drop frame refs to args/value so only genuinely retained
            # arg refs still hold pins, then upgrade those to real
            # borrows before the reply releases the submitter's pin.
            args = kwargs = value = None
            self._commit_arg_borrows(arg_refs)
            self._running_task_threads.pop(task_id, None)
            self._cancelled_pending.discard(task_id)
            self._cancel_sent.discard(task_id)
            self._cancel_swallowed.discard(task_id)
            self._record_task_event(
                task_id, name, "FINISHED" if ok else "FAILED",
                job_id=spec.get("job_id"))
            _reset_task_context(token)
        reply: Dict[str, Any] = {"results": results}
        if exec_us is not None:
            reply["exec_us"] = exec_us
        if attr_on:
            reply["attr_exec"] = split
        return reply

    def _package_returns(self, task_id: str, num_returns: int, name: str,
                         value: Any) -> List[dict]:
        def oid_for(i):
            return ObjectID.for_return(
                TaskID(bytes.fromhex(task_id)), i + 1).hex()

        if num_returns == 1:
            return [self._package_result(oid_for(0), value)]
        if num_returns == 0:
            return []
        if not isinstance(value, (tuple, list)) or len(value) != num_returns:
            err = ValueError(
                f"Task declared num_returns={num_returns} but returned "
                f"{type(value).__name__}")
            return self._package_error(task_id, num_returns, name, err)
        return [self._package_result(oid_for(i), v)
                for i, v in enumerate(value)]

    def _die_if_orphaned(self) -> None:
        """A worker whose raylet died is a zombie: its object store, lease
        and chip bookkeeping are gone. Reporting the resulting plumbing
        errors (ConnectionLost on arg fetch / result store) to the owner
        would surface them as USER task failures, which don't retry.
        Exit instead — the owner observes worker death as a SYSTEM
        failure and retries/reconstructs (reference: workers exit on
        raylet socket EOF, node_manager.cc disconnect handling)."""
        if self.mode == "worker" and not self._raylet.connected:
            logging.getLogger(__name__).warning(
                "raylet connection lost mid-task; exiting so the owner "
                "retries elsewhere")
            os._exit(1)

    def _package_error(self, task_id: str, num_returns: int, name: str,
                       exc: BaseException) -> List[dict]:
        wrapped = (exc if isinstance(exc, (RayTaskError, RayActorError,
                                           TaskCancelledError))
                   else RayTaskError.from_exception(name, exc))
        out = []
        for i in range(max(num_returns, 1)):
            oid = ObjectID.for_return(
                TaskID(bytes.fromhex(task_id)), i + 1).hex()
            out.append(self._package_result(oid, wrapped, is_error=True))
        return out

    def _decode_spec(self, conn: ServerConnection, spec: dict,
                     expect: str):
        """Task-spec decode boundary. Post-handshake connections (the
        peer's schema digest verified ours — conn.metadata['wire_fast'])
        take the no-validate fast path; anything short of a perfect
        envelope falls back inside from_wire_fast to the validated
        decode, whose typed WireDecodeError names the offending field
        instead of a KeyError inside the executor."""
        if conn.metadata.get("wire_fast"):
            return from_wire_fast(spec, expect)
        return from_wire(spec, expect=expect)

    async def handle_push_task(self, conn: ServerConnection, *,
                               spec: dict) -> dict:
        attr_on = attribution.enabled
        _t0 = time.perf_counter() if attr_on else 0.0
        if isinstance(spec, dict) and "_t" in spec:
            spec = self._decode_spec(conn, spec, "TaskSpec")
            if attr_on:
                attribution.record("wire.decode_task",
                                   time.perf_counter() - _t0)
        # Refuse work the moment our raylet is gone (don't wait to fail
        # on the result store): the pusher holds a stale lease on a dead
        # node; exiting here converts it to a clean worker-death retry
        # without a wasted duplicate execution.
        self._die_if_orphaned()
        if spec.get("streaming"):
            return await self._execute_streaming(spec, actor=False)
        loop = asyncio.get_running_loop()
        _t1 = time.perf_counter() if attr_on else 0.0
        reply = await loop.run_in_executor(
            self._exec_pool, self._execute_task, spec)
        if attr_on:
            # decode measured here; the arg-resolve/exec/result-pack
            # split rides out of _execute_task (attr_exec).
            attr = {"decode": int((_t1 - _t0) * 1e6)}
            attr.update(reply.pop("attr_exec", None) or {})
            reply["attr"] = attr
        return reply

    async def _execute_streaming(self, spec: dict, actor: bool) -> dict:

        loop = asyncio.get_running_loop()
        owner_addr = spec["owner"]
        task_id = spec["task_id"]

        def run() -> Optional[bytes]:
            arg_refs: List[tuple] = []
            args = kwargs = it = None
            try:
                self._ensure_job_env(spec.get("job_id"))
                if actor:
                    method = getattr(self._actor_instance, spec["method"])
                    args, kwargs, arg_refs = self._resolve_task_args(
                        spec["args"])
                    it = method(*args, **kwargs)
                else:
                    fn = self._fn.fetch(spec["fn_key"])
                    args, kwargs, arg_refs = self._resolve_task_args(
                        spec["args"])
                    it = fn(*args, **kwargs)
                args = kwargs = None
                idx = 0
                for item in it:
                    idx += 1
                    oid = ObjectID.for_return(
                        TaskID(bytes.fromhex(task_id)), idx).hex()
                    res = self._package_result(oid, item)
                    fut = asyncio.run_coroutine_threadsafe(
                        self._push_generator_item(owner_addr, task_id, res),
                        loop)
                    fut.result()
                return None
            except BaseException as e:  # noqa: BLE001
                self._die_if_orphaned()
                wrapped = (e if isinstance(e, RayTaskError)
                           else RayTaskError.from_exception(
                               spec.get("name", "task"), e))
                return serialization.serialize_error(wrapped).to_bytes()
            finally:
                args = kwargs = it = None
                self._commit_arg_borrows(arg_refs)

        pool = (self._actor_executor if actor and self._actor_executor
                else self._exec_pool)
        error_blob = await loop.run_in_executor(pool, run)
        return {"results": [], "done": True, "error_blob": error_blob}

    async def _push_generator_item(self, owner_addr: str, task_id: str,
                                   res: dict) -> None:
        client = await self._worker_client(owner_addr)
        await client.call("generator_item", task_id=task_id,
                          oid=res["oid"], inline=res.get("inline"),
                          node=res.get("node"), timeout=30.0)

    # -- actor execution -----------------------------------------------
    def _apply_visible_chips(self, chips) -> None:
        """Show this worker its lease's GPU instances as its
        CUDA_VISIBLE_DEVICES (the reference isolates TPU chips here).
        Runs before user code: the raylet leases GPUs only to workers
        that never ran a task, so CUDA has not initialised yet."""
        if chips:
            from ray_tpu_torch.core.cuda_platform import apply_visible_gpus

            apply_visible_gpus(chips)

    async def handle_actor_init(self, conn: ServerConnection, *,
                                actor_id: str, cls_key: str, args: bytes,
                                max_concurrency: Optional[int],
                                owner: str,
                                job_id: Optional[str] = None,
                                visible_chips=None,
                                concurrency_groups: Optional[dict] = None,
                                runtime_env: Optional[dict] = None
                                ) -> dict:
        import inspect as _inspect

        loop = asyncio.get_running_loop()

        def init() -> Optional[bytes]:
            try:
                self._apply_visible_chips(visible_chips)
                self._ensure_job_env(job_id)
                if runtime_env:
                    from ray_tpu_torch.core.runtime_env import apply_runtime_env

                    apply_runtime_env(self, runtime_env)
                cls = self._fn.fetch(cls_key)
                rargs, rkwargs, arg_refs = self._resolve_task_args(args)
                self._actor_instance = cls(*rargs, **rkwargs)
                rargs = rkwargs = None
                # Constructor args stored on the instance are the classic
                # retained-arg case: commit before the creation reply.
                self._commit_arg_borrows(arg_refs)
                is_async = any(
                    _inspect.iscoroutinefunction(m)
                    or _inspect.isasyncgenfunction(m)
                    for _, m in _inspect.getmembers(cls, callable))
                conc = max_concurrency or (100 if is_async else 1)
                self._actor_executor = (
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=conc, thread_name_prefix="actor-exec"))
                # Concurrency groups: each group gets its own bounded
                # executor; ungrouped methods share the default one
                # (reference: concurrency_group_manager.h).
                self._actor_group_executors = {
                    name: concurrent.futures.ThreadPoolExecutor(
                        max_workers=limit,
                        thread_name_prefix=f"actor-{name}")
                    for name, limit in (concurrency_groups or {}).items()
                }
                if is_async:
                    import asyncio as aio
                    self._actor_loop = aio.new_event_loop()
                    threading.Thread(target=self._actor_loop.run_forever,
                                     daemon=True).start()
                self._actor_id_hex = actor_id
                return None
            except BaseException as e:  # noqa: BLE001
                wrapped = (e if isinstance(e, RayTaskError)
                           else RayTaskError.from_exception(
                               f"{cls_key}.__init__", e))
                return serialization.serialize_error(wrapped).to_bytes()

        error_blob = await loop.run_in_executor(self._exec_pool, init)
        return {"error_blob": error_blob}

    def _execute_actor_method(self, spec: dict) -> dict:
        from ray_tpu_torch.runtime_context import (_reset_task_context,
                                             _set_task_context)
        import inspect as _inspect

        task_id = spec["task_id"]
        num_returns = spec["num_returns"]
        name = spec.get("name", "method")
        token = _set_task_context(
            task_id=TaskID(bytes.fromhex(task_id)),
            actor_id=ActorID(bytes.fromhex(spec["actor_id"])))
        self._record_task_event(task_id, name, "RUNNING",
                                job_id=spec.get("job_id"),
                                actor_id=spec.get("actor_id"))
        self._running_task_threads[task_id] = threading.get_ident()
        ok = False
        arg_refs: List[tuple] = []
        args = kwargs = value = None
        # Same worker-side split as _execute_task (see there).
        attr_on = attribution.enabled
        split = {"arg_resolve": 0, "exec": 0, "result_pack": 0}
        _tmark = time.perf_counter() if attr_on else 0.0
        try:
            if task_id in self._cancelled_pending:
                raise TaskCancelledError(task_id)
            self._ensure_job_env(spec.get("job_id"))
            args, kwargs, arg_refs = self._resolve_task_args(spec["args"])
            if attr_on:
                now = time.perf_counter()
                split["arg_resolve"] = int((now - _tmark) * 1e6)
                _tmark = now
            traced = tracing_enabled() or spec.get("trace_ctx")
            ctx = (span(f"actor.run {name}",
                        parent=spec.get("trace_ctx"),
                        attributes={"task_id": task_id,
                                    "actor_id": spec.get("actor_id"),
                                    "component": "worker"})
                   if traced else contextlib.nullcontext())
            with ctx:
                if spec["method"] == "__ray_call__":
                    # fn(actor_instance, *args): the system method for
                    # running arbitrary code against a live actor
                    # (reference: __ray_call__ in python/ray/actor.py).
                    fn, args = args[0], args[1:]
                    value = self._run_user_code(
                        task_id,
                        lambda: fn(self._actor_instance, *args, **kwargs))
                else:
                    method = getattr(self._actor_instance, spec["method"])
                    value = self._run_user_code(
                        task_id, lambda: method(*args, **kwargs))
            if _inspect.iscoroutine(value):
                cfut = asyncio.run_coroutine_threadsafe(
                    value, self._actor_loop)
                self._running_task_cfuts[task_id] = cfut
                try:
                    value = cfut.result()
                except concurrent.futures.CancelledError:
                    raise TaskCancelledError(task_id)
                finally:
                    self._running_task_cfuts.pop(task_id, None)
            if attr_on:
                now = time.perf_counter()
                split["exec"] = int((now - _tmark) * 1e6)
                _tmark = now
            args = kwargs = None
            results = self._package_returns(task_id, num_returns, name,
                                            value)
            if attr_on:
                split["result_pack"] = int(
                    (time.perf_counter() - _tmark) * 1e6)
            ok = True
        except BaseException as e:  # noqa: BLE001
            self._die_if_orphaned()
            results = self._package_error(task_id, num_returns, name, e)
        finally:
            # See _execute_task: only genuinely retained arg refs (here
            # usually actor state) must survive as registered borrows.
            args = kwargs = value = None
            self._commit_arg_borrows(arg_refs)
            self._running_task_threads.pop(task_id, None)
            self._cancelled_pending.discard(task_id)
            self._cancel_sent.discard(task_id)
            self._cancel_swallowed.discard(task_id)
            self._record_task_event(
                task_id, name, "FINISHED" if ok else "FAILED",
                job_id=spec.get("job_id"),
                actor_id=spec.get("actor_id"))
            _reset_task_context(token)
        if attr_on:
            return {"results": results, "attr_exec": split}
        return {"results": results}

    async def handle_push_actor_task(self, conn: ServerConnection, *,
                                     spec: dict) -> dict:
        attr_on = attribution.enabled
        _t0 = time.perf_counter() if attr_on else 0.0
        if isinstance(spec, dict) and "_t" in spec:
            spec = self._decode_spec(conn, spec, "ActorTaskSpec")
        # Decode measured BEFORE the per-caller ordering gate: a task
        # waiting its turn behind a slow predecessor is actor
        # contention, and must not be booked as wire-decode cost.
        decode_us = int((time.perf_counter() - _t0) * 1e6) if attr_on else 0
        if self._actor_instance is None:
            raise RpcError("no actor instance on this worker")
        if spec.get("streaming"):
            await self._await_actor_turn(spec)
            self._advance_actor_turn(spec)
            return await self._execute_streaming(spec, actor=True)
        loop = asyncio.get_running_loop()
        await self._await_actor_turn(spec)
        executor = (getattr(self, "_actor_group_executors", {}) or {}).get(
            spec.get("concurrency_group"))
        fut = loop.run_in_executor(
            executor or self._actor_executor or self._exec_pool,
            self._execute_actor_method, spec)
        self._advance_actor_turn(spec)
        reply = await fut
        if attr_on:
            attr = {"decode": decode_us}
            attr.update(reply.pop("attr_exec", None) or {})
            reply["attr"] = attr
        return reply

    # Explicit per-caller sequencing (reference:
    # sequential_actor_submit_queue.h): the caller stamps each actor task
    # with a monotonically increasing seq; dispatch here is gated so a
    # task never STARTS before its predecessors from the same caller,
    # regardless of any future awaits added earlier in this handler.
    def _actor_seq_entry(self, caller: str) -> dict:
        entry = self._actor_seq.get(caller)
        if entry is None:
            if len(self._actor_seq) >= 256:
                # Bound per-caller state: drop idle entries (no waiters —
                # long-gone callers); adopt-first-seen re-seeds any that
                # come back.
                for key, e in list(self._actor_seq.items()):
                    if not e["cond"]._waiters and not e["waiting"]:
                        del self._actor_seq[key]
            entry = {"next": None, "cond": asyncio.Condition(),
                     "skipped": set(), "waiting": 0}
            self._actor_seq[caller] = entry
        return entry

    async def handle_actor_seq_skip(self, conn: ServerConnection, *,
                                    owner: str,
                                    seq: Optional[int] = None) -> bool:
        """A seq consumed caller-side will never be pushed (cancelled
        pre-push): release successors immediately."""
        if seq is None:
            return True
        entry = self._actor_seq_entry(owner)
        async with entry["cond"]:
            entry["skipped"].add(seq)
            entry["cond"].notify_all()
        return True

    async def _await_actor_turn(self, spec: dict) -> None:
        seq = spec.get("seq")
        if seq is None:
            return
        entry = self._actor_seq_entry(spec.get("owner", ""))
        # Fast path: everything here runs on the one worker event loop,
        # so plain dict reads/writes are race-free between awaits — the
        # Condition is only needed when this task actually has to wait
        # (out-of-order arrival, which TCP ordering makes rare).
        while entry["next"] is not None and entry["next"] < seq:
            if entry["next"] in entry["skipped"]:
                # Explicitly-skipped hole (cancelled pre-push).
                entry["skipped"].discard(entry["next"])
                entry["next"] += 1
                continue
            # Announce intent-to-wait synchronously (single-threaded
            # loop: no await between here and _advance's check), so the
            # advancer can't miss us while cond.wait() is still
            # registering its waiter.
            entry["waiting"] += 1
            try:
                async with entry["cond"]:
                    # Full re-check under the lock, INCLUDING skip holes:
                    # a skip notification can land while we were queued
                    # on the lock, and missing it here would stall 60s.
                    while (entry["next"] is not None
                           and entry["next"] < seq
                           and entry["next"] in entry["skipped"]):
                        entry["skipped"].discard(entry["next"])
                        entry["next"] += 1
                    if entry["next"] is not None and entry["next"] >= seq:
                        break
                    try:
                        await asyncio.wait_for(entry["cond"].wait(),
                                               timeout=60.0)
                    except asyncio.TimeoutError:
                        # A predecessor seq was consumed caller-side but
                        # its push never arrived (failed before send):
                        # liveness over strictness — adopt this seq.
                        entry["next"] = seq
            finally:
                entry["waiting"] -= 1
        if entry["next"] is None:
            # First task seen from this caller (fresh worker, or the
            # caller reconnected after a restart): adopt its seq.
            entry["next"] = seq

    def _advance_actor_turn(self, spec: dict) -> None:
        seq = spec.get("seq")
        if seq is None:
            return
        entry = self._actor_seq_entry(spec.get("owner", ""))
        if entry["next"] is not None and entry["next"] == seq:
            entry["next"] = seq + 1
        if not entry["waiting"]:
            return  # nobody waiting (or registering): skip the notify

        async def notify():
            async with entry["cond"]:
                entry["cond"].notify_all()

        asyncio.ensure_future(notify())

    async def handle_cgraph_push(self, conn: ServerConnection, *,
                                 channel: str, data: bytes, seq: int = 0,
                                 capacity: int = 8, kind: str = "obj",
                                 ordered: bool = True) -> bool:
        """Compiled-graph channel deposit (reference: the shared-memory
        channel write in ray/experimental/channel/). The reader process
        hosts the slot buffer; this handler admits one pushed frame in
        writer order (a large frame arrives as an RPC blob, `data` then
        being its one buffer). The deposit blocks while the slot is full
        — the delayed reply IS the writer's backpressure — so it runs on
        a thread pool of its own, never on the RPC loop."""
        from ray_tpu_torch.cgraph.channel import (deposit_nowait,
                                                  deposit_remote)

        if deposit_nowait(kind, channel, capacity, data, seq,
                          ordered=ordered):
            return True   # free slot, in-order frame: no thread hop
        # Dedicated pool: a full channel parks its deposit thread for up
        # to the push timeout — on the shared default executor that would
        # head-of-line-block unrelated work (generator pushes, to_thread).
        pool = getattr(self, "_cgraph_deposit_pool", None)
        if pool is None:
            pool = self._cgraph_deposit_pool = (
                concurrent.futures.ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="cgraph-deposit"))
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            pool,
            lambda: deposit_remote(kind, channel, capacity, data, seq,
                                   ordered=ordered))

    async def handle_collective_ranks(self, conn: ServerConnection) -> dict:
        """{group: rank} of this process's collective groups — the
        device-channel writer's route discovery (cgraph/channel.py
        DeviceChannel._ensure_route)."""
        from ray_tpu_torch.util.collective import local_ranks

        return local_ranks()

    async def handle_exit_worker(self, conn: ServerConnection) -> bool:

        async def _die():
            await asyncio.sleep(0.05)
            os._exit(0)

        asyncio.ensure_future(_die())
        return True

    # ==================================================================
    # cluster introspection
    # ==================================================================
    def nodes(self) -> List[dict]:
        raw = self._loop.run(self._gcs.get_nodes())
        return [{
            "NodeID": n["node_id"],
            "Alive": n["alive"],
            "Resources": n.get("resources_total", {}),
            "Available": n.get("resources_available", {}),
            "NodeManagerAddress": n.get("address"),
            "IsHeadNode": n.get("is_head", False),
            "Labels": n.get("labels", {}),
        } for n in raw]

    def object_store_stats(self) -> List[dict]:
        """Every alive raylet's plasma inventory (state API
        list_objects / `ray_tpu memory`)."""

        async def collect():
            out = []
            for n in await self._gcs.get_nodes():
                if not n.get("alive"):
                    continue
                try:
                    client = await self._raylet_client(n["address"])
                    stats = await client.call("object_store_stats",
                                              timeout=10.0)
                    for obj in stats["objects"]:
                        out.append(dict(obj, node_id=stats["node_id"],
                                        address=n["address"]))
                except Exception:
                    continue
            return out

        return self._loop.run(collect(), timeout=60)

    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self._loop.run(self._gcs.get_nodes()):
            if not n.get("alive"):
                continue
            for k, v in n.get("resources_total", {}).items():
                out[k] = out.get(k, 0.0) + v
        return out

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self._loop.run(self._gcs.get_nodes()):
            if not n.get("alive"):
                continue
            for k, v in n.get("resources_available", {}).items():
                out[k] = out.get(k, 0.0) + v
        return out

    # -- internal kv ----------------------------------------------------
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True):
        k = key.decode() if isinstance(key, bytes) else key
        return self._loop.run(self._gcs.kv_put(k, value, overwrite))

    def kv_get(self, key: bytes) -> Optional[bytes]:
        k = key.decode() if isinstance(key, bytes) else key
        return self._loop.run(self._gcs.kv_get(k))

    def kv_del(self, key: bytes) -> None:
        k = key.decode() if isinstance(key, bytes) else key
        self._loop.run(self._gcs.kv_del(k))

    def kv_keys(self, prefix: bytes) -> List[bytes]:
        p = prefix.decode() if isinstance(prefix, bytes) else prefix
        return [k.encode() for k in self._loop.run(self._gcs.kv_keys(p))]


_RUN_USER_CODE = ClusterRuntime._run_user_code.__code__
