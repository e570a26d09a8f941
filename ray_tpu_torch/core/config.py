"""Config flag registry, the port of `ray_tpu/core/config.py` (same
names and defaults, except `native_object_store`, whose store waits).

Equivalent of the reference's `RAY_CONFIG(type, name, default)` system
(`src/ray/common/ray_config_def.h`, 209 entries materialized into a singleton,
settable via `RAY_{name}` env vars and a `_system_config` dict from init).
Here: typed declarations, `RAY_TPU_{NAME}` env overrides, and an
`apply_system_config` hook from `ray_tpu_torch.init(_system_config=...)`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _Flag:
    name: str
    default: Any
    type: Callable[[str], Any]
    doc: str


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Singleton flag store. Declare with `_declare`, read as attributes."""

    _flags: Dict[str, _Flag] = {}

    def __init__(self):
        self._values: Dict[str, Any] = {}

    @classmethod
    def _declare(cls, name: str, default: Any, doc: str = ""):
        if isinstance(default, bool):
            typ: Callable[[str], Any] = _parse_bool
        elif isinstance(default, int):
            typ = int
        elif isinstance(default, float):
            typ = float
        else:
            typ = str
        cls._flags[name] = _Flag(name, default, typ, doc)

    def __getattr__(self, name: str) -> Any:
        flags = type(self)._flags
        if name.startswith("_") or name not in flags:
            raise AttributeError(name)
        if name in self._values:
            return self._values[name]
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            return flags[name].type(env)
        return flags[name].default

    def apply_system_config(self, system_config: Dict[str, Any] | str | None):
        if system_config is None:
            return
        if isinstance(system_config, str):
            system_config = json.loads(system_config)
        for k, v in system_config.items():
            if k not in type(self)._flags:
                raise ValueError(f"Unknown system config key: {k}")
            self._values[k] = v

    def serialize(self) -> str:
        """Serialize overrides so child processes inherit driver-set config."""
        return json.dumps(self._values)


_D = Config._declare

# -- core ---------------------------------------------------------------
_D("max_direct_call_object_size", 100 * 1024,
   "Objects <= this many bytes are returned inline / kept in the in-process "
   "memory store instead of the shared-memory store (reference: "
   "ray_config_def.h max_direct_call_object_size).")
_D("object_store_memory_bytes", 2 * 1024**3,
   "Default per-node object store capacity.")
_D("task_retry_delay_ms", 0, "Delay before retrying a failed task.")
_D("worker_lease_timeout_ms", 30_000, "Lease request timeout.")
_D("num_workers_soft_limit", 0, "0 = #CPUs on the node.")
_D("health_check_period_ms", 1000,
   "GCS->raylet health check interval (reference: gcs_health_check_manager).")
_D("health_check_failure_threshold", 5,
   "Missed health checks before a node is marked dead.")
_D("gcs_rpc_timeout_s", 30.0, "Client-side timeout for GCS RPCs.")
_D("gcs_reconnect_backoff_base_ms", 50.0,
   "First retry delay of the GCS-reconnect backoff. Retries grow "
   "exponentially from here with FULL jitter (each sleep is uniform in "
   "[0, min(cap, base*2^attempt)]) so 100 clients losing the GCS at once "
   "de-synchronize instead of hammering the restarted server in "
   "lockstep (the classic thundering-herd fix; reference: gcs_client "
   "reconnect backoff).")
_D("gcs_reconnect_backoff_max_ms", 5000.0,
   "Cap on the GCS-reconnect backoff delay.")
_D("gcs_restart_node_grace_ms", 0,
   "After a GCS restart recovers persisted node records, a recovered "
   "node is not declared dead until this grace has passed without a "
   "heartbeat — every raylet needs at least one full heartbeat interval "
   "to find the restarted server before the health loop may judge it. "
   "0 = derive from health_check_period_ms * health_check_failure_"
   "threshold.")
_D("owner_unreachable_grace_s", 5.0,
   "How long a borrower-side pull tolerates an unreachable object owner "
   "before declaring the owner dead: within the grace the pull retries "
   "(transient blip, GCS failover), past it the get fails loudly with "
   "OwnerDiedError instead of hanging or mislabeling the loss "
   "(reference: OBJECT_UNRECOVERABLE_OWNER_DIED).")
_D("raylet_heartbeat_period_ms", 250, "Raylet->GCS resource report interval.")
_D("cluster_view_refresh_ms", 1000,
   "How often a raylet refreshes its full cluster view (the node table "
   "feeding spillback targeting and dead-address checks), decoupled "
   "from the heartbeat. Round-15 1000-node profiling found the "
   "per-heartbeat get_nodes() fetch is the GCS dispatch wall at scale: "
   "N nodes × (1/period) full-table replies per second is O(N^2) "
   "records/s — at N=1000 that alone saturated the sim's GCS loop. "
   "Liveness still rides every heartbeat; the view tolerates seconds "
   "of staleness (the retry/spillback discipline re-resolves).")
_D("actor_restart_backoff_ms", 1000, "Backoff between actor restarts.")
_D("metrics_report_interval_ms", 2000, "Metrics agent scrape/export interval.")
_D("max_pending_lease_requests_per_scheduling_category", 10,
   "Pipelined lease requests per scheduling key (reference name identical).")
_D("worker_pipeline_depth", 8,
   "Tasks pushed to one leased worker before its first reply returns. "
   "Keeps the worker's (single-threaded) execution queue fed across the "
   "push/reply round trip instead of idling it for one RTT per task "
   "(reference: lease reuse in direct_task_transport.cc OnWorkerIdle).")
_D("scheduler_spread_threshold", 0.5,
   "Hybrid policy utilization threshold below which tasks pack on the local "
   "node (reference: hybrid_scheduling_policy.h).")
_D("object_timeout_ms", 100, "Plasma get poll interval.")
_D("native_object_store", False,
   "The C++ shared-memory object store of the reference "
   "(ray_tpu/native/store.cc). It waits for a later slice of the port: "
   "the Python shm store serves every node, and True raises.")
_D("memory_monitor_refresh_ms", 250, "OOM monitor interval; 0 disables.")
_D("memory_usage_threshold", 0.95, "Node memory fraction that triggers the OOM killer.")
_D("lineage_reconstruction", True,
   "Owner-side lineage reconstruction of lost objects (round 15): the "
   "owner retains the wire-encoded spec of any task whose result was "
   "store-sealed (and pins the task's argument objects) while a return "
   "ref lives, and re-executes it through the normal dispatch tiers "
   "when the last copy is lost (holder node died, evicted everywhere). "
   "Borrowers' in-flight gets block-and-retry through the re-execution "
   "instead of failing. Disabling restores the pre-round-15 behavior: "
   "loss surfaces immediately as the typed ObjectLostError "
   "(reference: task_manager.h lineage pinning + "
   "object_recovery_manager.h).")
_D("lineage_reconstruction_budget", 8,
   "Hard cap on per-object re-executions, regardless of max_retries: "
   "a flapping node must not re-run a task unboundedly. Exhausting "
   "the budget degrades the next loss to ObjectLostError.")
_D("cgraph_restart", True,
   "Compiled-graph recovery: when a loop actor of a compiled DAG dies, "
   "recompile its schedule onto the restarted replacement (bounded by "
   "the actors' max_task_retries budget) and resume — in-flight "
   "executions still fail with the actor-death error, but the graph "
   "accepts new executes instead of staying poisoned until teardown. "
   "Disabling restores permanent poisoning.")
_D("borrow_escrow_s", 600.0,
   "How long a result-embedded ref stays escrow-pinned in its owner "
   "process, bridging the gap between shipping a result and the "
   "consumer's register_borrow (reference: reference_count.h borrowing "
   "protocol, here time-bounded).")

_D("object_transfer_chunk_bytes", 1 << 20,
   "Inter-node object transfer chunk size (reference: ObjectBufferPool "
   "chunking, object_manager.h).")
_D("lease_idle_linger_s", 0.05,
   "How long an idle lease is cached for reuse before returning to the "
   "raylet (reference: idle lease cache in direct_task_transport).")
_D("pipeline_service_threshold_s", 0.03,
   "Deep lease pipelining only engages for workers whose observed "
   "push->reply time is under this; slower tasks parallelize via fresh "
   "leases and spillback.")
_D("log_monitor_interval_s", 0.3,
   "Worker log tail/publish interval (reference: log_monitor.py).")
_D("borrow_commit_timeout_s", 35.0,
   "Deadline for registering retained arg borrows with owners at task "
   "completion (reference: borrowed-refs report in the task reply).")

# -- task-plane fast paths (round 8) -------------------------------------
_D("task_inline_threshold_ms", 1.0,
   "Same-process inline execution of tiny tasks: a task with default "
   "options and locally resolved ObjectRef args runs on the caller "
   "thread when its function's exec-time EMA for that arg-size bucket "
   "sits below this ceiling, in milliseconds. The "
   "EMA starts unknown (first calls go remote and report exec_us in "
   "their replies), so a long or blocking task is never inlined on "
   "spec. Break-even on an N-core box is roughly "
   "per-task-overhead / (N - 1).")
_D("lease_batch_max", 8,
   "Max leases requested in one batched lease RPC.")
_D("submit_ring", False,
   "Worker-direct dispatch rings of the reference (SPSC shm ring pairs "
   "between a driver and its node-local leased workers). They come with "
   "a later slice of the port; True raises at runtime construction.")

# -- flight recorder (round 12 observability) ----------------------------
_D("flight_recorder", True,
   "Per-process flight recorder (core/flight.py): a fixed-capacity "
   "ring of recent events (submit tiers, lease traffic, SPSC ring "
   "primitives, worker exec, engine steps, GC pauses, loop-lag "
   "heartbeats) plus the stall watchdog that snapshots the ring and "
   "an all-threads stack dump when an event loop blocks past "
   "stall_threshold_ms. Always-on by design (Dapper-style low-overhead "
   "recording; the perf guard pins overhead <=10% of tasks/s); "
   "disabling restores the zero-cost-off path at every call site.")
_D("flight_events", 4096,
   "Flight-recorder ring capacity (most recent N events kept).")
_D("flight_heartbeat_ms", 50.0,
   "Loop-lag watchdog heartbeat period: each watched event loop "
   "schedules a beat this often and records its own scheduling delay.")
_D("stall_threshold_ms", 100.0,
   "A watched loop's heartbeat going overdue past this opens a stall "
   "episode: all-threads stack dump captured mid-stall, ring snapshot "
   "+ lag measurement written as a JSON report under the session log "
   "dir, surfaced at GET /api/stalls.")

# -- metrics pipeline (round 17 observability) ---------------------------
_D("metrics_pipeline", True,
   "Pushed cluster metrics pipeline (core/metrics_ts.py): every process "
   "delta-encodes its metrics-registry snapshots into a bounded ring and "
   "ships them to its raylet with the existing report_metrics push; the "
   "raylet folds all worker batches plus its own runtime gauges into ONE "
   "coalesced payload piggybacked on the existing GCS heartbeat — fleet "
   "cost O(nodes), not O(processes). Zero-cost-off like the flight "
   "recorder: disabling restores the bespoke per-raylet poll path.")
_D("metrics_ts_ring", 128,
   "Per-process pending-batch ring capacity (unacked capture intervals "
   "retained across raylet hiccups before the oldest are dropped).")
_D("metrics_retention_points", 512,
   "GCS retention ring: data points kept per series (at the default "
   "2 s capture interval this is ~17 min of history per series).")
_D("metrics_max_series", 2000,
   "GCS series-cardinality cap; pushes for new series past the cap are "
   "counted as dropped instead of registered (label explosions degrade "
   "to a visible counter, not unbounded memory).")
_D("slo_eval_period_ms", 1000,
   "GCS SLO burn-rate evaluation period (multi-window state machine "
   "over the retention store; rides the health-check loop).")

# -- tensor plane --------------------------------------------------------
_D("gcs_wal_compact_bytes", 4 * 1024 * 1024,
   "GCS write-ahead-log size that triggers snapshot compaction.")
_D("object_pull_budget_bytes", 256 * 1024 * 1024,
   "Byte budget for concurrent inbound object transfers "
   "(reference: pull_manager.h admission control).")
_D("object_push_concurrency", 8,
   "Max concurrent outbound object-chunk serves per raylet "
   "(reference: push_manager.h bounded in-flight pushes).")

_config = Config()


def ray_config() -> Config:
    return _config
