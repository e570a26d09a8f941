"""BackendExecutor: gang lifecycle + training-loop driver, the port of
`ray_tpu/train/_internal/backend_executor.py`.

Reference: `python/ray/train/_internal/backend_executor.py:65`
(`start :124`, `start_training :438`). Orchestrates: gang-reserve a
placement group -> spawn WorkerGroup -> backend.on_start
(torch.distributed bootstrap) -> launch user loop on all workers -> poll
results in lockstep -> surface gang failures.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.exceptions import GetTimeoutError, RayActorError, RayTaskError
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import BackendConfig

logger = logging.getLogger(__name__)

def _round_metrics() -> Dict[str, Any]:
    """Driver-side train telemetry instruments (lazy: registered in
    whichever process drives the gang — the driver or a Tune trial
    actor — both of which push to their raylet)."""
    from ray_tpu_torch.util.metrics import Gauge, Histogram, get_instruments

    def build():
        return {
            "round": Histogram(
                "train_round_time_seconds",
                "Wall time between lockstep result rounds (driver view)",
                boundaries=[0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0],
                tag_keys=("trial",)),
            "workers": Gauge(
                "train_gang_workers",
                "Workers in the live training gang",
                tag_keys=("trial",)),
            "step": Gauge(
                "train_last_step_time_seconds",
                "Rank-0 step time of the most recent report",
                tag_keys=("trial", "phase")),
        }

    return get_instruments("train.executor", build)


class TrainingWorkerError(Exception):
    """A worker of the gang failed; SPMD training requires whole-gang
    restart (a process group cannot survive member loss)."""


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: Optional[ScalingConfig] = None):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config or ScalingConfig()
        self.worker_group: Optional[WorkerGroup] = None
        self._owned_pg = None  # PG we created (removed on shutdown)
        self._trial_name = "default"
        self._last_round_t: Optional[float] = None
        # Aggregated view of the gang's most recent telemetry, served to
        # callers (trainer result.json, dashboard /api/train).
        self.last_telemetry: Optional[Dict[str, Any]] = None

    def start(self, placement_group=None) -> None:
        if placement_group is None:
            # Gang-reserve the whole worker group up front (reference:
            # trainers always run under a PG — tune/execution/
            # placement_groups.py); partial gangs deadlock SPMD training.
            from ray_tpu_torch.util import placement_group as pg_factory

            placement_group = pg_factory(
                self._scaling.as_placement_group_factory(),
                strategy=self._scaling.placement_strategy,
                name="train-worker-group")
            self._owned_pg = placement_group
            if not placement_group.wait(timeout_seconds=60.0):
                state = _pg_state(placement_group)
                self._remove_owned_pg()
                raise RuntimeError(
                    f"could not gang-reserve {self._scaling.num_workers} "
                    f"training worker(s) "
                    f"({self._scaling.worker_resources()} each, "
                    f"{self._scaling.placement_strategy}): {state}")
        self.worker_group = WorkerGroup(
            self._scaling.num_workers,
            self._scaling.worker_resources(),
            placement_group=placement_group)
        self._backend.on_start(self.worker_group, self._backend_config)

    def _remove_owned_pg(self) -> None:
        if self._owned_pg is not None:
            try:
                from ray_tpu_torch.util import remove_placement_group

                remove_placement_group(self._owned_pg)
            except Exception:
                pass
            self._owned_pg = None

    def start_training(self, train_fn: Callable, config: Optional[dict],
                       *, trial_name: str = "", checkpoint=None,
                       dataset_shards: Optional[List[Any]] = None,
                       profile_steps: Optional[tuple] = None,
                       profile_dir: Optional[str] = None) -> None:
        wg = self.worker_group
        assert wg is not None, "call start() first"
        self._trial_name = trial_name or "default"
        self._last_round_t = None
        try:
            _round_metrics()["workers"].set(
                len(wg), tags={"trial": self._trial_name})
        except Exception:
            pass
        self._backend.on_training_start(wg, self._backend_config)
        # rank bookkeeping: workers are already sorted by (node, pid)
        node_order: List[str] = []
        local_counts: Dict[str, int] = {}
        refs = []
        for i, w in enumerate(wg.workers):
            node = wg.metadata[i]["node_id"]
            if node not in node_order:
                node_order.append(node)
            local_rank = local_counts.get(node, 0)
            local_counts[node] = local_rank + 1
            shard = dataset_shards[i] if dataset_shards else None
            refs.append(w.start_training.remote(
                train_fn, config, world_rank=i, local_rank=local_rank,
                world_size=len(wg), node_rank=node_order.index(node),
                trial_name=trial_name, checkpoint=checkpoint,
                dataset_shard=shard, profile_steps=profile_steps,
                profile_dir=profile_dir))
        ray_tpu_torch.get(refs, timeout=300)

    def get_next_results(
            self, liveness_interval_s: float = 30.0,
    ) -> Optional[List[Dict[str, Any]]]:
        """One lockstep round: every worker's next report (or None when all
        workers finished). A dead/failed worker raises TrainingWorkerError.

        Results are polled with a bounded timeout: survivors of a gang
        member's death can be blocked inside an NCCL/gloo collective and
        never return their `next_result`, so each timeout window we probe
        worker liveness with a cheap actor call — a dead peer converts the
        hang into a gang restart instead of a driver deadlock."""
        wg = self.worker_group
        assert wg is not None
        refs = [w.next_result.remote() for w in wg.workers]
        while True:
            try:
                results = ray_tpu_torch.get(refs, timeout=liveness_interval_s)
                break
            except GetTimeoutError:
                self._probe_worker_liveness()
            except RayActorError as e:
                raise TrainingWorkerError(
                    f"training worker died: {e}") from e
            except RayTaskError as e:
                cause = e.cause if hasattr(e, "cause") else e
                raise TrainingWorkerError(
                    f"training worker failed: {cause}") from e
        # Tag each result with its world rank (workers are rank-ordered) so
        # callers can pick rank 0 even on mixed finish/report rounds.
        for rank, r in enumerate(results):
            r.setdefault("world_rank", rank)
        self._record_round_telemetry(results)
        done = [r for r in results if r.get("type") == "done"]
        if len(done) == len(results):
            return None
        if done:
            # Mixed finish/report: drive remaining workers to completion.
            return [r for r in results if r.get("type") != "done"] or None
        return results

    def _record_round_telemetry(self, results: List[Dict[str, Any]]
                                ) -> None:
        """Fold one round's worker telemetry into driver-side metrics:
        the round wall time (driver view) plus rank 0's step split from
        the session's report metadata."""
        try:
            now = time.perf_counter()
            metrics = _round_metrics()
            tags = {"trial": self._trial_name}
            if self._last_round_t is not None:
                metrics["round"].observe(now - self._last_round_t,
                                         tags=tags)
            self._last_round_t = now
            tele = [r.get("telemetry") for r in results
                    if r.get("telemetry")]
            if not tele:
                return
            lead = min(tele, key=lambda t: t.get("world_rank", 1 << 30))
            for phase in ("step_time", "data_wait", "collective",
                          "compute"):
                metrics["step"].set(
                    lead.get(f"{phase}_s", 0.0),
                    tags={"trial": self._trial_name, "phase": phase})
            self.last_telemetry = {
                "workers": len(results), "lead": dict(lead),
                "mean_step_time_s": sum(
                    t.get("step_time_s", 0.0) for t in tele) / len(tele),
            }
        except Exception:
            pass  # telemetry must never fail a training round

    def _probe_worker_liveness(self) -> None:
        """Ping every worker actor; a dead one raises TrainingWorkerError.

        Pings are checked per-ref: a batched get fetches sequentially
        against one deadline, so a frozen (but live) worker early in the
        list would mask a dead worker behind it."""
        wg = self.worker_group
        assert wg is not None
        pings = [w.ping.remote() for w in wg.workers]
        for rank, ref in enumerate(pings):
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except GetTimeoutError:
                continue  # slow but not provably dead; keep waiting
            except (RayActorError, RayTaskError) as e:
                raise TrainingWorkerError(
                    f"training worker {rank} died mid-collective: {e}"
                ) from e

    def stop_training(self) -> None:
        wg = self.worker_group
        if wg is None:
            return
        for w in wg.workers:
            try:
                w.stop_training.remote()
            except Exception:
                pass

    def shutdown(self) -> None:
        # The driving process may exit right after fit(): push its
        # train_* series now rather than waiting an interval.
        from ray_tpu_torch.util.metrics import flush_metrics_push

        flush_metrics_push()
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        self._remove_owned_pg()


def _pg_state(pg) -> str:
    try:
        from ray_tpu_torch.util import placement_group_table

        info = placement_group_table(pg) or {}
        return f"state={info.get('state')} {info.get('detail', '')}".strip()
    except Exception:
        return "state unavailable"
