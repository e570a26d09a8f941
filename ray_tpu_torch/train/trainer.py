"""TorchTrainer: data/model-parallel SPMD training on a gang of actors,
the port of `ray_tpu/train/trainer.py`'s JaxTrainer.

Reference skeleton: `python/ray/train/base_trainer.py:579` (fit) +
`data_parallel_trainer.py:416` (training_loop), with the process-group
seam of `torch/config.py` (`TorchConfig`: NCCL on cards, gloo on the
CPU). `fit()` runs as a one-trial Tune job; failures restart the WHOLE
gang from the latest checkpoint — a process group cannot survive member
loss.

The train loop goes to the workers by reference (the port has no
cloudpickle): define it at module level, in a module the workers can
import. A lambda or closure raises `TypeError` at construction, naming
it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig, TrainConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.backend_executor import (BackendExecutor,
                                                      TrainingWorkerError)
from ray_tpu_torch.core.serialization import dumps
from ray_tpu_torch.train.backend import TorchConfig

logger = logging.getLogger(__name__)


class TrainingFailedError(RuntimeError):
    """Training failed after exhausting FailureConfig.max_failures."""


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 train_config: Optional["TrainConfig"] = None):
        # Pickled on the driver, by reference: a loop the workers cannot
        # import raises TypeError here, naming it.
        self._train_fn = dumps(train_loop_per_worker)
        self._train_config = train_loop_config
        self._torch_config = torch_config or TorchConfig()
        self._scaling = scaling_config or ScalingConfig()
        self._torch_config.check_scaling(self._scaling)
        self._run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._resume_checkpoint = resume_from_checkpoint
        self._instrumentation = train_config

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        """Run as a single-trial Tune job (reference: base_trainer.py:579 —
        `fit` wraps the trainer `as_trainable` and drives it through the
        Tune controller). Raises TrainingFailedError after exhausting
        FailureConfig.max_failures, like the reference."""
        from ray_tpu_torch.tune.trial import ERROR
        from ray_tpu_torch.tune.tuner import TuneConfig, Tuner

        run_name = self._run_config.name or f"TorchTrainer_{int(time.time())}"
        self._run_config.name = run_name
        grid = Tuner(self, run_config=self._run_config,
                     tune_config=TuneConfig(num_samples=1)).fit()
        trial = grid[0]
        if trial.status == ERROR:
            raise TrainingFailedError(trial.error or "training failed")
        result = trial.final
        if not isinstance(result, Result):
            raise TrainingFailedError(
                f"trainable returned no Result (got {type(result)})")
        if result.error is not None:
            raise result.error
        return result

    def _run(self, config: Optional[dict] = None) -> Result:
        """The gang-training loop body (runs inside the Tune trial actor,
        or directly on the driver via `as_trainable()()`)."""
        from ray_tpu_torch.air.session import _get_session

        if config:
            merged = dict(self._train_config or {})
            merged.update(config)
            self._train_config = merged
        tune_session = _get_session(required=False)

        run_name = self._run_config.name or f"TorchTrainer_{int(time.time())}"
        exp_dir = os.path.join(self._run_config.resolved_storage_path(),
                               run_name)
        if tune_session is not None and tune_session.trial_name:
            # Per-trial checkpoint dir (reference storage layout:
            # storage/<experiment>/<trial>/checkpoint_*): concurrent trials
            # of one tuned trainer must not share checkpoint paths.
            exp_dir = os.path.join(exp_dir, tune_session.trial_name)
        os.makedirs(exp_dir, exist_ok=True)

        max_failures = self._run_config.failure_config.max_failures
        failures = 0
        checkpoint = self._resume_checkpoint
        if checkpoint is None and tune_session is not None:
            # Experiment resume: the controller re-seeds an interrupted
            # trial with its latest persisted checkpoint.
            checkpoint = tune_session.loaded_checkpoint
        latest_ckpt: Optional[Checkpoint] = checkpoint
        history: List[Dict[str, Any]] = []
        ckpt_index = 0

        while True:
            executor = BackendExecutor(self._torch_config, self._scaling)
            try:
                executor.start()
                executor.start_training(
                    self._train_fn, self._train_config,
                    trial_name=run_name, checkpoint=latest_ckpt,
                    dataset_shards=self._dataset_shards(),
                    profile_steps=(self._instrumentation.profile_steps
                                   if self._instrumentation else None),
                    profile_dir=(self._instrumentation.profile_dir
                                 if self._instrumentation else None))
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    # Rank 0's report (lowest surviving rank on mixed-done
                    # rounds) is the canonical metrics source.
                    lead = min(results,
                               key=lambda r: r.get("world_rank", 1 << 30))
                    metrics = lead.get("metrics", {})
                    history.append(metrics)
                    # Step telemetry (session report metadata) rides the
                    # persisted line only — user-visible metrics stay
                    # exactly what the train loop reported.
                    line = dict(metrics)
                    if lead.get("telemetry"):
                        line["_telemetry"] = lead["telemetry"]
                    self._append_result(exp_dir, line)
                    ckpt = next((r.get("checkpoint") for r in results
                                 if r.get("checkpoint") is not None), None)
                    if ckpt is not None:
                        latest_ckpt = self._persist_checkpoint(
                            exp_dir, ckpt_index, ckpt)
                        ckpt_index += 1
                        self._prune_checkpoints(exp_dir)
                    if tune_session is not None:
                        # Forward the round to the Tune controller: it
                        # records progress, records the trial checkpoint
                        # (the already-persisted dir-backed one — no second
                        # copy), and may raise _StopTraining.
                        tune_session.report(
                            metrics,
                            checkpoint=(latest_ckpt if ckpt is not None
                                        else None))
                last = history[-1] if history else {}
                return Result(metrics=last, checkpoint=latest_ckpt,
                              path=exp_dir, metrics_history=history)
            except TrainingWorkerError as e:
                failures += 1
                retry = max_failures < 0 or failures <= max_failures
                logger.warning(
                    "training gang failed (%s); %s", e,
                    "restarting from latest checkpoint" if retry
                    else "failures exhausted")
                if not retry:
                    err = TrainingFailedError(str(e))
                    return Result(metrics=history[-1] if history else {},
                                  checkpoint=latest_ckpt, error=err,
                                  path=exp_dir, metrics_history=history)
            finally:
                executor.shutdown()

    # ------------------------------------------------------------------
    def _dataset_shards(self) -> Optional[List[Any]]:
        """Each worker's {name: shard}: a `data.Dataset` splits with
        `split_for_workers` (disjoint blocks, round-robin), an object with
        `split` with that, anything else goes whole to every worker."""
        if not self._datasets:
            return None
        n = self._scaling.num_workers
        shards: List[Any] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "split_for_workers"):
                parts = ds.split_for_workers(n)
            elif hasattr(ds, "split"):
                parts = ds.split(n)
            else:
                parts = [ds] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards

    def _persist_checkpoint(self, exp_dir: str, index: int,
                            ckpt: Checkpoint) -> Checkpoint:
        path = os.path.join(exp_dir, f"checkpoint_{index:06d}")
        ckpt.to_directory(path)
        return Checkpoint.from_directory(path)

    def _prune_checkpoints(self, exp_dir: str) -> None:
        keep = self._run_config.checkpoint_config.num_to_keep
        if not keep:
            return
        import shutil

        dirs = sorted(d for d in os.listdir(exp_dir)
                      if d.startswith("checkpoint_"))
        for d in dirs[:-keep]:
            shutil.rmtree(os.path.join(exp_dir, d), ignore_errors=True)

    def _append_result(self, exp_dir: str, metrics: Dict[str, Any]) -> None:
        try:
            with open(os.path.join(exp_dir, "result.json"), "a") as f:
                f.write(json.dumps(metrics, default=str) + "\n")
        except Exception:
            pass

    # -- Tune integration (reference: BaseTrainer.as_trainable) ---------
    def as_trainable(self) -> Callable[[Optional[dict]], Result]:
        return _Trainable(self)


class _Trainable:
    """The trainer as a Tune trainable. A module-level callable rather
    than the reference's closure: it travels to the trial actor by value,
    its class by reference."""

    __name__ = "TorchTrainer"

    def __init__(self, trainer: TorchTrainer):
        self.trainer = trainer

    def __call__(self, config: Optional[dict] = None) -> Result:
        return self.trainer._run(config)
