"""TuneController: the experiment event loop, the port of
`ray_tpu/tune/controller.py`.

Reference equivalent: `python/ray/tune/execution/tune_controller.py:73`
(`step :716`, actor scheduling `:1021`, result processing `:1526`, save
`:1747`) over the air/execution actor manager. Here each trial runs in a
`_TrialRunner` actor (the TrainWorker session machinery reused at
world_size=1); the controller keeps one outstanding `next_result` ref per
running trial and multiplexes with `ray_tpu_torch.wait`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError, RayTaskError
from ray_tpu_torch.train._internal.worker_group import TrainWorker
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.trial import (ERROR, PENDING, RUNNING, TERMINATED, Trial)

logger = logging.getLogger(__name__)


class _TrialRunner(TrainWorker):
    """Actor body hosting one trial's trainable function."""


class TuneController:
    def __init__(self, trainable: Callable, trials: List[Trial], *,
                 exp_dir: str,
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 0,
                 trial_resources: Optional[Dict[str, float]] = None):
        from ray_tpu_torch.core.serialization import dumps

        # By reference (the port has no cloudpickle): a trainable the
        # trial actors cannot import raises TypeError here, naming it.
        self._trainable_blob = dumps(trainable)
        self.trials = trials
        self.exp_dir = exp_dir
        self.scheduler = scheduler or FIFOScheduler()
        # 0 = unlimited (reference: TuneConfig.max_concurrent_trials).
        self.max_concurrent = (max_concurrent if max_concurrent > 0
                               else 10 ** 9)
        self._trial_resources = dict(trial_resources or {"CPU": 0.0})
        self._actors: Dict[str, Any] = {}       # trial_id -> actor handle
        self._inflight: Dict[Any, Trial] = {}   # next_result ref -> trial
        os.makedirs(exp_dir, exist_ok=True)

    # -- lifecycle ------------------------------------------------------
    def run(self) -> List[Trial]:
        interrupted = True
        try:
            while not self._finished():
                self._launch_pending()
                self._process_events()
                self.save_state()
            interrupted = False
        finally:
            # On interruption (Ctrl+C / escaping error) trials stay RUNNING
            # in the snapshot so Tuner.restore reruns them; marking them
            # TERMINATED here would fake completion with partial results.
            self._cleanup(keep_status=interrupted)
            self.save_state()
        return self.trials

    def _finished(self) -> bool:
        return all(t.status in (TERMINATED, ERROR) for t in self.trials)

    # -- scheduling -----------------------------------------------------
    def _launch_pending(self) -> None:
        running = sum(1 for t in self.trials if t.status == RUNNING)
        for trial in self.trials:
            if running >= self.max_concurrent:
                break
            if trial.status != PENDING:
                continue
            try:
                self._start_trial(trial)
            except Exception as e:  # noqa: BLE001
                # One trial failing to start must not abort the experiment.
                self._on_trial_error(trial, e)
                continue
            running += 1

    def _start_trial(self, trial: Trial) -> None:
        num_cpus = self._trial_resources.get("CPU", 0.0)
        extras = {k: v for k, v in self._trial_resources.items()
                  if k != "CPU" and v}
        opts: Dict[str, Any] = {"num_cpus": num_cpus, "max_concurrency": 8}
        if extras:
            opts["resources"] = extras
        actor = ray_tpu_torch.remote(**opts)(_TrialRunner).remote()
        checkpoint = None
        if trial.checkpoint_dir and os.path.isdir(trial.checkpoint_dir):
            from ray_tpu_torch.air.checkpoint import Checkpoint

            checkpoint = Checkpoint.from_directory(trial.checkpoint_dir)
        ray_tpu_torch.get(actor.start_training.remote(
            self._trainable_blob, trial.config, world_rank=0, local_rank=0,
            world_size=1, node_rank=0, trial_name=trial.trial_id,
            checkpoint=checkpoint), timeout=120)
        trial.status = RUNNING
        self._actors[trial.trial_id] = actor
        self._poll(trial)
        logger.info("trial %s started: %s", trial.trial_id, trial.config)

    def _poll(self, trial: Trial) -> None:
        actor = self._actors[trial.trial_id]
        ref = actor.next_result.remote()
        self._inflight[ref] = trial

    # -- event processing ----------------------------------------------
    def _process_events(self) -> None:
        if not self._inflight:
            time.sleep(0.05)
            return
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                timeout=1.0)
        for ref in ready:
            trial = self._inflight.pop(ref)
            try:
                result = ray_tpu_torch.get(ref, timeout=30)
            except (RayActorError, RayTaskError) as e:
                self._on_trial_error(trial, e)
                continue
            if result.get("type") == "done":
                self._on_trial_done(trial, result)
            else:
                self._on_trial_report(trial, result)

    def _on_trial_report(self, trial: Trial, result: Dict[str, Any]
                         ) -> None:
        trial.iterations += 1
        metrics = dict(result.get("metrics", {}))
        metrics.setdefault("training_iteration", trial.iterations)
        metrics.setdefault("trial_id", trial.trial_id)
        trial.last_result = metrics
        ckpt = result.get("checkpoint")
        if ckpt is not None:
            trial.checkpoint_dir = self._persist_checkpoint(trial, ckpt)
        decision = self.scheduler.on_trial_result(trial, metrics)
        if decision == TrialScheduler.STOP:
            logger.info("trial %s stopped by scheduler at iter %d",
                        trial.trial_id, trial.iterations)
            self._stop_trial(trial, TERMINATED)
        elif decision == TrialScheduler.RESTART:
            logger.info("trial %s restarting with mutated config %s (PBT "
                        "exploit)", trial.trial_id, trial.config)
            self._restart_trial(trial)
        else:
            self._poll(trial)

    def _on_trial_done(self, trial: Trial, result: Dict[str, Any]) -> None:
        trial.status = TERMINATED
        trial.final = result.get("final")
        self.scheduler.on_trial_complete(trial, trial.last_result)
        self._teardown_actor(trial)

    def _on_trial_error(self, trial: Trial, exc: BaseException) -> None:
        logger.warning("trial %s failed: %s", trial.trial_id, exc)
        trial.status = ERROR
        trial.error = str(exc)
        self._teardown_actor(trial)

    def _restart_trial(self, trial: Trial) -> None:
        """PBT exploit: the scheduler swapped trial.config /
        trial.checkpoint_dir in place; relaunch the trial from there.
        The adopted checkpoint is copied under the trial's own dir first
        — the donor keeps pruning its old checkpoints and must not be
        able to delete the one we resume from."""
        src = trial.checkpoint_dir
        if src and os.path.isdir(src) and not src.startswith(
                os.path.join(self.exp_dir, trial.trial_id) + os.sep):
            import shutil

            dst = os.path.join(self.exp_dir, trial.trial_id,
                               f"exploit_{trial.iterations:06d}")
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(src, dst)
            trial.checkpoint_dir = dst
        self._detach_and_drain(trial)
        trial.status = PENDING  # _launch_pending relaunches next loop

    def _stop_trial(self, trial: Trial, status: str) -> None:
        trial.status = status
        self.scheduler.on_trial_complete(trial, trial.last_result)
        self._detach_and_drain(trial)

    def _detach(self, trial: Trial):
        """Unregister the trial's actor and drop its in-flight refs."""
        actor = self._actors.pop(trial.trial_id, None)
        for ref, t in list(self._inflight.items()):
            if t is trial:
                del self._inflight[ref]
        return actor

    def _detach_and_drain(self, trial: Trial) -> None:
        actor = self._detach(trial)
        if actor is None:
            return

        def drain_then_kill():
            # Off the controller loop: let the trainable unwind before the
            # actor dies — a TorchTrainer trial's _StopTraining path must
            # reach executor.shutdown() or its gang actors leak.
            import ray_tpu_torch

            try:
                actor.stop_training.remote()
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    r = ray_tpu_torch.get(actor.next_result.remote(),
                                    timeout=max(deadline - time.monotonic(),
                                                1.0))
                    if r.get("type") == "done":
                        break
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

        import threading

        threading.Thread(target=drain_then_kill, daemon=True,
                         name=f"stop-{trial.trial_id}").start()

    def _teardown_actor(self, trial: Trial) -> None:
        actor = self._detach(trial)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

    def _cleanup(self, keep_status: bool = False) -> None:
        for trial in self.trials:
            if trial.status == RUNNING:
                if keep_status:
                    self._teardown_actor(trial)  # snapshot keeps RUNNING
                else:
                    self._stop_trial(trial, TERMINATED)

    # -- persistence (reference: execution/experiment_state.py) ---------
    def _persist_checkpoint(self, trial: Trial, ckpt) -> str:
        # Already directory-backed (e.g. a TorchTrainer forwarding its own
        # persisted checkpoint): record the path, don't copy it again.
        existing = getattr(ckpt, "path", None)
        if existing and os.path.isdir(existing):
            return existing
        trial_dir = os.path.join(self.exp_dir, trial.trial_id)
        path = os.path.join(trial_dir,
                            f"checkpoint_{trial.iterations:06d}")
        ckpt.to_directory(path)
        # Resume only ever needs the latest; prune older copies.
        import shutil

        # Prune by age so PBT's `exploit_*` copies age out with the
        # regular `checkpoint_*` dirs (lexicographic order would
        # interleave the two prefixes wrongly).
        kept = sorted(
            (d for d in os.listdir(trial_dir)
             if d.startswith(("checkpoint_", "exploit_"))),
            key=lambda d: os.path.getmtime(os.path.join(trial_dir, d)))
        for d in kept[:-2]:
            shutil.rmtree(os.path.join(trial_dir, d), ignore_errors=True)
        return path

    def save_state(self) -> None:
        state = {"trials": [t.to_state() for t in self.trials],
                 "timestamp": time.time()}
        tmp = os.path.join(self.exp_dir, ".tuner_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, os.path.join(self.exp_dir, "tuner_state.json"))

    @staticmethod
    def load_state(exp_dir: str) -> Optional[List[Trial]]:
        path = os.path.join(exp_dir, "tuner_state.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        return [Trial.from_state(s) for s in state["trials"]]
