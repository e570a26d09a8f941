"""Tuner: the user-facing experiment API, the port of
`ray_tpu/tune/tuner.py`.

Reference equivalent: `python/ray/tune/tuner.py:54,346` (`Tuner.fit`) +
`tune.py:234`. A TorchTrainer passed as the trainable is unwrapped through
`as_trainable()` — the reference's `BaseTrainer.fit` is exactly a 1-trial
Tune job (`base_trainer.py:579`), and `TorchTrainer.fit` here routes the
same way. A function trainable goes to its trial actor by reference, so
it must be defined at module level.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.controller import TuneController
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trial import ERROR, TERMINATED, Trial


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    scheduler: Optional[TrialScheduler] = None
    max_concurrent_trials: int = 0
    search_seed: Optional[int] = None


class ResultGrid:
    """Reference: tune/result_grid.py — indexable results + best lookup."""

    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, i: int) -> Trial:
        return self._trials[i]

    @property
    def num_errors(self) -> int:
        return sum(1 for t in self._trials if t.status == ERROR)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials if t.status == TERMINATED)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Trial:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric is required (TuneConfig.metric or "
                             "get_best_result(metric=...))")
        scored = [t for t in self._trials if metric in t.last_result]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda t: t.last_result[metric])

    def get_dataframe(self):
        rows = [dict(t.last_result, trial_id=t.trial_id, status=t.status)
                for t in self._trials]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


class Tuner:
    def __init__(self, trainable: Any, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional["RunConfig"] = None,
                 _restore_path: Optional[str] = None):
        from ray_tpu_torch.air.config import RunConfig

        self._trainable = self._resolve_trainable(trainable)
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restore_path = _restore_path

    @staticmethod
    def _resolve_trainable(trainable: Any) -> Callable:
        if hasattr(trainable, "as_trainable"):  # a Trainer
            return trainable.as_trainable()
        if callable(trainable):
            return trainable
        raise ValueError(f"not a trainable: {trainable!r}")

    @classmethod
    def restore(cls, path: str, trainable: Any,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        Tuner.restore — finished trials keep their results; unfinished
        ones rerun, from their latest trial checkpoint if one exists)."""
        from ray_tpu_torch.air.config import RunConfig

        if not os.path.exists(os.path.join(path, "tuner_state.json")):
            raise FileNotFoundError(f"no tuner state under {path}")
        run_config = RunConfig(name=os.path.basename(path.rstrip("/")),
                               storage_path=os.path.dirname(
                                   path.rstrip("/")))
        return cls(trainable, tune_config=tune_config,
                   run_config=run_config, _restore_path=path)

    def fit(self) -> ResultGrid:
        cfg = self._tune_config
        if self._restore_path:
            exp_dir = self._restore_path
            trials = TuneController.load_state(exp_dir)
            if trials is None:
                raise FileNotFoundError(f"no tuner state under {exp_dir}")
        else:
            name = self._run_config.name or f"tune_{int(time.time())}"
            exp_dir = os.path.join(
                self._run_config.resolved_storage_path(), name)
            variants = BasicVariantGenerator(
                self._param_space, num_samples=cfg.num_samples,
                seed=cfg.search_seed).variants()
            trials = [Trial(config=v) for v in variants]
        scheduler = cfg.scheduler
        if scheduler is not None and getattr(scheduler, "metric",
                                             None) is None:
            scheduler.metric = cfg.metric
            scheduler.mode = cfg.mode
        controller = TuneController(
            self._trainable, trials, exp_dir=exp_dir, scheduler=scheduler,
            max_concurrent=cfg.max_concurrent_trials)
        controller.run()
        return ResultGrid(trials, cfg.metric, cfg.mode)
