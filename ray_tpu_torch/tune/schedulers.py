"""Trial schedulers: FIFO, Async Successive Halving (ASHA) and Population
Based Training (PBT), the port of `ray_tpu/tune/schedulers.py`.

Reference equivalent: `python/ray/tune/schedulers/trial_scheduler.py` +
`async_hyperband.py` (AsyncHyperBandScheduler / ASHAScheduler): rungs at
grace_period * reduction_factor^k; at each rung a trial continues only if
its metric is in the top 1/reduction_factor of results recorded there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    # The scheduler mutated trial.config / trial.checkpoint_dir in place;
    # the controller must stop the trial's actor and relaunch it from that
    # state (PBT's exploit step).
    RESTART = "RESTART"

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]
                          ) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference: trial_scheduler.py)."""


class PBTScheduler(TrialScheduler):
    """Population Based Training (reference:
    `python/ray/tune/schedulers/pbt.py` PopulationBasedTraining).

    Every `perturbation_interval` iterations each trial's score is ranked
    against the population's latest scores. A bottom-quantile trial
    *exploits* — it adopts a random top-quantile trial's config and latest
    checkpoint — then *explores*: each hyperparameter in
    `hyperparam_mutations` is either resampled (prob
    `resample_probability`) or perturbed (x1.2 / x0.8 for numeric,
    neighbor-shift for categorical lists). The controller applies the
    mutation by restarting the trial from the donor checkpoint.
    """

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        import random

        assert mode in ("max", "min")
        assert 0.0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.perturbation_interval = perturbation_interval
        self.hyperparam_mutations = dict(hyperparam_mutations or {})
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self.rng = random.Random(seed)
        self._latest: Dict[str, float] = {}       # trial_id -> norm score
        self._last_perturb: Dict[str, int] = {}   # trial_id -> time
        self._trials: Dict[str, Any] = {}         # trial_id -> Trial

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]
                          ) -> None:
        self._latest.pop(trial.trial_id, None)
        self._trials.pop(trial.trial_id, None)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        if self.metric not in result:
            return self.CONTINUE
        tid = trial.trial_id
        t = int(result.get(self.time_attr, 0))
        self._latest[tid] = self._norm(float(result[self.metric]))
        self._trials[tid] = trial
        if t - self._last_perturb.get(tid, 0) < self.perturbation_interval:
            return self.CONTINUE
        self._last_perturb[tid] = t

        # Quantiles over LIVE trials only (reference pbt.py filters to
        # live trials): a crashed trial must not hog a bottom slot or
        # donate the config that crashed it.
        from ray_tpu_torch.tune.trial import ERROR, TERMINATED

        ranked = sorted(
            (t_id for t_id in self._latest
             if self._trials[t_id].status not in (TERMINATED, ERROR)),
            key=self._latest.get)
        n = len(ranked)
        k = max(1, int(n * self.quantile_fraction))
        if n < 2 or 2 * k > n:
            return self.CONTINUE
        bottom, top = ranked[:k], ranked[-k:]
        if tid not in bottom:
            return self.CONTINUE

        donor = self._trials.get(self.rng.choice(top))
        if donor is None or donor.trial_id == tid:
            return self.CONTINUE
        # Exploit: adopt the donor's config + latest checkpoint ...
        if getattr(donor, "checkpoint_dir", None):
            trial.checkpoint_dir = donor.checkpoint_dir
        trial.config = self._explore(dict(donor.config))
        return self.RESTART

    # -- explore --------------------------------------------------------
    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        for key, spec in self.hyperparam_mutations.items():
            resample = self.rng.random() < self.resample_probability
            current = config.get(key)
            if isinstance(spec, Domain):
                if resample or current is None:
                    config[key] = spec.sample(self.rng)
                elif isinstance(current, (int, float)):
                    config[key] = self._perturb_numeric(current)
            elif callable(spec):
                if resample or current is None:
                    config[key] = spec()
                elif isinstance(current, (int, float)):
                    config[key] = self._perturb_numeric(current)
            elif isinstance(spec, (list, tuple)):
                choices = list(spec)
                if resample or current not in choices:
                    config[key] = self.rng.choice(choices)
                else:
                    # Neighbor shift keeps ordered lists (lr ladders)
                    # moving in small steps (reference pbt.py behavior).
                    i = choices.index(current)
                    j = i + self.rng.choice((-1, 1))
                    config[key] = choices[max(0, min(len(choices) - 1, j))]
        return config

    def _perturb_numeric(self, value):
        factor = 1.2 if self.rng.random() < 0.5 else 0.8
        out = value * factor
        return int(round(out)) if isinstance(value, int) else out


class ASHAScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> recorded metric values (sign-normalized: higher
        # is always better internally)
        self.rungs: Dict[int, List[float]] = {}
        milestone = grace_period
        while milestone < max_t:
            self.rungs[milestone] = []
            milestone *= reduction_factor
        self._trial_rungs: Dict[str, set] = {}

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        metric = self.metric
        if metric is None or metric not in result:
            return self.CONTINUE
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return self.STOP
        value = self._norm(float(result[metric]))
        seen = self._trial_rungs.setdefault(trial.trial_id, set())
        decision = self.CONTINUE
        for milestone in sorted(self.rungs):
            if t < milestone or milestone in seen:
                continue
            seen.add(milestone)
            recorded = self.rungs[milestone]
            recorded.append(value)
            if len(recorded) >= self.rf:
                # Top 1/rf cutoff among everything recorded at this rung.
                cutoff = sorted(recorded, reverse=True)[
                    max(len(recorded) // self.rf - 1, 0)]
                if value < cutoff:
                    decision = self.STOP
        return decision
