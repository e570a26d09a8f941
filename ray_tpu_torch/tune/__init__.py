"""ray_tpu_torch.tune — hyperparameter tuning on the actor runtime, the
port of `ray_tpu/tune/`.

Reference equivalent: `python/ray/tune/` (Tuner/TuneController/searchers/
schedulers). `session.report` inside a trainable reaches the controller
through the same session machinery Train uses.
"""

from ray_tpu_torch.air import session as _session
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     PBTScheduler)
from ray_tpu_torch.tune.search import (choice, grid_search, loguniform, randint,
                                 uniform)
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

# Free-function surface (reference: ray.tune.report / get_checkpoint).
report = _session.report
get_checkpoint = _session.get_checkpoint

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "Trial",
    "ASHAScheduler", "FIFOScheduler", "PBTScheduler",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "report", "get_checkpoint",
]
