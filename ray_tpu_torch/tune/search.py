"""Search spaces + the basic variant generator, the port of
`ray_tpu/tune/search.py`.

Reference equivalent: `python/ray/tune/search/sample.py` (Domain/Categorical/
Float/Integer) + `search/basic_variant.py` (grid expansion x num_samples).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional, Sequence


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng: random.Random) -> float:
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float):
        import math

        self.log_lower, self.log_upper = math.log(lower), math.log(upper)

    def sample(self, rng: random.Random) -> float:
        import math

        return math.exp(rng.uniform(self.log_lower, self.log_upper))


class RandInt(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.lower, self.upper)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    """Marker consumed by the variant generator (reference:
    tune/search/variant_generator.py grid_search)."""
    return {"grid_search": list(values)}


class BasicVariantGenerator:
    """Expands grid_search axes into a cartesian product, repeats it
    `num_samples` times, and samples every Domain per variant."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = dict(param_space or {})
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, dict) and "grid_search" in v]
        grid_values = [self.param_space[k]["grid_search"]
                       for k in grid_keys]
        out: List[Dict[str, Any]] = []
        for _ in range(self.num_samples):
            for combo in itertools.product(*grid_values) if grid_keys \
                    else [()]:
                cfg = {}
                for k, v in self.param_space.items():
                    if k in grid_keys:
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out
