"""Actor-pool map stage: stateful batch transforms on long-lived actors, the
port of `ray_tpu/data/actor_compute.py`.

Reference equivalent:
`python/ray/data/_internal/execution/operators/actor_pool_map_operator.py` —
`map_batches(fn, compute="actors")` where `fn` is a callable CLASS whose
instances hold expensive state (a model on the card, a tokenizer) that must
be built once per worker, not once per block. The canonical use is batch
inference: N replicas each build a model once, blocks stream through the
pool.

Design:
- upstream blocks are baked to object refs by plain tasks (driver holds
  only refs);
- a pool of `concurrency` actors (or an autoscaling (min, max) range)
  consumes them with a bounded in-flight window, results stream back in
  submission order — wave scheduling, no barrier;
- the pool autoscales up while a backlog exists and idles down at stage
  end (actors are killed; reference: ActorPool scale_up/scale_down).

`num_gpus` takes the reference's `num_tpus`: each replica leases that much
of a card (fractions share one, as the runtime's GPU leases do), and sees
it as `cuda:0` of its CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple, Union

logger = logging.getLogger(__name__)


class _MapWorker:
    """Actor wrapping the user's callable (class instance or function)."""

    def __init__(self, fn_or_cls, ctor_args, ctor_kwargs,
                 worker_index: int = 0):
        import inspect

        if inspect.isclass(fn_or_cls):
            self._fn = fn_or_cls(*ctor_args, **(ctor_kwargs or {}))
        else:
            self._fn = fn_or_cls
        self._worker_index = worker_index

    def apply(self, block):
        return self._fn(block)

    def apply_timed(self, block):
        """Like `apply`, but ships the replica's wall time back with the
        block (the `_run_chain_timed` pattern) so `Dataset.stats()` can
        report per-replica operator timing for actor-pool stages."""
        import time

        from ray_tpu_torch.data.stats import block_rows_bytes

        t0 = time.perf_counter()
        out = self._fn(block)
        dt = time.perf_counter() - t0
        rows, nbytes = block_rows_bytes(out)
        return {"block": out, "replica": self._worker_index,
                "ops": [("apply", dt, rows, nbytes)]}


def _bake_block(task, transforms):
    block = task()
    for t in transforms:
        block = t(block)
    return block


class ActorPoolStage:
    """Descriptor + executor for one compute="actors" stage."""

    def __init__(self, fn: Callable, *,
                 concurrency: Union[int, Tuple[int, int]] = 1,
                 fn_constructor_args: tuple = (),
                 fn_constructor_kwargs: Optional[dict] = None,
                 num_cpus: float = 1.0,
                 num_gpus: float = 0.0,
                 max_tasks_in_flight_per_actor: int = 2):
        if isinstance(concurrency, int):
            self.min_actors = self.max_actors = max(1, concurrency)
        else:
            self.min_actors, self.max_actors = concurrency
            if self.min_actors < 1 or self.max_actors < self.min_actors:
                raise ValueError(
                    f"bad concurrency range {concurrency!r}")
        self.fn = fn
        self.ctor_args = fn_constructor_args
        self.ctor_kwargs = fn_constructor_kwargs
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.window = max_tasks_in_flight_per_actor

    def run(self, read_tasks, transforms, block_refs, stats=None):
        """Stream mapped blocks in input order. Generator: lazy, bounded
        in-flight, actors torn down on close/exhaustion. With `stats`,
        replicas ship their apply wall time back next to each block and
        per-replica operator entries land in the report
        (`actor_pool_map[replica=N]`)."""
        import ray_tpu_torch
        from ray_tpu_torch.util.actor_pool import ActorPool

        if block_refs is not None:
            refs = list(block_refs)
        else:
            bake = ray_tpu_torch.remote(num_cpus=1)(_bake_block)
            refs = [bake.remote(t, list(transforms)) for t in read_tasks]

        resources = {"num_cpus": self.num_cpus}
        if self.num_gpus:
            resources["num_gpus"] = self.num_gpus
        worker_cls = ray_tpu_torch.remote(**resources)(_MapWorker)
        timed = stats is not None

        def spawn(index):
            return worker_cls.remote(self.fn, self.ctor_args,
                                     self.ctor_kwargs, index)

        actors = [spawn(i) for i in range(self.min_actors)]
        pool = ActorPool(actors)

        def submit_one(a, ref):
            return (a.apply_timed.remote(ref) if timed
                    else a.apply.remote(ref))

        try:
            submitted = 0
            yielded = 0
            n = len(refs)
            while yielded < n:
                # Keep every actor's pipeline fed; grow the pool while a
                # backlog remains and we're under the cap.
                target_inflight = len(actors) * self.window
                backlog = n - submitted
                if (backlog > target_inflight
                        and len(actors) < self.max_actors):
                    fresh = spawn(len(actors))
                    actors.append(fresh)
                    pool.push(fresh)
                while (submitted < n
                       and submitted - yielded < target_inflight):
                    pool.submit(submit_one, refs[submitted])
                    submitted += 1
                out = pool.get_next(timeout=600)
                if timed and isinstance(out, dict) and "block" in out:
                    replica = out.get("replica", 0)
                    for name, dt, rows, nbytes in out.get("ops", ()):
                        # Index 510+replica: distinct OpStats slot per
                        # replica, after the coarse 500 stage entry.
                        stats.record_op(
                            510 + replica,
                            f"actor_pool_map[replica={replica}]",
                            dt, rows, nbytes)
                    out = out["block"]
                yield out
                yielded += 1
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
