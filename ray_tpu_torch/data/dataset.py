"""Dataset: lazy, streaming, shardable — the port of
`ray_tpu/data/dataset.py`.

Reference equivalent: `python/ray/data/dataset.py` (user surface) +
`_internal/plan.py` (lazy plan). A Dataset is a list of read tasks plus a
chain of block transforms; nothing executes until iteration. Sharding for
SPMD ingest (`split_for_workers`) partitions the read tasks round-robin, so
every training worker owns a disjoint file/block subset — the reference's
`DataConfig.get_dataset_shards` per-host sharding.

The port has no cloudpickle: every read task is an object of a module-level
class here (`_BlockRead`, `_RangeRead`, ...), so a Dataset pickles by value
into a task, an actor or a train worker, and a user's function travels by
reference. On a cluster, `map_batches`, `map`, `filter`, `flat_map` and
`map_groups` therefore take functions and classes defined at a module's top
level (a lambda raises a `TypeError` that says so); without a runtime any
callable works.

`iter_torch_batches` takes `iter_jax_batches`' place: batches as tensors on
the card, or DTensors sharded over a `DeviceMesh`.

pandas and pyarrow are optional: `read_parquet`, `read_csv`, `from_pandas`,
`to_pandas` and `write_*` raise an `ImportError` naming the package where it
is missing; `read_json` and every other operation need neither (a join is a
hash merge in numpy, `shuffle.merge_blocks`).
"""

from __future__ import annotations

import builtins
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, block_from_rows,
                                      block_num_rows, block_slice,
                                      block_to_rows, concat_blocks, rebatch)
from ray_tpu_torch.data.executor import StreamingExecutor


def _require(package: str, what: str):
    """Import `package` for `what`, or raise an ImportError that names
    it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"{what} needs {package}, which is not installed here; "
            f"read_json, from_numpy, from_items and from_blocks need "
            f"neither pandas nor pyarrow") from e


# -- read tasks and row transforms: module-level classes, so a Dataset
# pickles by value (the port sends functions by reference) ---------------
class _BlockRead:
    """A read task that returns one block it holds."""

    __name__ = "read"

    def __init__(self, block: Block):
        self.block = block

    def __call__(self) -> Block:
        return self.block


class _RangeRead:
    __name__ = "read"

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def __call__(self) -> Block:
        return {"id": np.arange(self.lo, self.hi, dtype=np.int64)}


class _ChainRead:
    """A read task followed by its dataset's transforms (union)."""

    __name__ = "read"

    def __init__(self, task, transforms):
        self.task, self.transforms = task, list(transforms)

    def __call__(self) -> Block:
        block = self.task()
        for t in self.transforms:
            block = t(block)
        return block


class _RowTransform:
    """map / filter / flat_map of a row function over a block."""

    def __init__(self, kind: str, fn: Callable):
        self.kind, self.fn = kind, fn
        self.__name__ = f"{kind}({getattr(fn, '__name__', 'fn')})"

    def __call__(self, block: Block) -> Block:
        rows = block_to_rows(block)
        if self.kind == "map":
            return block_from_rows([self.fn(r) for r in rows])
        if self.kind == "filter":
            return block_from_rows([r for r in rows if self.fn(r)])
        out: List[Dict[str, Any]] = []
        for r in rows:
            out.extend(self.fn(r))
        return block_from_rows(out)


class _FileRead:
    """One file of a parquet, csv or json datasource."""

    __name__ = "read"

    def __init__(self, kind: str, path: str, options: Dict[str, Any]):
        self.kind, self.path, self.options = kind, path, options

    def __call__(self) -> Block:
        if self.kind == "json":
            return _read_json_rows(self.path, **self.options)
        if self.kind == "parquet":
            pq = _require("pyarrow.parquet", "read_parquet")
            table = pq.read_table(self.path, **self.options)
        else:
            pacsv = _require("pyarrow.csv", "read_csv")
            table = pacsv.read_csv(self.path, **self.options)
        return {c: table[c].to_numpy(zero_copy_only=False)
                for c in table.column_names}


class Dataset:
    def __init__(self, read_tasks: List[Callable[[], Block]],
                 transforms: Optional[List[Callable[[Block], Block]]] = None,
                 block_refs: Optional[List[Any]] = None):
        self._read_tasks = read_tasks
        self._transforms = list(transforms or [])
        # Blocks that ALREADY exist as objects (shuffle/sort/groupby
        # outputs): consumed by direct driver-side gets — no consumer
        # task, no nested get (reference: Dataset blocks are ObjectRefs).
        self._block_refs = block_refs

    _limit: Optional[int] = None
    _actor_stage: Optional[Any] = None        # compute="actors" stage
    _post_transforms: List[Callable] = []     # applied after the stage
    _zip_with: Optional["Dataset"] = None     # row-aligned zip partner
    _zip_left: Optional["Dataset"] = None     # left side of the zip
    _zip_post: List[Callable] = []            # transforms on zipped rows
    _pre_ops: List[tuple] = []                # already-executed op stats
    _last_stats: Optional[Any] = None         # DatasetStats of last run

    def __getstate__(self) -> dict:
        # The last run's stats hold a lock and stay with this process: a
        # copy sent to a task, an actor or a train worker starts without.
        state = dict(self.__dict__)
        state.pop("_last_stats", None)
        return state

    def _clone(self) -> "Dataset":
        ds = Dataset(self._read_tasks, self._transforms, self._block_refs)
        ds._actor_stage = self._actor_stage
        ds._post_transforms = list(self._post_transforms)
        ds._zip_with = self._zip_with
        ds._zip_left = self._zip_left
        ds._zip_post = list(self._zip_post)
        ds._pre_ops = list(self._pre_ops)
        return ds

    @property
    def _plan_outside_read_tasks(self) -> bool:
        """True when part of this dataset's plan does NOT live in
        (_read_tasks, _transforms): a zip partner or an actor-pool
        stage. Ops that re-read those fields directly must flatten
        first or they silently drop that part of the plan."""
        return self._zip_with is not None or self._actor_stage is not None

    def _flatten_zip(self) -> "Dataset":
        """For ops whose distributed paths re-read `_read_tasks` directly
        (shuffle/sort/groupby/join/union/split/window): a zipped dataset
        or one with an actor-pool stage must first materialize its
        output blocks, or the partner/stage would silently vanish
        (ADVICE r5: zip losing its partner; same class for stages). The
        blocks stream through the driver; on a cluster they go straight
        into the object store so the driver holds one block + refs, not
        every row."""
        if not self._plan_outside_read_tasks:
            return self
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            from ray_tpu_torch.data.shuffle import block_ref_reader

            refs = [ray_tpu_torch.put(b) for b in self.iter_blocks()]
            return Dataset([block_ref_reader(r) for r in refs],
                           block_refs=refs)
        blocks = list(self.iter_blocks())
        return Dataset([_BlockRead(b) for b in blocks])

    def _check_not_limited(self, op: str) -> None:
        if self._limit is not None:
            raise NotImplementedError(
                f".{op}() after .limit() is not supported — apply "
                "transforms first, then limit (limit is a terminal "
                "streaming cut; silently ignoring it would be worse)")

    # -- transforms (lazy) ----------------------------------------------
    def map_batches(self, fn: Callable[[Block], Block],
                    compute: Optional[str] = None,
                    **opts: Any) -> "Dataset":
        """Block -> block transform. compute="actors" runs `fn` on a pool
        of long-lived actors — pass a callable CLASS to build expensive
        state (a jitted model) once per replica instead of once per block
        (reference: actor_pool_map_operator.py; opts: concurrency,
        fn_constructor_args/kwargs, num_cpus, num_gpus (the reference's
        num_tpus: a fraction shares a card), max_tasks_in_flight_per_actor).
        """
        self._check_not_limited("map_batches")
        if self._zip_with is not None:
            if compute == "actors":
                raise NotImplementedError(
                    "compute=\"actors\" after zip() is not supported — "
                    "materialize() the zipped dataset first")
            # Post-zip transforms apply to the MERGED stream: dropping
            # them onto the left chain would silently lose the partner's
            # columns (ADVICE r5 medium).
            ds = self._clone()
            ds._zip_post = self._zip_post + [fn]
            return ds
        if compute == "actors":
            if self._actor_stage is not None:
                # Silently dropping the first stage would produce wrong
                # data; chaining streamed actor stages isn't built yet.
                raise NotImplementedError(
                    "chaining two compute=\"actors\" stages is not "
                    "supported — materialize() between them, or fold the "
                    "logic into one callable class")
            from ray_tpu_torch.data.actor_compute import ActorPoolStage

            ds = Dataset(self._read_tasks, self._transforms,
                         self._block_refs)
            ds._actor_stage = ActorPoolStage(fn, **opts)
            ds._pre_ops = list(self._pre_ops)
            return ds
        if self._actor_stage is not None:
            # Post-stage transforms apply to the stage's streamed output.
            ds = Dataset(self._read_tasks, self._transforms,
                         self._block_refs)
            ds._actor_stage = self._actor_stage
            ds._post_transforms = self._post_transforms + [fn]
            ds._pre_ops = list(self._pre_ops)
            return ds
        ds = Dataset(self._read_tasks, self._transforms + [fn],
                     self._block_refs)
        # An eagerly-executed exchange op (shuffle/sort/join) stays in
        # the derived dataset's stats report.
        ds._pre_ops = list(self._pre_ops)
        return ds

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]
            ) -> "Dataset":
        return self.map_batches(_RowTransform("map", fn))

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        return self.map_batches(_RowTransform("filter", fn))

    def flat_map(self, fn: Callable[[Dict[str, Any]],
                                    List[Dict[str, Any]]]) -> "Dataset":
        """Row -> many rows (reference: dataset.py flat_map)."""
        return self.map_batches(_RowTransform("flat_map", fn))

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (transforms must already be baked: each
        input keeps its own chain by wrapping reads)."""
        self._check_not_limited("union")
        for other in others:
            other._check_not_limited("union")
        if self._plan_outside_read_tasks or any(
                o._plan_outside_read_tasks for o in others):
            return self._flatten_zip().union(
                *(o._flatten_zip() for o in others))

        def bake(ds: "Dataset") -> List[Callable[[], Block]]:
            return [_ChainRead(t, ds._transforms) for t in ds._read_tasks]

        tasks = bake(self)
        for other in others:
            tasks += bake(other)
        return Dataset(tasks)

    def limit(self, n: int) -> "Dataset":
        """First n rows — a terminal streaming cut honored by every
        consumer (iter_blocks stops pulling once satisfied; reference:
        LimitOperator). Transforms must be applied before limit."""
        ds = self._clone()  # keeps actor stage / zip partner / refs
        ds._limit = n if self._limit is None else min(n, self._limit)
        return ds

    def repartition(self, num_blocks: int) -> "Dataset":
        """Materialize + re-split into equal blocks (reference:
        repartition; an all-to-all op, so it executes eagerly)."""
        self._check_not_limited("repartition")
        block = self.materialize()
        total = block_num_rows(block)
        # More blocks than rows yields empty blocks (reference behavior)
        # — callers like split_for_workers(n) rely on getting exactly the
        # block count they asked for.
        num_blocks = max(1, num_blocks)
        bounds = np.linspace(0, total, num_blocks + 1).astype(int)
        return Dataset([_BlockRead(block_slice(block, bounds[i],
                                               bounds[i + 1]))
                        for i in builtins.range(num_blocks)])

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Global shuffle: a distributed two-stage task exchange when a
        cluster is up (reference: _internal/push_based_shuffle.py — the
        driver holds only refs, never rows); in-process otherwise."""
        self._check_not_limited("random_shuffle")
        if self._plan_outside_read_tasks:
            return self._flatten_zip().random_shuffle(seed=seed)
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            from ray_tpu_torch.data.shuffle import (
                block_ref_reader, distributed_random_shuffle)

            t0 = time.perf_counter()
            refs = distributed_random_shuffle(
                self._read_tasks, self._transforms, seed,
                max(1, len(self._read_tasks)))
            ds = Dataset([block_ref_reader(r) for r in refs],
                         block_refs=refs)
            ds._pre_ops = [("random_shuffle",
                            time.perf_counter() - t0, len(refs))]
            return ds
        block = self.materialize()
        total = block_num_rows(block)
        rng = np.random.default_rng(seed)
        order = rng.permutation(total)
        shuffled = {c: np.asarray(v)[order] for c, v in block.items()}
        n_blocks = max(1, len(self._read_tasks))
        bounds = np.linspace(0, total, n_blocks + 1).astype(int)
        return Dataset([_BlockRead(block_slice(shuffled, bounds[i],
                                               bounds[i + 1]))
                        for i in builtins.range(n_blocks)])

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Global sort by column: sample -> range-partition -> per-part
        sort when a cluster is up (parts concatenate in key order);
        in-process otherwise."""
        self._check_not_limited("sort")
        if self._plan_outside_read_tasks:
            return self._flatten_zip().sort(key, descending)
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            from ray_tpu_torch.data.shuffle import (block_ref_reader,
                                                    distributed_sort)

            t0 = time.perf_counter()
            refs = distributed_sort(
                self._read_tasks, self._transforms, key, descending,
                max(1, len(self._read_tasks)))
            ds = Dataset([block_ref_reader(r) for r in refs],
                         block_refs=refs)
            ds._pre_ops = [("sort", time.perf_counter() - t0, len(refs))]
            return ds
        block = self.materialize()
        order = np.argsort(np.asarray(block[key]), kind="stable")
        if descending:
            order = order[::-1]
        out = {c: np.asarray(v)[order] for c, v in block.items()}
        return Dataset([_BlockRead(out)])

    def groupby(self, key: str) -> "GroupedData":
        # Stays lazy: the flatten a zipped/staged dataset needs for the
        # distributed agg path happens at aggregation time (_agg), not
        # at plan-build time.
        return GroupedData(self, key)

    def window(self, *, blocks_per_window: int = 8):
        """Convert to a DatasetPipeline of `blocks_per_window`-block
        windows executing one window at a time (reference:
        Dataset.window) — bounds working-set memory for datasets larger
        than the object store. A zipped or actor-stage dataset
        materializes its output blocks here (windowing needs the block
        list up front)."""
        self._check_not_limited("window")
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(self._flatten_zip(),
                                            blocks_per_window)

    def repeat(self, times: Optional[int] = None):
        """Multi-epoch pipeline over this dataset (reference:
        Dataset.repeat)."""
        self._check_not_limited("repeat")
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        ds = self._flatten_zip()
        return DatasetPipeline.from_dataset(
            ds, blocks_per_window=max(1, len(ds._read_tasks))
        ).repeat(times)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two row-aligned datasets (reference:
        Dataset.zip): row i of the result has the columns of both inputs'
        row i (name clashes get an `_1` suffix). Streaming: both sides
        iterate with row-aligned rebatching; neither fully materializes.
        Raises at iteration if the row counts differ. Transforms applied
        AFTER zip (map/map_batches/filter) run on the merged stream, and
        zips chain: a.zip(b).zip(c) merges all three."""
        self._check_not_limited("zip")
        other._check_not_limited("zip")
        ds = Dataset(self._read_tasks, self._transforms, self._block_refs)
        # The left stream is THIS dataset in full (including any zip or
        # post-zip transforms it already carries): iteration recurses
        # through `_zip_left.iter_blocks()`, so chained zips compose.
        ds._zip_left = self
        ds._zip_with = other
        return ds

    def _iter_zipped(self, max_in_flight: int,
                     stats: Optional[Any] = None,
                     record: bool = True) -> Iterator[Block]:
        gen = self._iter_zipped_inner(max_in_flight, stats, record)
        try:
            yield from gen
        finally:
            # Fold each side's per-operator report into the zipped
            # dataset's stats — without this, z.stats() would show only
            # the 'zip' op and lose every upstream read/map operator.
            # Left ops sit at 100+, right at 300+, zip/post at 1000+.
            if stats is not None:
                for src, base in ((self._zip_left, 100),
                                  (self._zip_with, 300)):
                    sub = getattr(src, "_last_stats", None)
                    if sub is None:
                        continue
                    for i, o in enumerate(sub.operators):
                        stats.fold_op(base + i, o)
                    stats.wait_s += sub.wait_s

    def _iter_zipped_inner(self, max_in_flight: int,
                           stats: Optional[Any] = None,
                           record: bool = True) -> Iterator[Block]:
        import time as _time

        # record=False (a schema() probe) propagates to both sides so
        # the probe can't clobber the partners' real-run stats either.
        left = self._zip_left.iter_blocks(max_in_flight,
                                          _record_stats=record)
        right = self._zip_with.iter_blocks(max_in_flight,
                                           _record_stats=record)
        lbuf: Optional[Block] = None
        rbuf: Optional[Block] = None
        while True:
            if lbuf is None or block_num_rows(lbuf) == 0:
                lbuf = next(left, None)
            if rbuf is None or block_num_rows(rbuf) == 0:
                rbuf = next(right, None)
            if lbuf is None or rbuf is None:
                break
            t0 = _time.perf_counter()
            n = min(block_num_rows(lbuf), block_num_rows(rbuf))
            lcut = block_slice(lbuf, 0, n)
            rcut = block_slice(rbuf, 0, n)
            out = dict(lcut)
            for c, v in rcut.items():
                out[c if c not in out else f"{c}_1"] = v
            if stats is not None:
                from ray_tpu_torch.data.stats import block_rows_bytes

                rows, nbytes = block_rows_bytes(out)
                stats.record_op(1_000, "zip", _time.perf_counter() - t0,
                                rows, nbytes)
            for i, t in enumerate(self._zip_post):
                t0 = _time.perf_counter()
                out = t(out)
                if stats is not None:
                    rows, nbytes = block_rows_bytes(out)
                    stats.record_op(
                        1_001 + i, getattr(t, "__name__", f"post_{i}"),
                        _time.perf_counter() - t0, rows, nbytes)
            yield out
            lbuf = block_slice(lbuf, n, block_num_rows(lbuf))
            rbuf = block_slice(rbuf, n, block_num_rows(rbuf))
        lrest = (block_num_rows(lbuf) if lbuf else 0) + sum(
            block_num_rows(b) for b in left)
        rrest = (block_num_rows(rbuf) if rbuf else 0) + sum(
            block_num_rows(b) for b in right)
        if lrest or rrest:
            raise ValueError(
                f"zip(): datasets have different row counts "
                f"(+{lrest} left / +{rrest} right after alignment)")

    def join(self, other: "Dataset", on: str, how: str = "inner",
             *, num_partitions: Optional[int] = None) -> "Dataset":
        """Hash join on a key column (reference: Dataset.join): both
        sides hash-partition on `on`, each partition pair merges — a
        distributed task exchange when a cluster is up (driver holds only
        refs), an in-process hash merge otherwise (`shuffle.merge_blocks`:
        a pandas merge's rows, without pandas)."""
        self._check_not_limited("join")
        other._check_not_limited("join")
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join how={how!r}")
        if self._plan_outside_read_tasks or other._plan_outside_read_tasks:
            return self._flatten_zip().join(
                other._flatten_zip(), on, how,
                num_partitions=num_partitions)
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            from ray_tpu_torch.data.shuffle import (block_ref_reader,
                                                    distributed_join)

            parts = num_partitions or max(1, len(self._read_tasks))
            t0 = time.perf_counter()
            refs = distributed_join(
                self._read_tasks, self._transforms,
                other._read_tasks, other._transforms, on, how, parts)
            ds = Dataset([block_ref_reader(r) for r in refs],
                         block_refs=refs)
            ds._pre_ops = [(f"join({how})",
                            time.perf_counter() - t0, len(refs))]
            return ds
        from ray_tpu_torch.data.shuffle import merge_blocks

        block = merge_blocks(self.materialize(), other.materialize(), on,
                             how)
        return Dataset([_BlockRead(block)])

    # -- execution ------------------------------------------------------
    def _executor(self, max_in_flight: int = 4,
                  stats: Optional[Any] = None) -> StreamingExecutor:
        return StreamingExecutor(self._read_tasks, self._transforms,
                                 max_in_flight=max_in_flight, stats=stats)

    def _new_stats(self, record: bool = True):
        """Fresh DatasetStats for one execution, seeded with any
        already-executed exchange ops (shuffle/sort/join run eagerly)."""
        from ray_tpu_torch.data.stats import DatasetStats, OpStats

        stats = DatasetStats()
        for i, (name, wall_s, blocks) in enumerate(self._pre_ops):
            op = OpStats(name)
            op.wall_s = wall_s
            op.blocks = blocks
            op.min_block_s = op.max_block_s = wall_s
            stats.fold_op(-len(self._pre_ops) + i, op)
        if record:
            self._last_stats = stats
        return stats

    def iter_blocks(self, max_in_flight: int = 4, *,
                    _record_stats: bool = True) -> Iterator[Block]:
        stats = self._new_stats(record=_record_stats)
        if self._zip_with is not None:
            blocks = self._iter_zipped(max_in_flight, stats,
                                       record=_record_stats)
        else:
            blocks = self._unzipped_blocks(max_in_flight, stats)
        if self._limit is not None:
            blocks = self._limited(blocks, self._limit)
        return self._finalizing(blocks, stats)

    @staticmethod
    def _finalizing(blocks: Iterator[Block], stats) -> Iterator[Block]:
        """Stamp end-to-end wall time when iteration ends — fully drained
        OR dropped early by the consumer (generator close)."""
        try:
            yield from blocks
        finally:
            stats.finalize()

    def _unzipped_blocks(self, max_in_flight: int = 4,
                         stats: Optional[Any] = None) -> Iterator[Block]:
        import ray_tpu_torch
        from ray_tpu_torch.data.stats import timed_block_iter

        if self._actor_stage is not None:
            if ray_tpu_torch.is_initialized():
                blocks = self._actor_stage.run(
                    self._read_tasks, self._transforms, self._block_refs,
                    stats=stats)
            else:
                # No cluster: run the stage's callable in-process (one
                # "replica"), keeping semantics identical for unit tests.
                from ray_tpu_torch.data.actor_compute import _MapWorker

                # stats=None: the coarse timed_block_iter below already
                # covers this stream — recording the chain ops here too
                # would double-count compute in the report.
                worker = _MapWorker(self._actor_stage.fn,
                                    self._actor_stage.ctor_args,
                                    self._actor_stage.ctor_kwargs)
                ex = self._executor(max_in_flight, None)
                blocks = (worker.apply(b) for b in ex.run_local())
            # Coarse per-block timing: the stage streams through a pool
            # of remote actors, so per-operator remote times aren't
            # available — one "actor_pool_map" entry covers the stage.
            blocks = timed_block_iter(blocks, stats, 500,
                                      "actor_pool_map")
            if self._post_transforms:
                post = list(self._post_transforms)

                def _applied(src):
                    import time as _time

                    for b in src:
                        for i, t in enumerate(post):
                            t0 = _time.perf_counter()
                            b = t(b)
                            if stats is not None:
                                from ray_tpu_torch.data.stats import (
                                    block_rows_bytes)

                                rows, nbytes = block_rows_bytes(b)
                                stats.record_op(
                                    501 + i,
                                    getattr(t, "__name__", f"post_{i}"),
                                    _time.perf_counter() - t0,
                                    rows, nbytes)
                        yield b

                blocks = _applied(blocks)
        elif (self._block_refs is not None and not self._transforms
                and ray_tpu_torch.is_initialized()):
            blocks = timed_block_iter(self._iter_block_refs(), stats, 0,
                                      "materialized_read")
        else:
            ex = self._executor(max_in_flight, stats)
            blocks = (iter(ex) if ray_tpu_torch.is_initialized()
                      else ex.run_local())
        return blocks

    def _iter_block_refs(self) -> Iterator[Block]:
        import threading

        import ray_tpu_torch
        from ray_tpu_torch.core.worker import current_runtime

        rt = current_runtime()
        release = getattr(rt, "_release_shm_mapping", None)
        refs = list(self._block_refs)
        if not refs:
            return

        # One-ahead prefetch on a DAEMON thread: fetch block i+1 while the
        # consumer works on block i. Daemon matters — a ThreadPoolExecutor
        # worker is joined by concurrent.futures' atexit hook, so an
        # abandoned in-flight get (consumer stopped iterating, cluster
        # gone) would stall interpreter exit for the full get timeout.
        def fetch(ref):
            slot: dict = {}
            ev = threading.Event()

            def run():
                try:
                    slot["v"] = ray_tpu_torch.get(ref, timeout=600)
                except BaseException as e:  # noqa: BLE001
                    slot["e"] = e
                finally:
                    ev.set()

            threading.Thread(target=run, daemon=True,
                             name="ds-prefetch").start()
            return ev, slot

        ev, slot = fetch(refs[0])
        for i, ref in enumerate(refs):
            ev.wait()
            if "e" in slot:
                raise slot["e"]
            block = slot["v"]
            if i + 1 < len(refs):
                ev, slot = fetch(refs[i + 1])
            yield block
            del block
            if release is not None:
                # Unmap the consumed block's segment now instead of
                # at dataset GC — a streaming consumer's RSS stays
                # at ~one block. Deferred automatically while the
                # consumer still holds zero-copy views; a
                # re-iteration simply re-maps.
                release(ref.hex())

    @staticmethod
    def _limited(blocks: Iterator[Block], limit: int) -> Iterator[Block]:
        """Row-exact streaming cut: stops pulling upstream once
        satisfied, so every consumer (batches, writes, pandas, schema)
        honors limit()."""
        remaining = limit
        for block in blocks:
            n = block_num_rows(block)
            if n >= remaining:
                yield block_slice(block, 0, remaining)
                return
            remaining -= n
            yield block

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     prefetch_blocks: int = 4,
                     drop_last: bool = False) -> Iterator[Block]:
        it = rebatch(self.iter_blocks(max_in_flight=prefetch_blocks),
                     batch_size)
        if not drop_last or batch_size is None:
            return it
        return (b for b in it if block_num_rows(b) == batch_size)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           prefetch_blocks: int = 4,
                           drop_last: bool = False,
                           dtypes: Optional[Dict[str, Any]] = None,
                           device: Any = None,
                           mesh: Any = None,
                           batch_axis: str = "dp"
                           ) -> Iterator[Dict[str, Any]]:
        """Batches as tensors on the card (reference:
        `python/ray/data/iterator.py` iter_torch_batches; the port of
        `iter_jax_batches`):

        - default: each column becomes a tensor on `device` (None: cuda:0,
          raising without a card; the tests pass "cpu"), copied from pinned
          host memory on a side stream and handed over only after its
          copy's event (`util/device_arrays.py`);
        - `mesh=` (a `DeviceMesh` of `parallel.make_mesh`): each rank's
          local rows become `DTensor.from_local(local, mesh, [Shard(0) on
          batch_axis, Replicate elsewhere])`, the counterpart of
          `jax.make_array_from_process_local_data`: the per-rank Dataset
          shard (split_for_workers) becomes one global batch without any
          rank holding all of it. The local tensor lives on the mesh's
          device (this rank's card, or the CPU for a gloo mesh).

        `dtypes` maps a column to a torch dtype (or a numpy one), applied
        on the host before the copy. With `drop_last=False` a short final
        batch is yielded unsharded (it may not divide the mesh); pass
        drop_last=True for shapes that must stay static.
        """
        from ray_tpu_torch.util.device_arrays import (batch_to_device,
                                                      shard_on_mesh)

        for block in self.iter_batches(batch_size=batch_size,
                                       prefetch_blocks=prefetch_blocks,
                                       drop_last=drop_last):
            arrays = {c: np.asarray(v) for c, v in block.items()}
            if mesh is None:
                yield batch_to_device(arrays, dtypes=dtypes, device=device)
            else:
                yield shard_on_mesh(arrays, mesh, batch_axis=batch_axis,
                                    dtypes=dtypes, batch_size=batch_size)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from block_to_rows(block)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def to_pandas(self):
        pd = _require("pandas", "to_pandas")
        return pd.DataFrame(self.materialize())

    def _write_parts(self, path: str, suffix: str, write) -> None:
        import os

        pd = _require("pandas", f"write_{suffix}")
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            write(pd.DataFrame(block),
                  os.path.join(path, f"part-{i:05d}.{suffix}"))

    def write_parquet(self, path: str) -> None:
        _require("pyarrow", "write_parquet")
        self._write_parts(path, "parquet",
                          lambda df, p: df.to_parquet(p))

    def write_csv(self, path: str) -> None:
        self._write_parts(path, "csv",
                          lambda df, p: df.to_csv(p, index=False))

    def materialize(self) -> Block:
        return concat_blocks(list(self.iter_blocks()))

    def stats(self):
        """Execution statistics of this dataset's most recent run
        (reference: `Dataset.stats()`): per-operator wall time, rows,
        bytes, throughput, block counts, and the consumer-wait vs
        operator-compute split. If the dataset has never executed, one
        full pass runs first so the report is populated. The returned
        DatasetStats prints as the familiar per-operator report."""
        if self._last_stats is None:
            for _ in self.iter_blocks():
                pass
        return self._last_stats

    def schema(self) -> Optional[Dict[str, str]]:
        # _record_stats=False: this one-block probe must not overwrite
        # the stats of a real execution the user just ran.
        for block in self.iter_blocks(max_in_flight=1,
                                      _record_stats=False):
            if block:
                return {c: str(v.dtype) for c, v in block.items()}
        return None

    @property
    def num_blocks(self) -> int:
        return len(self._read_tasks)

    # -- sharding (reference: DataConfig per-worker shards) --------------
    def split(self, n: int) -> List["Dataset"]:
        self._check_not_limited("split")
        if self._plan_outside_read_tasks:
            ds = self._flatten_zip()
            return [Dataset(ds._read_tasks[i::n], ds._transforms)
                    for i in builtins.range(n)]
        # builtins.range: the module-level `range` is the Dataset factory.
        return [Dataset(self._read_tasks[i::n], self._transforms)
                for i in builtins.range(n)]

    def split_for_workers(self, n: int) -> List["Dataset"]:
        # Flatten first so the block-count precondition is checked
        # against the ACTUAL output blocks, not the left side of a zip
        # or the input of an actor stage.
        ds = self._flatten_zip()
        if len(ds._read_tasks) < n:
            raise ValueError(
                f"cannot shard {len(ds._read_tasks)} block(s) across "
                f"{n} workers; increase parallelism/file count")
        return ds.split(n)

    def __repr__(self) -> str:
        return (f"Dataset(num_blocks={self.num_blocks}, "
                f"num_transforms={len(self._transforms)})")


class GroupedData:
    """Reference: grouped_data.py — hash-grouped aggregations. On a
    cluster, aggregation is a distributed hash exchange (a group never
    spans reducers); the driver handles only refs and, for the small
    named aggregates, the final per-group rows for global key order."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, kind: str, on: Optional[str] = None,
             fn: Optional[Callable] = None) -> Dataset:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            from ray_tpu_torch.data.shuffle import (block_ref_reader,
                                                    distributed_group_agg)

            # The exchange re-reads (_read_tasks, _transforms): a zipped
            # or actor-stage dataset must flatten first or that part of
            # the plan silently vanishes. (The local path below iterates
            # rows, which already includes it.)
            src = self._ds._flatten_zip()
            refs = distributed_group_agg(
                src._read_tasks, src._transforms, self._key,
                kind, on, fn, max(1, len(src._read_tasks)))
            out = Dataset([block_ref_reader(r) for r in refs],
                          block_refs=refs)
            if kind == "map_groups":
                # Output may be data-sized: keep it distributed,
                # partition order (not key order, like the reference).
                return out
            # Named aggregates are O(groups), not O(rows): collect and
            # restore the global key order the local path produces.
            rows = []
            for b in out.iter_blocks():
                rows.extend(block_to_rows(b))
            try:
                rows.sort(key=lambda r: r[self._key])
            except TypeError:
                pass  # unorderable keys keep partition order
            return Dataset([_BlockRead(block_from_rows(rows))])
        # In-process fallback (no cluster).
        groups: Dict[Any, List[Dict[str, Any]]] = {}
        for row in self._ds.iter_rows():
            groups.setdefault(row[self._key], []).append(row)
        try:
            ordered = sorted(groups.items())
        except TypeError:
            ordered = list(groups.items())
        from ray_tpu_torch.data.shuffle import GroupAggFinalize

        rows: List[Dict[str, Any]] = []
        agg = GroupAggFinalize(self._key, kind, on, fn)
        for k, grp in ordered:
            rows.extend(block_to_rows(agg(block_from_rows(grp), 0)))
        return Dataset([_BlockRead(block_from_rows(rows))])

    def count(self) -> Dataset:
        return self._agg("count")

    def sum(self, on: str) -> Dataset:
        return self._agg("sum", on)

    def mean(self, on: str) -> Dataset:
        return self._agg("mean", on)

    def map_groups(self, fn: Callable[[List[Dict[str, Any]]],
                                      List[Dict[str, Any]]]) -> Dataset:
        return self._agg("map_groups", fn=fn)


# ---------------------------------------------------------------------
# datasources (reference: python/ray/data/read_api.py + datasource/)
# ---------------------------------------------------------------------
def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)
    return Dataset([_RangeRead(int(bounds[i]), int(bounds[i + 1]))
                    for i in builtins.range(parallelism)])


def from_items(items: List[Any], *, parallelism: int = 4) -> Dataset:
    items = list(items)
    parallelism = max(1, min(parallelism, len(items) or 1))
    chunks = np.array_split(np.arange(len(items)), parallelism)

    def make_task(idx: np.ndarray) -> Callable[[], Block]:
        rows = [items[i] for i in idx]
        if rows and isinstance(rows[0], dict):
            return _BlockRead(block_from_rows(rows))
        return _BlockRead({"item": np.asarray(rows)})

    return Dataset([make_task(c) for c in chunks if len(c)])


def from_blocks(blocks: List[Block]) -> Dataset:
    """One read task per pre-built block (reference:
    from_blocks/MaterializedDataset)."""
    return Dataset([_BlockRead(b) for b in blocks])


def from_numpy(arrays: Dict[str, np.ndarray], *,
               parallelism: int = 4) -> Dataset:
    n = len(next(iter(arrays.values())))
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)
    return Dataset([_BlockRead({c: v[int(bounds[i]):int(bounds[i + 1])]
                                for c, v in arrays.items()})
                    for i in builtins.range(parallelism)])


def _expand_paths(paths) -> List[str]:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    """One read task per file (reference: datasource/parquet_datasource).
    Needs pyarrow."""
    _require("pyarrow.parquet", "read_parquet")
    return Dataset([_FileRead("parquet", f, {"columns": columns})
                    for f in _expand_paths(paths)])


def read_csv(paths, **read_kwargs: Any) -> Dataset:
    """One read task per file. Needs pyarrow."""
    _require("pyarrow.csv", "read_csv")
    return Dataset([_FileRead("csv", f, dict(read_kwargs))
                    for f in _expand_paths(paths)])


def _read_json_rows(path: str, lines: bool = True) -> Block:
    import json

    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        if lines:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        else:
            rows = json.load(f)
            if not isinstance(rows, list):
                raise ValueError(
                    f"{path}: expected a JSON array of row "
                    f"objects, got {type(rows).__name__}; for "
                    "one-object-per-line files use lines=True")
    return block_from_rows(rows)


def read_json(paths, *, lines: bool = True) -> Dataset:
    """JSONL (default) or JSON-array files (reference: read_json); the
    standard library only."""
    return Dataset([_FileRead("json", f, {"lines": lines})
                    for f in _expand_paths(paths)])


def from_pandas(df, *, parallelism: int = 4) -> Dataset:
    """DataFrame -> Dataset (reference: from_pandas). Needs pandas."""
    _require("pandas", "from_pandas")
    n = len(df)
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1).astype(int)

    def make_task(lo: int, hi: int) -> Callable[[], Block]:
        chunk = df.iloc[lo:hi]
        return _BlockRead({c: chunk[c].to_numpy() for c in chunk.columns})

    return Dataset([make_task(bounds[i], bounds[i + 1])
                    for i in builtins.range(parallelism)])
