"""DatasetPipeline: windowed / repeated streaming over a Dataset, the port
of `ray_tpu/data/dataset_pipeline.py`.

Reference equivalent: `python/ray/data/dataset_pipeline.py` — split a
Dataset into windows that execute one at a time (bounding working-set
memory to a window) and optionally repeat for multi-epoch training.
Each window is itself a Dataset, so every per-window transform reuses
the normal lazy machinery.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

from ray_tpu_torch.data.block import Block, block_num_rows


class DatasetPipeline:
    """A sequence of window factories, executed lazily in order."""

    def __init__(self, window_factories: List[Callable[[], Any]],
                 epochs: int = 1):
        self._windows = list(window_factories)
        self._epochs = epochs
        # Incrementally merged stats of consumed windows. Folding as each
        # window finishes (instead of retaining the window Datasets)
        # keeps an infinite `repeat()` pipeline O(1) in memory.
        self._stats_acc: Any = None
        self._exec_wall_s = 0.0  # sum of consumed windows' wall time

    # -- construction ---------------------------------------------------
    @classmethod
    def from_dataset(cls, ds, blocks_per_window: int) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset import Dataset

        tasks = list(ds._read_tasks)
        transforms = list(ds._transforms)
        k = max(1, blocks_per_window)
        factories = []
        for lo in range(0, max(len(tasks), 1), k):
            chunk = tasks[lo:lo + k]

            def make(chunk=chunk):
                return Dataset(chunk, transforms)

            factories.append(make)
        return cls(factories)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Repeat the whole pipeline `times` epochs (None = infinite;
        reference: DatasetPipeline.repeat)."""
        return DatasetPipeline(self._windows,
                               epochs=-1 if times is None else times)

    # -- per-window transforms (lazy) -----------------------------------
    def _wrap(self, fn: Callable[[Any], Any]) -> "DatasetPipeline":
        def make(factory):
            return lambda: fn(factory())

        return DatasetPipeline([make(f) for f in self._windows],
                               self._epochs)

    def map_batches(self, fn, **opts) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.map_batches(fn, **opts))

    def map(self, fn) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.map(fn))

    def filter(self, fn) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.filter(fn))

    def random_shuffle_each_window(self, *, seed=None) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.random_shuffle(seed=seed))

    def foreach_window(self, fn) -> "DatasetPipeline":
        return self._wrap(fn)

    # -- consumption ----------------------------------------------------
    def iter_windows(self) -> Iterator[Any]:
        epoch = 0
        while self._epochs < 0 or epoch < self._epochs:
            for factory in self._windows:
                ds = factory()
                try:
                    yield ds
                finally:
                    # Runs when the consumer advances past (or abandons)
                    # the window — its stats are final by then.
                    self._fold_window_stats(ds)
            epoch += 1
            if not self._windows:
                break

    def _fold_window_stats(self, ds: Any) -> None:
        stats = getattr(ds, "_last_stats", None)
        if stats is None:
            return
        if self._stats_acc is None:
            from ray_tpu_torch.data.stats import DatasetStats

            self._stats_acc = DatasetStats()
        for i, o in enumerate(stats.operators):
            self._stats_acc.fold_op(i, o)
        self._stats_acc.wait_s += stats.wait_s
        stats.finalize()  # idempotent; partial windows stamp here
        self._exec_wall_s += stats.total_wall_s or 0.0

    def iter_epochs(self) -> Iterator["DatasetPipeline"]:
        """One single-epoch pipeline per epoch (reference:
        iter_epochs)."""
        epoch = 0
        while self._epochs < 0 or epoch < self._epochs:
            yield DatasetPipeline(self._windows, epochs=1)
            epoch += 1

    def iter_blocks(self) -> Iterator[Block]:
        for window in self.iter_windows():
            yield from window.iter_blocks()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     drop_last: bool = False) -> Iterator[Block]:
        from ray_tpu_torch.data.block import rebatch

        it = rebatch(self.iter_blocks(), batch_size)
        if not drop_last or batch_size is None:
            yield from it
        else:
            yield from (b for b in it
                        if block_num_rows(b) == batch_size)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        from ray_tpu_torch.data.block import block_to_rows

        for block in self.iter_blocks():
            yield from block_to_rows(block)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        if self._epochs < 0:
            raise ValueError("count() on an infinite pipeline")
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def stats(self):
        """Merged per-operator stats across every window consumed so far
        (reference: DatasetPipeline.stats()). Operator entries fold by
        (position, name), so N windows of the same plan show one entry
        per operator with N× the blocks."""
        from ray_tpu_torch.data.stats import DatasetStats

        merged = self._stats_acc
        if merged is None:
            merged = DatasetStats()
        # Execution time is the sum of the windows' wall time — NOT the
        # clock since the accumulator was created (idle time between a
        # run and the stats() call must not count).
        merged.total_wall_s = self._exec_wall_s
        return merged

    @property
    def num_windows(self) -> int:
        return len(self._windows)
