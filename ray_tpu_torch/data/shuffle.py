"""Distributed two-stage shuffle/sort/groupby/join exchange, the port of
`ray_tpu/data/shuffle.py`.

Reference equivalent: `python/ray/data/_internal/push_based_shuffle.py` —
map tasks partition their block into R parts (R separate objects via
num_returns, so each reducer pulls only its slice), reduce tasks merge
part j from every map task. Nothing materializes on the driver: it holds
only ObjectRefs, per-block key SAMPLES (sort bounds), and final aggregate
rows (groupby) — all O(blocks + groups), not O(rows).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (Block, block_from_rows, block_num_rows,
                                block_to_rows, concat_blocks)


# -- partitioners (run inside map tasks; pickled by value, their classes
# by reference) ---------------------------------------------------------

class RandomPartitioner:
    def __init__(self, seed: Optional[int], num_parts: int):
        self.seed = seed
        self.num_parts = num_parts

    def __call__(self, block: Block, task_index: int) -> np.ndarray:
        n = block_num_rows(block)
        rng = np.random.default_rng(
            None if self.seed is None else [self.seed, task_index])
        return rng.integers(0, self.num_parts, size=n)


def _stable_hash(value: Any, num_parts: int) -> int:
    """Process-independent hash: builtin hash() of str/bytes is
    randomized per process (PYTHONHASHSEED), and map tasks run in
    DIFFERENT workers — the same key must land in the same partition
    everywhere or groups silently split across reducers."""
    import hashlib

    if hasattr(value, "item"):
        value = value.item()
    blob = repr(value).encode()
    return int.from_bytes(hashlib.md5(blob).digest()[:8], "little") \
        % num_parts


class HashPartitioner:
    def __init__(self, key: str, num_parts: int):
        self.key = key
        self.num_parts = num_parts

    def __call__(self, block: Block, task_index: int) -> np.ndarray:
        vals = np.asarray(block[self.key])
        try:
            uniq, inv = np.unique(vals, return_inverse=True)
            buckets = np.array(
                [_stable_hash(v, self.num_parts) for v in uniq],
                dtype=np.int64)
            return buckets[inv]
        except TypeError:
            # Mixed / unorderable key values: per-row hash.
            return np.array(
                [_stable_hash(v, self.num_parts) for v in vals],
                dtype=np.int64)


class RangePartitioner:
    """Quantile bounds from the sample pass; part j holds keys in
    (bounds[j-1], bounds[j]] so concatenating parts in index order is
    globally sorted."""

    def __init__(self, key: str, bounds: np.ndarray, descending: bool):
        self.key = key
        self.bounds = np.asarray(bounds)
        self.descending = descending

    def __call__(self, block: Block, task_index: int) -> np.ndarray:
        vals = np.asarray(block[self.key])
        ids = np.searchsorted(self.bounds, vals, side="left")
        if self.descending:
            ids = len(self.bounds) - ids
        return np.clip(ids, 0, len(self.bounds))


# -- finalizers (run inside reduce tasks) --------------------------------

class ShuffleFinalize:
    def __init__(self, seed: Optional[int]):
        self.seed = seed

    def __call__(self, block: Block, part_index: int) -> Block:
        n = block_num_rows(block)
        rng = np.random.default_rng(
            None if self.seed is None else [self.seed, 7919, part_index])
        order = rng.permutation(n)
        return {c: np.asarray(v)[order] for c, v in block.items()}


class SortFinalize:
    def __init__(self, key: str, descending: bool):
        self.key = key
        self.descending = descending

    def __call__(self, block: Block, part_index: int) -> Block:
        if not block:
            return block
        order = np.argsort(np.asarray(block[self.key]), kind="stable")
        if self.descending:
            order = order[::-1]
        return {c: np.asarray(v)[order] for c, v in block.items()}


class GroupAggFinalize:
    """Per-partition aggregation: hash partitioning guarantees a group
    never spans reducers, so per-part aggregates are exact."""

    def __init__(self, key: str, kind: str, on: Optional[str] = None,
                 fn: Optional[Callable] = None):
        self.key = key
        self.kind = kind
        self.on = on
        self.fn = fn

    def __call__(self, block: Block, part_index: int) -> Block:
        groups: dict = {}
        for row in block_to_rows(block):
            groups.setdefault(row[self.key], []).append(row)
        try:
            ordered = sorted(groups.items())
        except TypeError:
            ordered = list(groups.items())
        rows: List[dict] = []
        for k, grp in ordered:
            if self.kind == "count":
                rows.append({self.key: k, "count()": len(grp)})
            elif self.kind == "sum":
                rows.append({self.key: k,
                             f"sum({self.on})":
                                 sum(r[self.on] for r in grp)})
            elif self.kind == "mean":
                rows.append({self.key: k,
                             f"mean({self.on})":
                                 sum(r[self.on] for r in grp) / len(grp)})
            elif self.kind == "map_groups":
                rows.extend(self.fn(grp))
            else:
                raise ValueError(self.kind)
        return block_from_rows(rows)


# -- map / reduce task bodies -------------------------------------------

def shuffle_map(source, transforms, partitioner, num_parts: int,
                task_index: int):
    """Run the block chain (or take a materialized block), split into
    `num_parts` sub-blocks by the partitioner. Returned as a tuple so
    num_returns=R turns each part into its own object."""
    import time as _time

    t0 = _time.perf_counter()
    if callable(source):
        block = source()
        for t in transforms:
            block = t(block)
    else:
        block = source
    ids = partitioner(block, task_index)
    parts = []
    for j in range(num_parts):
        idx = np.nonzero(ids == j)[0]
        parts.append({c: np.asarray(v)[idx] for c, v in block.items()})
    _record_exchange("map", _time.perf_counter() - t0)
    return tuple(parts) if num_parts > 1 else parts[0]


def shuffle_reduce(finalize, part_index: int, *parts):
    import time as _time

    t0 = _time.perf_counter()
    live = [p for p in parts if p and block_num_rows(p)]
    block = concat_blocks(live) if live else {}
    out = finalize(block, part_index)
    _record_exchange("reduce", _time.perf_counter() - t0)
    return out


def join_reduce(on: str, how: str, n_left: int, part_index: int, *parts):
    """Merge partition j of both sides (hash-partitioned on `on`): a hash
    merge per partition — the standard partitioned hash join (reference:
    Dataset.join's hash-shuffle + per-partition merge)."""
    left = [p for p in parts[:n_left] if p and block_num_rows(p)]
    right = [p for p in parts[n_left:] if p and block_num_rows(p)]
    lb = concat_blocks(left) if left else {}
    rb = concat_blocks(right) if right else {}
    if not lb and not rb:
        return {}
    return merge_blocks(lb, rb, on, how)


def _key(value: Any) -> Any:
    return value.item() if hasattr(value, "item") else value


def _with_missing(values: np.ndarray, take: np.ndarray) -> np.ndarray:
    """values[take], where take == -1 marks a row with no partner: NaN
    there (integer and bool columns become float64, others object), as a
    pandas merge fills them."""
    values = np.asarray(values)
    missing = take < 0
    if not missing.any():
        return values[take]
    kind = values.dtype.kind
    out = np.empty(len(take), dtype=(np.float64 if kind in "iub" else
                                     values.dtype if kind in "fc" else
                                     object))
    out[~missing] = values[take[~missing]]
    out[missing] = np.nan
    return out


def merge_blocks(lb: Block, rb: Block, on: str, how: str) -> Block:
    """The rows of a pandas `merge(lb, rb, on=on, how=how, suffixes=("",
    "_1"))` without pandas: a left (inner, left) or right (right) row's
    partners in the other side's order, or every key in sorted order
    (outer); a column that clashes takes the `_1` suffix on the right, and
    a row without a partner holds NaN in the other side's columns."""
    lcols = list(lb) or [on]
    rcols = list(rb) or [on]
    lkeys = [_key(v) for v in np.asarray(lb.get(on, []))]
    rkeys = [_key(v) for v in np.asarray(rb.get(on, []))]
    lidx: dict = {}
    for i, k in enumerate(lkeys):
        lidx.setdefault(k, []).append(i)
    ridx: dict = {}
    for j, k in enumerate(rkeys):
        ridx.setdefault(k, []).append(j)
    li: List[int] = []
    ri: List[int] = []
    if how in ("inner", "left"):
        for i, k in enumerate(lkeys):
            partners = ridx.get(k)
            if partners:
                li += [i] * len(partners)
                ri += partners
            elif how == "left":
                li.append(i)
                ri.append(-1)
    elif how == "right":
        for j, k in enumerate(rkeys):
            partners = lidx.get(k)
            if partners:
                li += partners
                ri += [j] * len(partners)
            else:
                li.append(-1)
                ri.append(j)
    else:   # outer
        keys = list(dict.fromkeys(lkeys + rkeys))
        try:
            keys.sort()
        except TypeError:
            pass    # unorderable keys keep first-seen order
        for k in keys:
            ls, rs = lidx.get(k, [-1]), ridx.get(k, [-1])
            for i in ls:
                li += [i] * len(rs)
                ri += rs
    lt = np.asarray(li, dtype=np.int64)
    rt = np.asarray(ri, dtype=np.int64)
    out: Block = {}
    for c in lcols:
        if c == on:
            lk = np.asarray(lb.get(on, np.array([])))
            rk = np.asarray(rb.get(on, np.array([])))
            if how in ("inner", "left"):
                out[c] = lk[lt] if len(lt) else lk[:0]
            else:
                both = np.concatenate([lk, rk]) if len(lk) else rk
                pick = np.where(lt >= 0, lt, len(lk) + rt)
                out[c] = both[pick] if len(pick) else both[:0]
        else:
            out[c] = _with_missing(lb[c], lt)
    for c in rcols:
        if c == on:
            continue
        out[c if c not in out else f"{c}_1"] = _with_missing(rb[c], rt)
    return out


def bake_block(read_task, transforms):
    """Materialize one chain output into the object store (sort's extra
    pass: sampling must not re-run the chain)."""
    block = read_task()
    for t in transforms:
        block = t(block)
    return block


def sample_keys(block: Block, key: str, k: int = 64):
    vals = np.asarray(block[key])
    if len(vals) <= k:
        return vals
    idx = np.linspace(0, len(vals) - 1, k).astype(int)
    return vals[idx]


def _record_exchange(phase: str, seconds: float) -> None:
    """Export shuffle task time to this worker's metrics registry
    (pushed to the raylet -> dashboard /metrics): per-phase counters so
    operators can see where an all-to-all spends its time without
    attaching a profiler to every worker."""
    try:
        from ray_tpu_torch.util.metrics import Counter, get_instruments

        def build():
            return {
                "seconds": Counter(
                    "data_exchange_seconds",
                    "Wall seconds spent in Dataset exchange tasks",
                    tag_keys=("phase",)),
                "tasks": Counter(
                    "data_exchange_tasks",
                    "Dataset exchange tasks executed",
                    tag_keys=("phase",)),
            }

        m = get_instruments("data.exchange", build)
        m["seconds"].inc(seconds, tags={"phase": phase})
        m["tasks"].inc(1, tags={"phase": phase})
    except Exception:
        pass  # metrics must never fail the data path


class _RefRead:
    """A Dataset read task that fetches a reducer output by ref."""

    __name__ = "read"

    def __init__(self, ref):
        self.ref = ref

    def __call__(self) -> Block:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.ref)


def block_ref_reader(ref) -> _RefRead:
    return _RefRead(ref)


# -- driver-side exchange orchestration ---------------------------------

def _exchange(sources: List[Any], transforms, partitioner, finalize,
              num_parts: int) -> List[Any]:
    """Submit the map+reduce graph; returns reducer output refs. The
    driver never touches block data."""
    import ray_tpu_torch

    mapper = ray_tpu_torch.remote(num_cpus=1,
                                  num_returns=num_parts)(shuffle_map)
    reducer = ray_tpu_torch.remote(num_cpus=1)(shuffle_reduce)
    map_out = [mapper.remote(src, transforms, partitioner, num_parts, i)
               for i, src in enumerate(sources)]
    out = []
    for j in range(num_parts):
        parts = ([refs[j] for refs in map_out] if num_parts > 1
                 else list(map_out))
        out.append(reducer.remote(finalize, j, *parts))
    return out


def distributed_join(left_tasks, left_transforms, right_tasks,
                     right_transforms, on: str, how: str,
                     num_parts: int) -> List[Any]:
    """Two-sided hash exchange: both datasets partition on the join key,
    reducer j merges partition j of each side. Driver holds only refs."""
    import ray_tpu_torch

    part = HashPartitioner(on, num_parts)
    mapper = ray_tpu_torch.remote(num_cpus=1,
                                  num_returns=num_parts)(shuffle_map)
    reducer = ray_tpu_torch.remote(num_cpus=1)(join_reduce)
    map_l = [mapper.remote(src, left_transforms, part, num_parts, i)
             for i, src in enumerate(left_tasks)]
    map_r = [mapper.remote(src, right_transforms, part, num_parts,
                           1000 + i)
             for i, src in enumerate(right_tasks)]
    out = []
    for j in range(num_parts):
        lparts = ([refs[j] for refs in map_l] if num_parts > 1
                  else list(map_l))
        rparts = ([refs[j] for refs in map_r] if num_parts > 1
                  else list(map_r))
        out.append(reducer.remote(on, how, len(lparts), j,
                                  *lparts, *rparts))
    return out


def distributed_random_shuffle(read_tasks, transforms,
                               seed: Optional[int],
                               num_parts: int) -> List[Any]:
    return _exchange(read_tasks, transforms,
                     RandomPartitioner(seed, num_parts),
                     ShuffleFinalize(seed), num_parts)


def distributed_sort(read_tasks, transforms, key: str, descending: bool,
                     num_parts: int) -> List[Any]:
    import ray_tpu_torch

    # Pass 0: materialize chain outputs once; sample keys per block.
    bake = ray_tpu_torch.remote(num_cpus=1)(bake_block)
    block_refs = [bake.remote(t, transforms) for t in read_tasks]
    sampler = ray_tpu_torch.remote(num_cpus=1)(sample_keys)
    samples = ray_tpu_torch.get(
        [sampler.remote(r, key) for r in block_refs], timeout=600)
    allkeys = np.concatenate([np.asarray(s) for s in samples]) \
        if samples else np.array([])
    if len(allkeys) == 0 or num_parts <= 1:
        bounds = np.array([])
    else:
        # Index into the sorted sample instead of np.quantile: works for
        # any sortable dtype (np.quantile raises TypeError on strings).
        skeys = np.sort(allkeys)
        idx = np.linspace(0, len(skeys) - 1,
                          num_parts + 1)[1:-1].round().astype(int)
        bounds = np.unique(skeys[idx])
    return _exchange(block_refs, [],
                     RangePartitioner(key, bounds, descending),
                     SortFinalize(key, descending), len(bounds) + 1)


def distributed_group_agg(read_tasks, transforms, key: str, kind: str,
                          on: Optional[str], fn: Optional[Callable],
                          num_parts: int) -> List[Any]:
    return _exchange(read_tasks, transforms,
                     HashPartitioner(key, num_parts),
                     GroupAggFinalize(key, kind, on, fn), num_parts)
