"""What the port's Data tests share: the functions and classes their
datasets send to workers (module level: the port exports them by
reference), and the scenarios both packages run.

`data_scenarios(pkg)` runs `pkg.data` on a running runtime of `pkg`: the
port's cluster, or the reference's in-process local mode, whose tasks run
the same distributed exchange (shuffle, sort, groupby, join) as its
cluster. Results are plain lists and numbers, so the two packages' compare
with `==`.

This module imports neither jax nor torch at its top: the port's worker
processes import it to find what a test sends them.
"""

import importlib
import os
import time

import numpy as np

# The shuffle, sort and groupby sizes (the reference's tests use 6,000,000,
# 200,000 and 300,000 rows; these are cut so that both sides and the port's
# cluster stay within a few seconds).
SHUFFLE_ROWS = 2_000_000
SORT_ROWS = 200_000
GROUPBY_ROWS = 60_000


# ---------------------------------------------------------------------------
# Block transforms and row functions (module level)
# ---------------------------------------------------------------------------
def double_x(b):
    return {"x": b["id"] * 2}


def id_as_x(b):
    return {"x": b["id"]}


def id_as_float_x(b):
    return {"x": b["id"].astype(np.float32)}


def plus_100(b):
    return {"id": b["id"] + 100}


def times_ten(b):
    return {"x": b["x"] * 10}


def key_mod_7(b):
    return {"k": b["id"] % 7, "v": b["id"]}


def id_x(b):
    return {"id": b["id"]}


def with_square(r):
    return {"id": r["id"], "sq": int(r["id"]) ** 2}


def even_id(r):
    return r["id"] % 2 == 0


def twice(r):
    return [r, r]


def same(r):
    return r


def y_double(b):
    return {"y": b["id"] * 2}


def y_plus_one(b):
    return {"y": b["id"] + 1}


def y_times_ten(b):
    return {"y": b["id"] * 10}


def z_plus_two(b):
    return {"z": b["id"] + 2}


def x_plus_y(r):
    return {"s": r["x"] + r["y"]}


def x_times_y(blk):
    return {"m": blk["x"] * blk["y"]}


def y_at_least_100(r):
    return r["y"] >= 100


def ten_times(b):
    return {"id": b["id"] * 10}


def group_sizes(rows):
    return [{"k": rows[0]["k"], "n": len(rows)}]


class AddConst:
    """Stateful callable class (the reference's tests/test_data_actor_pool.py
    AddConst), plus the device visibility and pid of the replica it runs
    in."""

    def __init__(self, c):
        self.c = c

    def __call__(self, block):
        n = len(block["x"])
        return {"x": block["x"] + self.c,
                "pid": np.full(n, os.getpid()),
                "visible": np.full(n, int(os.environ.get(
                    "CUDA_VISIBLE_DEVICES", "-1") or -1))}


class Doubler:
    """An actor for `ActorPool`: doubles a value, after `delay` seconds."""

    def double(self, v, delay=0.0):
        time.sleep(delay)
        return 2 * v


class CountingRead:
    """A read task that counts itself on a named actor before it returns
    its one-row block (the backpressure scenario)."""

    __name__ = "read"

    def __init__(self, i, pkg_name, counter):
        self.i, self.pkg_name, self.counter = i, pkg_name, counter

    def __call__(self):
        pkg = importlib.import_module(self.pkg_name)
        c = pkg.get_actor(self.counter)
        pkg.get(c.incr.remote(), timeout=30)
        return {"id": np.array([self.i])}


class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n

    def value(self):
        return self.n


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------
def _ints(values):
    return [int(v) for v in values]


def _rows(rows):
    return [{k: (v.item() if hasattr(v, "item") else v)
             for k, v in r.items()} for r in rows]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return None


def driver_rss() -> int:
    with open(f"/proc/{os.getpid()}/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def data_scenarios(pkg, tmp: str) -> dict:
    """The reference's tests/test_data.py, test_data_shuffle.py and the
    distributed join of test_data_zip_join.py, on a running runtime of
    `pkg`, files under `tmp`."""
    data = importlib.import_module(pkg.__name__ + ".data")
    out = {}

    ds = data.range(1000, parallelism=8).map_batches(double_x)
    out["sum"] = sum(int(b["x"].sum()) for b in ds.iter_batches(
        batch_size=100))
    out["count"] = ds.count()

    ds = data.range(100, parallelism=4).map(with_square).filter(even_id)
    out["map_filter_take"] = _rows(ds.take(5))
    out["map_filter_count"] = ds.count()

    out["sizes"] = [len(b["id"]) for b in data.range(
        250, parallelism=7).iter_batches(batch_size=64)]
    out["sizes_drop_last"] = [len(b["id"]) for b in data.range(
        250, parallelism=7).iter_batches(batch_size=64, drop_last=True)]

    shards = data.range(100, parallelism=6).split_for_workers(3)
    out["split"] = [sorted(int(i) for b in s.iter_blocks() for i in b["id"])
                    for s in shards]
    out["split_too_few"] = _error(
        lambda: data.range(10, parallelism=2).split_for_workers(3))

    ds = data.range(10, parallelism=3)
    out["limit_count"] = ds.limit(4).count()
    out["limit_take"] = _ints(r["id"] for r in ds.limit(3).take_all())
    out["flat_map_count"] = ds.flat_map(twice).count()
    out["union_count"] = data.range(3).union(data.range(2)).count()
    out["sort_items"] = _ints(r["item"] for r in data.from_items(
        [3, 1, 2]).sort("item").take_all())
    out["sort_items_desc"] = _ints(r["item"] for r in data.from_items(
        [3, 1, 2]).sort("item", descending=True).take_all())
    out["shuffle_50"] = _ints(r["id"] for r in data.range(
        50, parallelism=4).random_shuffle(seed=7).take_all())
    rp = data.range(12, parallelism=2).repartition(4)
    out["repartition"] = [rp.num_blocks, rp.count()]
    out["groupby_count"] = _rows(data.from_items(
        ["a", "b", "a", "a"]).groupby("item").count().take_all())
    out["groupby_sum"] = _rows(data.from_numpy(
        {"k": np.array([1, 1, 2]), "v": np.array([10, 20, 5])}
    ).groupby("k").sum("v").take_all())
    out["groupby_mean"] = _rows(data.from_numpy(
        {"k": np.array([1, 1, 2]), "v": np.array([10, 20, 5])}
    ).groupby("k").mean("v").take_all())
    out["map_groups"] = sorted(
        _ints((r["k"], r["n"])) for r in data.from_numpy(
            {"k": np.array([1, 1, 2, 3, 3, 3])}).groupby("k").map_groups(
            group_sizes).take_all())
    jpath = os.path.join(tmp, f"rows-{pkg.__name__}.jsonl")
    with open(jpath, "w") as f:
        f.write('{"x": 1}\n{"x": 2}\n')
    out["json_count"] = data.read_json(jpath).count()

    lim = data.range(100, parallelism=4).limit(10)
    out["limit_honored"] = [lim.count(), sum(
        len(b["id"]) for b in lim.iter_batches(batch_size=3))]
    out["limit_map"] = _error(lambda: lim.map(same))
    out["limit_shuffle"] = _error(lambda: lim.random_shuffle())
    g = data.from_items([{"k": None, "v": 1}, {"k": 1, "v": 2},
                         {"k": None, "v": 3}])
    out["mixed_keys"] = sorted(
        (str(r["k"]), int(r["count()"])) for r in
        data.Dataset.groupby(g, "k").count().take_all())

    # tests/test_data_shuffle.py, at SHUFFLE_ROWS, SORT_ROWS, GROUPBY_ROWS.
    n = SHUFFLE_ROWS
    rss0 = driver_rss()
    blocks = []
    for block in data.range(n, parallelism=8).random_shuffle(
            seed=3).iter_blocks():
        ids = block["id"]
        blocks.append([len(ids), int(ids.sum()), _ints(ids[:100])])
    out["shuffle_blocks"] = blocks
    out["shuffle_rss_growth"] = driver_rss() - rss0

    vals = np.random.default_rng(0).permutation(SORT_ROWS)
    out["sort_blocks"] = [
        [len(b["v"]), _ints(b["v"][:3]), _ints(b["v"][-3:])]
        for b in data.from_numpy({"v": vals}, parallelism=8).sort(
            "v").iter_blocks()]
    out["sort_desc"] = [
        _ints(b["v"][:5]) for b in data.from_numpy(
            {"v": vals[:50_000]}, parallelism=4).sort(
            "v", descending=True).iter_blocks() if len(b["v"])]
    ds = data.range(GROUPBY_ROWS, parallelism=8).map_batches(key_mod_7)
    out["groupby_sums"] = [_ints((r["k"], r["sum(v)"])) for r in
                           ds.groupby("k").sum("v").take_all()]
    out["groupby_counts"] = [_ints((r["k"], r["count()"])) for r in
                             ds.groupby("k").count().take_all()]

    # The distributed join of tests/test_data_zip_join.py.
    rng = np.random.default_rng(0)
    lk = rng.integers(0, 50, 300)
    rk = rng.integers(0, 50, 200)
    left = data.from_numpy({"k": lk, "a": np.arange(300)}, parallelism=4)
    right = data.from_numpy({"k": rk, "b": np.arange(200) * 10},
                            parallelism=3)
    out["join_inner"] = sorted(_ints((r["k"], r["a"], r["b"]))
                               for r in left.join(right, on="k").take_all())
    out["join_outer"] = sorted(
        tuple(-1 if v != v else int(v) for v in (r["k"], r["a"], r["b"]))
        for r in left.join(right, on="k", how="outer").take_all())
    return out


def ingest_loop(config):
    """`TorchTrainer`'s loop of the ingest test: this worker's rows of its
    shard (by `iter_torch_batches` on the CPU) and the step's data_wait,
    written where the test reads them."""
    import json

    import torch

    from ray_tpu_torch import train

    shard = train.get_dataset_shard("train")
    ids = sorted(int(i) for b in shard.iter_torch_batches(
        batch_size=16, device="cpu", dtypes={"id": torch.int64})
        for i in b["id"])
    rank = train.get_world_rank()
    train.report({"ids": ids, "rank": rank})
    tele = shard._session.last_telemetry
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"ids": ids, "data_wait_s": tele["data_wait_s"]}, f)


# The reference's tests/test_data_actor_pool.py FlagshipScorer's widths.
TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=64)


class TinyScorer:
    """The port's twin of the reference's FlagshipScorer at its widths: it
    builds the model once per replica, from the JAX package's weights
    (numpy), and scores each block by each sequence's mean logit."""

    def __init__(self, np_params):
        import torch

        from ray_tpu_torch.models import TransformerConfig, params_from_jax

        self.cfg = TransformerConfig(dtype=torch.float32, **TINY)
        self.params = params_from_jax(np_params, device="cpu")

    def __call__(self, block):
        import torch

        from ray_tpu_torch.models import forward

        with torch.no_grad():
            logits, _ = forward(self.params, block["tokens"], self.cfg,
                                device="cpu")
        return {"score": logits.mean(dim=(1, 2)).numpy()}


# ---------------------------------------------------------------------------
# util.collective (the reference's tests/test_collective.py)
# ---------------------------------------------------------------------------
class CollWorker:
    """The reference's tests/test_collective.py `_CollWorker`, for either
    package (`pkg_name`)."""

    def __init__(self, pkg_name, rank, world, group="default"):
        self.col = importlib.import_module(pkg_name + ".util.collective")
        self.rank, self.world, self.group = rank, world, group

    def setup(self):
        self.col.init_collective_group(self.world, self.rank, backend="gloo",
                                       group_name=self.group)
        return self.col.get_rank(self.group)

    def allreduce(self, op="sum"):
        return self.col.allreduce(
            np.full((8,), float(self.rank + 1), np.float32),
            group_name=self.group, op=op)

    def broadcast(self, src):
        return self.col.broadcast(
            np.full((4,), float(self.rank), np.float32), src_rank=src,
            group_name=self.group)

    def allgather(self):
        return self.col.allgather(np.array([self.rank * 10], np.int64),
                                  group_name=self.group)

    def reducescatter(self):
        return self.col.reducescatter(np.arange(8, dtype=np.float32),
                                      group_name=self.group)

    def reduce(self, dst):
        return self.col.reduce(np.full((3,), float(self.rank + 2)),
                               dst_rank=dst, group_name=self.group)

    def barrier_then_rank(self):
        self.col.barrier(self.group)
        return self.rank

    def sendrecv(self):
        if self.rank == 0:
            self.col.send(np.array([42.0], np.float32), dst_rank=1,
                          group_name=self.group)
            return None
        if self.rank == 1:
            return self.col.recv(np.zeros(1, np.float32), src_rank=0,
                                 group_name=self.group)
        return None

    def teardown(self):
        self.col.destroy_collective_group(self.group)
        return True


class PlainActor:
    """No collective methods: `create_collective_group` wires the group in
    through `__ray_call__` (the reference's `_PlainActor`)."""

    def __init__(self, pkg_name):
        self.col = importlib.import_module(pkg_name + ".util.collective")

    def value(self):
        return self.col.allreduce(
            np.array([float(self.col.get_rank("d") + 1)]), group_name="d")


def _lists(values):
    return [np.asarray(v).tolist() for v in values]


def collective_scenarios(pkg) -> dict:
    """The reference's tests/test_collective.py gloo cases on a running
    cluster of `pkg`: four actors in group "t", and a driver-declared
    group of two plain actors."""
    col = importlib.import_module(pkg.__name__ + ".util.collective")
    get = pkg.get
    n = 4
    worker = pkg.remote(num_cpus=1)(CollWorker)
    workers = [worker.remote(pkg.__name__, i, n, "t") for i in range(n)]
    out = {"ranks": get([w.setup.remote() for w in workers], timeout=180)}
    for op in ("sum", "max", "min", "product"):
        out[f"allreduce_{op}"] = _lists(get(
            [w.allreduce.remote(op) for w in workers], timeout=120))
    out["broadcast"] = _lists(get([w.broadcast.remote(2) for w in workers],
                                  timeout=120))
    out["allgather"] = [_lists(o) for o in get(
        [w.allgather.remote() for w in workers], timeout=120)]
    out["reducescatter"] = _lists(get(
        [w.reducescatter.remote() for w in workers], timeout=120))
    out["reduce_dst"] = _lists(get([w.reduce.remote(1) for w in workers],
                                   timeout=120))[1]
    out["barrier"] = sorted(get([w.barrier_then_rank.remote()
                                 for w in workers], timeout=120))
    out["sendrecv"] = np.asarray(get(
        [w.sendrecv.remote() for w in workers], timeout=120)[1]).tolist()
    get([w.teardown.remote() for w in workers], timeout=30)
    for w in workers:
        pkg.kill(w)
    try:
        col.allreduce(np.zeros(2), group_name="nope")
        out["uninitialized"] = None
    except RuntimeError as e:
        out["uninitialized"] = "not initialized" in str(e)
    plain = pkg.remote(num_cpus=1)(PlainActor)
    actors = [plain.remote(pkg.__name__) for _ in range(2)]
    col.create_collective_group(actors, 2, [0, 1], backend="gloo",
                                group_name="d")
    out["declared"] = _lists(get([a.value.remote() for a in actors],
                                 timeout=120))
    for a in actors:
        pkg.kill(a)
    return out


def collective_loop(config):
    """`TorchTrainer`'s loop of the telemetry test: a gloo group over the
    gang's workers and a few all-reduces inside one step."""
    from ray_tpu_torch import train
    from ray_tpu_torch.util import collective as col

    rank, world = train.get_world_rank(), train.get_world_size()
    col.init_collective_group(world, rank, backend="gloo",
                              group_name="tele")
    total = 0.0
    for _ in range(config["ops"]):
        total += float(col.allreduce(np.ones(1 << 16, np.float32),
                                     group_name="tele")[0])
    col.barrier(group_name="tele")
    train.report({"total": total})
    train.report({"total": 0.0})
    col.destroy_collective_group("tele")


# ---------------------------------------------------------------------------
# iter_torch_batches over a DeviceMesh, on gloo ranks (tests/torch_dist.py)
# ---------------------------------------------------------------------------
MESH_ROWS, MESH_BLOCKS = 56, 8


def mesh_rows():
    return np.random.default_rng(11).random((MESH_ROWS, 3)).astype(
        np.float32)


def mesh_rank_batches(batch_size: int):
    """One gloo rank: this rank's `split_for_workers` shard of a dataset
    every rank builds alike, through `iter_torch_batches(mesh=...)` on a
    `make_mesh` of the world (dp = world). Per batch: the local rows, the
    DTensor's full tensor (or None for an unsharded short batch), and the
    placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import data
    from ray_tpu_torch.parallel import make_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh((world, 1, 1, 1), device="cpu")
    ds = data.from_numpy({"x": mesh_rows(),
                          "i": np.arange(MESH_ROWS)},
                         parallelism=MESH_BLOCKS)
    shard = ds.split_for_workers(world)[rank]
    out = []
    for b in shard.iter_torch_batches(batch_size=batch_size, mesh=mesh,
                                      batch_axis="dp"):
        x = b["x"]
        if isinstance(x, DTensor):
            out.append({"local": x.to_local().numpy(),
                        "full": x.full_tensor().numpy(),
                        "ids": b["i"].to_local().numpy(),
                        "placements": [
                            "shard0" if p.is_shard(0) else
                            "replicate" if p.is_replicate() else str(p)
                            for p in x.placements]})
        else:
            out.append({"local": x.numpy(), "full": None,
                        "ids": b["i"].numpy(), "placements": None})
    return out


def main(pkg_name: str, what: str) -> None:
    """The reference's side as a child interpreter: one JSON line."""
    import json
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    pkg = importlib.import_module(pkg_name)
    pkg.init(num_cpus=8)
    try:
        out = {"collective": collective_scenarios}[what](pkg)
    finally:
        pkg.shutdown()
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    import sys

    main(sys.argv[1], sys.argv[2])
