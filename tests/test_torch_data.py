"""The port's Data library (`ray_tpu_torch.data`) on its cluster runtime
against the JAX package's `ray_tpu.data` on the same inputs.

The reference's side runs in this process on `ray_tpu.init(local_mode=
True)`, whose tasks run the same two-stage exchange as its cluster
(`shuffle.py`: random_shuffle, sort, groupby, join), so its rows and their
order are the cluster's; the port's side runs on its cluster, started once
for the module. Both run `torch_data_helpers.data_scenarios`: the
reference's tests/test_data.py, test_data_shuffle.py and the distributed
join of test_data_zip_join.py, case by case.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_data_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu import data as rdata  # noqa: E402
from ray_tpu_torch import data as tdata  # noqa: E402

pytestmark = pytest.mark.unit


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    ray_tpu.init(local_mode=True)
    try:
        return helpers.data_scenarios(
            ray_tpu, str(tmp_path_factory.mktemp("ref_data")))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_cluster(ref):
    niced(lambda: ray_tpu_torch.init(num_cpus=4))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port(port_cluster, tmp_path_factory):
    return helpers.data_scenarios(
        ray_tpu_torch, str(tmp_path_factory.mktemp("port_data")))


SCENARIO_KEYS = [
    "sum", "count", "map_filter_take", "map_filter_count", "sizes",
    "sizes_drop_last", "split", "split_too_few", "limit_count", "limit_take",
    "flat_map_count", "union_count", "sort_items", "sort_items_desc",
    "shuffle_50", "repartition", "groupby_count", "groupby_sum",
    "groupby_mean", "map_groups", "json_count", "limit_honored",
    "limit_map", "limit_shuffle", "mixed_keys", "shuffle_blocks",
    "sort_blocks", "sort_desc", "groupby_sums", "groupby_counts",
    "join_inner", "join_outer"]


@pytest.mark.parametrize("key", SCENARIO_KEYS)
def test_scenario_matches_reference(key, port, ref):
    """Exact: the same rows in the same order (shuffle seeds, range
    bounds, hash and range partitions), the same errors' types."""
    assert port[key] == ref[key]


def test_scenarios_say_what_they_should(port):
    """The reference's own assertions (tests/test_data.py,
    test_data_shuffle.py), on the port's results."""
    assert port["sum"] == 2 * sum(range(1000)) and port["count"] == 1000
    assert [r["id"] for r in port["map_filter_take"]] == [0, 2, 4, 6, 8]
    assert port["map_filter_take"][3]["sq"] == 36
    assert port["map_filter_count"] == 50
    assert port["sizes"] == [64, 64, 64, 58]
    assert port["sizes_drop_last"] == [64, 64, 64]
    split = [set(s) for s in port["split"]]
    assert set().union(*split) == set(range(100))
    assert sum(len(s) for s in split) == 100
    assert port["split_too_few"] == "ValueError"
    assert port["limit_take"] == [0, 1, 2] and port["union_count"] == 5
    assert port["sort_items"] == [1, 2, 3]
    assert port["sort_items_desc"] == [3, 2, 1]
    assert sorted(port["shuffle_50"]) == list(range(50))
    assert port["shuffle_50"] != list(range(50))
    assert port["repartition"] == [4, 12]
    assert port["limit_honored"] == [10, 10]
    assert port["limit_map"] == port["limit_shuffle"] == \
        "NotImplementedError"
    assert port["mixed_keys"] == [("1", 1), ("None", 2)]
    n = helpers.SHUFFLE_ROWS
    blocks = port["shuffle_blocks"]
    assert sum(b[0] for b in blocks) == n
    assert sum(b[1] for b in blocks) == n * (n - 1) // 2
    assert blocks[0][2] != list(range(100))
    # One block at a time on the driver: far below the dataset's size.
    assert port["shuffle_rss_growth"] < 4 * n
    prev = -1
    for size, head, tail in port["sort_blocks"]:
        if size:
            assert head[0] >= prev and head == sorted(head)
            prev = tail[-1]
    assert sum(b[0] for b in port["sort_blocks"]) == helpers.SORT_ROWS
    ids = np.arange(helpers.GROUPBY_ROWS)
    assert port["groupby_sums"] == [[k, int(ids[ids % 7 == k].sum())]
                                    for k in range(7)]
    assert sum(c for _, c in port["groupby_counts"]) == helpers.GROUPBY_ROWS


def test_join_rows_are_pandas_merge_rows(port):
    """The distributed hash join (no pandas in the port) gives a pandas
    merge's rows."""
    import pandas as pd

    rng = np.random.default_rng(0)
    lk = rng.integers(0, 50, 300)
    rk = rng.integers(0, 50, 200)
    want = pd.DataFrame({"k": lk, "a": np.arange(300)}).merge(
        pd.DataFrame({"k": rk, "b": np.arange(200) * 10}), on="k")
    assert port["join_inner"] == sorted(
        [int(k), int(a), int(b)]
        for k, a, b in zip(want["k"], want["a"], want["b"]))


def test_streaming_backpressure(port_cluster):
    """A slow consumer bounds how far producers run ahead (the
    reference's test_streaming_backpressure, on the port's cluster)."""
    import time

    counter = ray_tpu_torch.remote(num_cpus=0)(helpers.Counter).options(
        name="bp_counter").remote()
    ray_tpu_torch.get(counter.value.remote(), timeout=30)
    window = 2
    ds = tdata.Dataset([helpers.CountingRead(i, "ray_tpu_torch",
                                             "bp_counter")
                        for i in range(12)])
    consumed = 0
    for _ in ds.iter_blocks(max_in_flight=window):
        consumed += 1
        time.sleep(0.3)
        produced = ray_tpu_torch.get(counter.value.remote(), timeout=30)
        assert produced <= consumed + window, \
            f"no backpressure: {produced} produced vs {consumed} consumed"
    assert consumed == 12
    ray_tpu_torch.kill(counter)


def test_parquet_csv_roundtrip(port_cluster, tmp_path):
    """Where pandas and pyarrow are installed, the port reads and writes
    what the reference does (each file read in a worker)."""
    import pandas as pd

    for i in range(3):
        pd.DataFrame({"a": np.arange(i * 10, i * 10 + 10),
                      "b": np.arange(10) * 0.5}).to_parquet(
            tmp_path / f"part-{i}.parquet")
        pd.DataFrame({"c": np.arange(5) + i}).to_csv(
            tmp_path / f"part-{i}.csv", index=False)
    got = tdata.read_parquet(str(tmp_path / "*.parquet"))
    want = rdata.read_parquet(str(tmp_path / "*.parquet"))
    assert got.num_blocks == want.num_blocks == 3
    assert got.count() == want.count() == 30
    np.testing.assert_array_equal(got.materialize()["a"],
                                  want.materialize()["a"])
    assert got.schema() == want.schema()
    assert got.schema()["b"] == "float64"
    assert tdata.read_csv(str(tmp_path / "*.csv")).count() == \
        rdata.read_csv(str(tmp_path / "*.csv")).count() == 15
    df = pd.DataFrame({"a": [1, 2, 3]})
    ds = tdata.from_pandas(df, parallelism=2)
    assert ds.to_pandas()["a"].tolist() == [1, 2, 3]
    ds.write_parquet(str(tmp_path / "pq"))
    assert tdata.read_parquet(str(tmp_path / "pq")).count() == 3
    lim = tdata.range(100, parallelism=4).limit(10)
    assert len(lim.to_pandas()) == 10
    lim.write_csv(str(tmp_path / "lim"))
    assert tdata.read_csv(str(tmp_path / "lim")).count() == 10


def test_lambdas_on_the_cluster_raise_a_named_type_error(port_cluster):
    """The port sends functions by reference: a lambda fails at its
    first task with a TypeError that says to define it at module
    level."""
    with pytest.raises(TypeError, match="module level"):
        tdata.range(8).map_batches(lambda b: b).count()


def test_stats_name_the_fused_operators_as_the_reference(port_cluster):
    ds = tdata.range(64, parallelism=4).map_batches(helpers.double_x)
    assert ds.count() == 64
    names = [o.name for o in ds.stats().operators]
    want = rdata.range(64, parallelism=4).map_batches(helpers.double_x)
    assert want.count() == 64
    assert names == [o.name for o in want.stats().operators] == \
        ["read", "double_x"]
    st = ds.stats()
    assert st.op("read").rows == 64 and st.op("read").blocks == 4
    assert "consumer wait" in st.summary_string()


def test_train_ingest_disjoint_shards(port_cluster, tmp_path):
    """`TorchTrainer(datasets=...)` with 2 gloo CPU workers: each worker's
    `get_dataset_shard` rows are its `split_for_workers` shard, the
    reference's shard for the same plan, disjoint, their union the
    dataset (the reference's tests/test_data.py:140)."""
    from ray_tpu_torch import train

    ds = tdata.range(64, parallelism=4).map_batches(helpers.id_x)
    # A dataset the driver has run (its stats hold a lock) still goes to
    # the workers.
    assert ds.count() == 64 and ds.stats() is not None
    trainer = train.TorchTrainer(
        helpers.ingest_loop, train_loop_config={"out": str(tmp_path)},
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="ingest",
                                   storage_path=str(tmp_path / "runs")),
        datasets={"train": ds})
    result = trainer.fit()
    assert result.error is None
    got = {}
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got[rank] = json.load(f)
    ref_shards = rdata.range(64, parallelism=4).map_batches(
        helpers.id_x).split_for_workers(2)
    for rank in range(2):
        want = sorted(int(i) for b in ref_shards[rank].iter_blocks()
                      for i in b["id"])
        assert got[rank]["ids"] == want
        assert got[rank]["data_wait_s"] > 0
    assert set(got[0]["ids"]).isdisjoint(got[1]["ids"])
    assert sorted(got[0]["ids"] + got[1]["ids"]) == list(range(64))
    assert len(result.metrics["ids"]) == 32

