"""The port's Data library without a runtime (every plan runs in this
process, as the reference's does when `ray_tpu` is not initialised) against
the JAX package's on the same inputs: the reference's
tests/test_data_zip_join.py (zip, the local join, DatasetPipeline) case by
case, the in-process shuffle, sort, groupby and repartition, blocks and
stats, and the IO calls' refusals where pandas or pyarrow is missing.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_data_helpers as h  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu import data as rdata  # noqa: E402
from ray_tpu.data import block as rblock  # noqa: E402
from ray_tpu_torch import data as tdata  # noqa: E402
from ray_tpu_torch.data import block as tblock  # noqa: E402

pytestmark = pytest.mark.unit


@pytest.fixture(autouse=True)
def no_runtime():
    assert not ray_tpu.is_initialized()
    assert not ray_tpu_torch.is_initialized()


def _plain(rows):
    """Rows as plain Python values (NaN as the string 'nan')."""
    out = []
    for r in rows:
        row = {}
        for k, v in r.items():
            v = v.item() if hasattr(v, "item") else v
            row[k] = "nan" if isinstance(v, float) and v != v else v
        out.append(row)
    return out


# -- plans run by both packages (each returns plain rows or values) ------
def zip_aligns(d):
    a = d.range(100, parallelism=4).map_batches(h.id_as_x)
    b = d.range(100, parallelism=7).map_batches(h.y_double)
    return _plain(a.zip(b).take_all())


def zip_name_clash(d):
    return sorted(d.range(10).zip(d.range(10)).take_all()[0])


def zip_then_map(d):
    a = d.range(20).map_batches(h.id_as_x)
    b = d.range(20).map_batches(h.y_plus_one)
    return _plain(a.zip(b).map(h.x_plus_y).take_all())


def zip_transforms_keep_partner(d):
    a = d.range(20).map_batches(h.id_as_x)
    b = d.range(20).map_batches(h.y_times_ten)
    return [_plain(a.zip(b).map(h.x_plus_y).take_all()),
            _plain(a.zip(b).map_batches(h.x_times_y).take_all()),
            len(a.zip(b).filter(h.y_at_least_100).take_all())]


def zip_chains(d):
    a = d.range(10).map_batches(h.id_as_x)
    b = d.range(10).map_batches(h.y_plus_one)
    c = d.range(10).map_batches(h.z_plus_two)
    return _plain(a.zip(b).zip(c).take_all())


def zip_then_limit(d):
    a = d.range(20).map_batches(h.id_as_x)
    b = d.range(20).map_batches(h.y_plus_one)
    return _plain(a.zip(b).limit(5).take_all())


def _left(d):
    return d.from_numpy({"k": np.array([1, 2, 3, 4, 5]),
                         "a": np.array([10, 20, 30, 40, 50])}, parallelism=2)


def _right(d):
    return d.from_numpy({"k": np.array([2, 4, 6]),
                         "b": np.array([200, 400, 600])}, parallelism=2)


def join_local(how):
    def plan(d):
        rows = _plain(_left(d).join(_right(d), on="k", how=how).take_all())
        return sorted(rows, key=lambda r: r["k"])

    plan.__name__ = f"join_{how}"
    return plan


def window_order(d):
    pipe = d.range(64, parallelism=8).window(blocks_per_window=2)
    return [pipe.num_windows, [int(r["id"]) for r in pipe.iter_rows()]]


def repeat_epochs(d):
    pipe = d.range(10, parallelism=2).repeat(3)
    epochs = list(pipe.iter_epochs())
    return [pipe.count(), len(epochs),
            [int(r["id"]) for r in epochs[0].iter_rows()]]


def per_window_transform(d):
    pipe = (d.range(16, parallelism=4).window(blocks_per_window=2)
            .map_batches(h.ten_times))
    return [int(r["id"]) for r in pipe.iter_rows()]


def pipeline_batches_and_take(d):
    pipe = d.range(40, parallelism=4).window(blocks_per_window=1)
    return [[len(b["id"]) for b in pipe.iter_batches(batch_size=16)],
            [int(r["id"]) for r in pipe.take(5)]]


def infinite_repeat_take(d):
    pipe = d.range(4, parallelism=1).repeat(None)
    return [int(r["id"]) for r in pipe.take(10)]


def local_shuffle(d):
    return [int(r["id"]) for r in d.range(50, parallelism=4).random_shuffle(
        seed=7).take_all()]


def local_sort(d):
    vals = np.random.default_rng(0).permutation(1000)
    ds = d.from_numpy({"v": vals, "w": vals * 2}, parallelism=4)
    return [[int(x) for x in b["v"][:5]] + [len(b["v"])]
            for b in ds.sort("v", descending=True).iter_blocks()]


def local_groupby(d):
    ds = d.range(700, parallelism=3).map_batches(h.key_mod_7)
    g = ds.groupby("k")
    return [_plain(g.count().take_all()), _plain(g.sum("v").take_all()),
            _plain(g.mean("v").take_all()),
            _plain(g.map_groups(h.group_sizes).take_all())]


def local_repartition_union_limit(d):
    rp = d.range(12, parallelism=2).repartition(5)
    u = d.range(3).union(d.range(4, parallelism=2).map_batches(h.plus_100))
    return [[len(b["id"]) for b in rp.iter_blocks()],
            [int(r["id"]) for r in u.take_all()],
            [int(r["id"]) for r in d.range(30).limit(7).take_all()],
            d.range(10).flat_map(h.twice).count()]


def local_split(d):
    return [[int(i) for b in s.iter_blocks() for i in b["id"]]
            for s in d.range(100, parallelism=6).split_for_workers(3)]


def items_and_blocks(d):
    a = d.from_items([{"u": 1, "v": "x"}, {"u": 2, "v": "y"},
                      {"u": 3, "v": "z"}], parallelism=2)
    b = d.from_blocks([{"w": np.arange(3)}, {"w": np.arange(3, 5)}])
    return [_plain(a.take_all()), a.schema(), _plain(b.take_all()),
            b.num_blocks, repr(b)]


def read_json_rows(d, tmp):
    p = os.path.join(tmp, "rows.jsonl")
    with open(p, "w") as f:
        f.write('{"x": 1, "s": "a"}\n{"x": 2, "s": "b"}\n')
    q = os.path.join(tmp, "rows.json")
    with open(q, "w") as f:
        f.write('[{"x": 3}, {"x": 4}, {"x": 5}]')
    return [_plain(d.read_json(p).take_all()),
            _plain(d.read_json(q, lines=False).take_all()),
            d.read_json(tmp + "/*.jsonl").num_blocks]


PLANS = [zip_aligns, zip_name_clash, zip_then_map,
         zip_transforms_keep_partner, zip_chains, zip_then_limit,
         join_local("inner"), join_local("left"), join_local("right"),
         join_local("outer"), window_order, repeat_epochs,
         per_window_transform, pipeline_batches_and_take,
         infinite_repeat_take, local_shuffle, local_sort, local_groupby,
         local_repartition_union_limit, local_split, items_and_blocks]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: p.__name__)
def test_plan_matches_reference(plan):
    """Exact: the same rows in the same order (the local join against the
    reference's pandas merge, NaN where a row has no partner)."""
    assert plan(tdata) == plan(rdata)


def test_read_json_matches_reference(tmp_path):
    assert read_json_rows(tdata, str(tmp_path)) == \
        read_json_rows(rdata, str(tmp_path))


def test_zip_and_pipeline_say_what_they_should():
    """The reference's own assertions in tests/test_data_zip_join.py."""
    rows = zip_aligns(tdata)
    assert len(rows) == 100 and all(r["y"] == 2 * r["x"] for r in rows)
    assert zip_name_clash(tdata) == ["id", "id_1"]
    with pytest.raises(ValueError, match="different row counts"):
        tdata.range(10).zip(tdata.range(12)).take_all()
    assert sum(r["s"] for r in zip_then_map(tdata)) == sum(
        i + i + 1 for i in range(20))
    s, m, n = zip_transforms_keep_partner(tdata)
    assert [r["s"] for r in s] == [i + 10 * i for i in range(20)]
    assert [r["m"] for r in m] == [i * 10 * i for i in range(20)]
    assert n == 10
    assert all(r["y"] == r["x"] + 1 and r["z"] == r["x"] + 2
               for r in zip_chains(tdata))
    assert len(zip_then_limit(tdata)) == 5
    with pytest.raises(NotImplementedError, match="actors"):
        tdata.range(10).zip(tdata.range(10)).map_batches(
            h.same, compute="actors")
    inner = join_local("inner")(tdata)
    assert [(r["k"], r["a"], r["b"]) for r in inner] == \
        [(2, 20, 200), (4, 40, 400)]
    left = {r["k"]: r["b"] for r in join_local("left")(tdata)}
    assert len(left) == 5 and left[2] == 200 and left[1] == "nan"
    with pytest.raises(ValueError, match="how"):
        _left(tdata).join(_right(tdata), on="k", how="cross")
    assert window_order(tdata) == [4, list(range(64))]
    assert repeat_epochs(tdata) == [30, 3, list(range(10))]
    assert infinite_repeat_take(tdata) == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]
    with pytest.raises(ValueError, match="infinite"):
        tdata.range(4, parallelism=1).repeat(None).count()


def test_pipeline_stats_fold_windows_as_the_reference():
    got = tdata.range(16, parallelism=4).window(blocks_per_window=2)
    want = rdata.range(16, parallelism=4).window(blocks_per_window=2)
    assert got.count() == want.count() == 16
    g, w = got.stats(), want.stats()
    assert [(o.name, o.blocks, o.rows) for o in g.operators] == \
        [(o.name, o.blocks, o.rows) for o in w.operators] == \
        [("read", 4, 16)]
    assert g.total_wall_s > 0


@pytest.mark.parametrize("batch_size", [None, 1, 3, 7, 64])
def test_rebatch_matches_reference(batch_size):
    rng = np.random.default_rng(batch_size or 0)
    blocks = [{"a": rng.integers(0, 9, n), "b": rng.random(n)}
              for n in (5, 0, 3, 11, 1)]
    got = list(tblock.rebatch(iter(blocks), batch_size))
    want = list(rblock.rebatch(iter(blocks), batch_size))
    assert [len(b["a"]) for b in got] == [len(b["a"]) for b in want]
    for g, w in zip(got, want):
        for c in ("a", "b"):
            np.testing.assert_array_equal(g[c], w[c])
    rows = [{"u": 1, "v": 2.0}, {"u": 3, "v": 4.0}]
    assert _plain(tblock.block_to_rows(tblock.block_from_rows(rows))) == \
        _plain(rblock.block_to_rows(rblock.block_from_rows(rows)))


def test_stats_report_matches_reference_layout():
    from ray_tpu.data.stats import DatasetStats as RStats
    from ray_tpu_torch.data.stats import DatasetStats as TStats

    lines = []
    for cls in (TStats, RStats):
        st = cls()
        st.record_op(0, "read", 0.5, 100, 800)
        st.record_op(1, "double_x", 0.25, 100, 800)
        st.record_wait(0.125)
        st.total_wall_s = 1.0
        lines.append(st.summary_string())
        assert st.to_dict()["compute_s"] == 0.75
    assert lines[0] == lines[1]


@pytest.mark.parametrize("hidden,call", [
    ("pyarrow", lambda d, p: d.read_parquet(p)),
    ("pyarrow", lambda d, p: d.read_csv(p)),
    ("pandas", lambda d, p: d.from_pandas(None)),
    ("pandas", lambda d, p: d.range(4).to_pandas()),
    ("pandas", lambda d, p: d.range(4).write_csv(p)),
    ("pyarrow", lambda d, p: d.range(4).write_parquet(p)),
], ids=["read_parquet", "read_csv", "from_pandas", "to_pandas",
        "write_csv", "write_parquet"])
def test_io_without_pandas_or_pyarrow_names_the_package(
        hidden, call, tmp_path, monkeypatch):
    """The card's machine has neither pandas nor pyarrow: each IO call
    that needs one raises an ImportError that names it; read_json and the
    numpy sources work."""
    (tmp_path / "f.csv").write_text("a\n1\n")
    for name in list(sys.modules):
        if name == hidden or name.startswith(hidden + "."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, hidden, None)
    with pytest.raises(ImportError, match=hidden):
        call(tdata, str(tmp_path / "f.csv"))
    assert tdata.from_numpy({"a": np.arange(3)}).count() == 3
    (tmp_path / "r.jsonl").write_text('{"x": 1}\n')
    assert tdata.read_json(str(tmp_path / "r.jsonl")).count() == 1


def test_exports_match_the_reference():
    import ray_tpu.data
    import ray_tpu.util
    import ray_tpu_torch.data
    import ray_tpu_torch.util
    from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401

    assert ray_tpu_torch.data.__all__ == ray_tpu.data.__all__
    swap = {"to_jax": "to_torch",
            "tpu_slice_placement_group": "gpu_gang_placement_group"}
    assert ray_tpu_torch.util.__all__ == [swap.get(n, n)
                                          for n in ray_tpu.util.__all__]
    for name in ray_tpu_torch.data.__all__ + ray_tpu_torch.util.__all__:
        assert hasattr(ray_tpu_torch.data, name) or \
            hasattr(ray_tpu_torch.util, name)


def test_num_gpus_takes_num_tpus_place():
    from ray_tpu_torch.data.actor_compute import ActorPoolStage

    stage = ActorPoolStage(h.AddConst, concurrency=(1, 3), num_gpus=0.5)
    assert (stage.min_actors, stage.max_actors, stage.num_gpus) == \
        (1, 3, 0.5)
    with pytest.raises(TypeError):
        ActorPoolStage(h.AddConst, num_tpus=1)
    with pytest.raises(ValueError, match="concurrency"):
        ActorPoolStage(h.AddConst, concurrency=(3, 1))
