"""The port's ingest half of the device data plane
(`ray_tpu_torch.util.device_arrays`: `to_torch`, `get_to_device`, and the
batches `Dataset.iter_torch_batches` places) against the JAX package's
`to_jax` and `Dataset.iter_jax_batches` on the same numpy inputs, without
a runtime. With `mesh=`, on 2 and 4 gloo ranks (`tests/torch_dist.py
run_ranks`): each rank's local rows are its `split_for_workers` shard and
the DTensor's full tensor their concatenation in rank order, against the
reference's shards of the same plan.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_data_helpers as h  # noqa: E402
from torch_dist import run_ranks  # noqa: E402

import jax  # noqa: E402
import torch  # noqa: E402
from ray_tpu import data as rdata  # noqa: E402
from ray_tpu.util import to_jax  # noqa: E402
from ray_tpu_torch import data as tdata  # noqa: E402
from ray_tpu_torch.util import to_torch  # noqa: E402

pytestmark = pytest.mark.unit


def _plan(d):
    return d.range(103, parallelism=5).map_batches(h.id_as_float_x)


@pytest.mark.parametrize("batch_size,drop_last", [
    (10, False), (10, True), (64, False), (None, False), (1, False)])
def test_iter_torch_batches_equals_iter_jax_batches(batch_size, drop_last):
    got = list(_plan(tdata).iter_torch_batches(
        batch_size=batch_size, drop_last=drop_last, device="cpu"))
    want = list(_plan(rdata).iter_jax_batches(
        batch_size=batch_size, drop_last=drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor)
        assert g["x"].dtype == torch.float32
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))


def test_dtypes_apply_as_the_reference():
    """A column's dtype (torch, or numpy as the reference takes) is
    applied on the host before the copy."""
    got = list(tdata.range(20).iter_torch_batches(
        batch_size=8, device="cpu",
        dtypes={"id": torch.float16}))
    got_np = list(tdata.range(20).iter_torch_batches(
        batch_size=8, device="cpu", dtypes={"id": np.int32}))
    want = list(rdata.range(20).iter_jax_batches(
        batch_size=8, dtypes={"id": np.float16}))
    for g, n, w in zip(got, got_np, want):
        assert g["id"].dtype == torch.float16 and n["id"].dtype == torch.int32
        np.testing.assert_array_equal(g["id"].numpy(), np.asarray(w["id"]))


def test_to_torch_matches_to_jax():
    arr = np.random.default_rng(0).random((4, 5)).astype(np.float32)
    t = to_torch(arr, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(to_jax(arr)))
    assert t.data_ptr() == arr.ctypes.data          # writable: aliased
    ro = arr.copy()
    ro.flags.writeable = False
    t2 = to_torch(ro, device="cpu")
    assert t2.data_ptr() != ro.ctypes.data           # read-only: copied
    strided = np.arange(12).reshape(3, 4)[:, ::2]
    np.testing.assert_array_equal(to_torch(strided, device="cpu").numpy(),
                                  np.asarray(to_jax(strided)))
    tt = torch.arange(3)
    assert to_torch(tt, device="cpu") is tt


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_torch(np.zeros(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.range(4).iter_torch_batches(batch_size=2))


def _ref_shards(world):
    ds = rdata.from_numpy({"x": h.mesh_rows(),
                           "i": np.arange(h.MESH_ROWS)},
                          parallelism=h.MESH_BLOCKS)
    return ds.split_for_workers(world)


@pytest.mark.parametrize("world,batch_size", [(2, 4), (4, 2), (2, 5)])
def test_mesh_batches_are_dtensors_of_each_ranks_shard(world, batch_size):
    """Each rank's local block is its shard's rows (the reference's
    `split_for_workers` shard of the same plan, batched alike); the
    DTensor is Shard(0) on dp and its full tensor the ranks' local rows
    concatenated in rank order (the counterpart of
    `make_array_from_process_local_data`). A short final batch (5, 5, 5,
    5, 5, 3 rows of 28 at batch size 5) comes back unsharded."""
    results = run_ranks(h.mesh_rank_batches, world, batch_size)
    shards = _ref_shards(world)
    want = [[b["x"] for b in s.iter_batches(batch_size=batch_size)]
            for s in shards]
    for rank in range(world):
        assert len(results[rank]) == len(want[rank])
        for got, w in zip(results[rank], want[rank]):
            np.testing.assert_array_equal(got["local"], w)
    n = min(len(r) for r in results)
    sharded = 0
    for j in range(n):
        batch = [results[r][j] for r in range(world)]
        if batch[0]["full"] is None:
            assert all(b["full"] is None for b in batch)
            continue
        sharded += 1
        cat = np.concatenate([b["local"] for b in batch])
        for b in batch:
            np.testing.assert_array_equal(b["full"], cat)
            assert b["placements"] == ["shard0"] + ["replicate"] * 3
    assert sharded >= 1
    short = [results[r][-1] for r in range(world)]
    assert all((b["full"] is None) == (len(b["local"]) < batch_size)
               for b in short)
