"""The port's actor-pool map stage (`map_batches(..., compute="actors")`,
`data/actor_compute.py`, `util/actor_pool.py`) on its cluster runtime,
against the JAX package's on the same inputs: the reference's
tests/test_data_actor_pool.py case by case. The reference's stage runs its
callable in this process when `ray_tpu` is not initialised (one replica,
the same blocks in the same order), so its rows are the cluster's. The
port's cluster starts once for the module, with two GPUs faked on the CPU
for `num_gpus` leases.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_data_helpers as h  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu import data as rdata  # noqa: E402
from ray_tpu_torch import data as tdata  # noqa: E402

pytestmark = pytest.mark.unit


@pytest.fixture(scope="module")
def port_cluster():
    assert not ray_tpu.is_initialized()
    niced(lambda: ray_tpu_torch.init(num_cpus=4, num_gpus=2))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _blocks(ds):
    return list(ds.iter_blocks())


def test_actor_pool_map_batches_order_and_results(port_cluster):
    got = _blocks(tdata.range(200).map_batches(h.double_x).map_batches(
        h.AddConst, compute="actors", concurrency=2,
        fn_constructor_args=(7,)))
    want = _blocks(rdata.range(200).map_batches(h.double_x).map_batches(
        h.AddConst, compute="actors", concurrency=2,
        fn_constructor_args=(7,)))
    x = np.concatenate([b["x"] for b in got])
    np.testing.assert_array_equal(x, np.concatenate([b["x"] for b in want]))
    np.testing.assert_array_equal(x, np.arange(200) * 2 + 7)  # in order
    assert len({int(p) for b in got for p in b["pid"]}) == 2


def test_actor_pool_autoscales_within_range(port_cluster):
    got = _blocks(tdata.range(64).map_batches(h.id_as_x).map_batches(
        h.AddConst, compute="actors", concurrency=(1, 3),
        fn_constructor_args=(1,)))
    x = np.concatenate([b["x"] for b in got])
    np.testing.assert_array_equal(x, np.arange(64) + 1)
    assert 1 <= len({int(p) for b in got for p in b["pid"]}) <= 3


def test_actor_pool_plain_function(port_cluster):
    out = tdata.range(50).map_batches(h.plus_100, compute="actors",
                                      concurrency=2)
    want = rdata.range(50).map_batches(h.plus_100, compute="actors",
                                       concurrency=2)
    got = [int(r["id"]) for r in out.take_all()]
    assert got == [int(r["id"]) for r in want.take_all()] == \
        list(range(100, 150))


def test_post_stage_transform_applies(port_cluster):
    def plan(d):
        return (d.range(30).map_batches(h.id_as_x)
                .map_batches(h.AddConst, compute="actors", concurrency=1,
                             fn_constructor_args=(0,))
                .map_batches(h.times_ten))

    got = np.concatenate([b["x"] for b in plan(tdata).iter_blocks()])
    want = np.concatenate([b["x"] for b in plan(rdata).iter_blocks()])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(30) * 10)


def test_flagship_batch_inference_via_actor_pool(port_cluster):
    """The port's scorer (`TinyScorer`, the twin of the reference's
    FlagshipScorer at its widths, from the same JAX weights) through a
    pool of 2 replicas, against the reference's FlagshipScorer (JAX, in
    this process) on the same blocks: within 1e-5 relative (float32 on
    both sides; the two frameworks sum in different orders)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import TransformerConfig, init_params
    from test_data_actor_pool import FlagshipScorer

    cfg = TransformerConfig(dtype=jnp.float32, **h.TINY)
    np_params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                     cfg))
    rng = np.random.default_rng(0)
    blocks = [{"tokens": rng.integers(0, 128, (4, 16)).astype(np.int32)}
              for _ in range(6)]
    scored = tdata.from_blocks(blocks).map_batches(
        h.TinyScorer, compute="actors", concurrency=2,
        fn_constructor_args=(np_params,))
    out = [b["score"] for b in scored.iter_blocks()]
    assert len(out) == 6 and all(s.shape == (4,) for s in out)
    jax_scorer = FlagshipScorer()
    for blk, got in zip(blocks, out):
        want = jax_scorer(blk)["score"]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_half_gpu_replicas_share_one_card(port_cluster):
    """`num_gpus` takes the reference's `num_tpus`: two replicas leasing
    0.5 each share one card id, and the pool's processes are gone after
    the stage."""
    got = _blocks(tdata.range(40).map_batches(h.id_as_x).map_batches(
        h.AddConst, compute="actors", concurrency=2, num_gpus=0.5,
        fn_constructor_args=(0,)))
    visible = {int(v) for b in got for v in b["visible"]}
    pids = {int(p) for b in got for p in b["pid"]}
    assert len(visible) == 1 and visible <= {0, 1} and len(pids) == 2
    import time

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{p}") for p in pids):
        time.sleep(0.1)
    assert not any(os.path.exists(f"/proc/{p}") for p in pids)


def test_iter_torch_batches_on_the_cluster(port_cluster):
    """The reference's test_iter_jax_batches_places_on_device: batches as
    tensors (on the CPU here), equal to iter_jax_batches'."""
    import torch

    got = list(tdata.range(40).map_batches(
        h.id_as_float_x).iter_torch_batches(batch_size=10, device="cpu"))
    want = list(rdata.range(40).map_batches(
        h.id_as_float_x).iter_jax_batches(batch_size=10))
    assert len(got) == len(want) == 4
    assert all(isinstance(b["x"], torch.Tensor) for b in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))


def test_actor_pool_stats_per_replica_timing(port_cluster):
    ds = tdata.range(64, parallelism=8).map_batches(h.id_as_x).map_batches(
        h.AddConst, compute="actors", concurrency=2,
        fn_constructor_args=(1,))
    got = np.concatenate([b["x"] for b in ds.iter_blocks()])
    assert sorted(got.tolist()) == list(range(1, 65))
    stats = ds.stats()
    names = [o.name for o in stats.operators]
    per_replica = [n for n in names
                   if n.startswith("actor_pool_map[replica=")]
    assert sorted(per_replica) == ["actor_pool_map[replica=0]",
                                   "actor_pool_map[replica=1]"]
    assert sum(o.rows for o in stats.operators
               if o.name in per_replica) == 64
    assert all(stats.op(n).wall_s > 0 for n in per_replica)
    assert "actor_pool_map" in names
    assert "actor_pool_map[replica=" in stats.summary_string()


def test_actor_pool_api(port_cluster):
    """`util/actor_pool.py`, the reference's surface: `map` in submission
    order, `map_unordered` in completion order, a backlog past the idle
    actors, `get_next` with a timeout that leaves the result retrievable,
    `push` and `pop_idle`."""
    from ray_tpu_torch.util.actor_pool import ActorPool

    cls = ray_tpu_torch.remote(num_cpus=0)(h.Doubler)
    actors = [cls.remote() for _ in range(2)]
    pool = ActorPool(actors)
    assert list(pool.map(lambda a, v: a.double.remote(v), range(6))) == \
        [0, 2, 4, 6, 8, 10]
    got = list(pool.map_unordered(
        lambda a, v: a.double.remote(v, 0.4 if v == 0 else 0.0), range(4)))
    assert sorted(got) == [0, 2, 4, 6] and got[-1] == 0
    pool.submit(lambda a, v: a.double.remote(v, 1.0), 21)
    with pytest.raises(TimeoutError):
        pool.get_next(timeout=0.05)
    assert pool.has_next() and pool.get_next(timeout=30) == 42
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()
    idle = pool.pop_idle()
    assert idle is not None
    pool.push(idle)
    with pytest.raises(ValueError):
        ActorPool([])
    for a in actors:
        ray_tpu_torch.kill(a)
