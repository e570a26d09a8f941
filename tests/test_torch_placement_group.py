"""Placement groups in the port (`ray_tpu_torch/core/pg_scheduler.py`, the
raylet's bundle 2PC, the GCS's table, `ray_tpu_torch/util/
placement_group.py`) against the JAX package's.

The strategies' node choice is held to `ray_tpu.core.pg_scheduler.
select_pg_nodes` on the same node tables (the port has no multi-node
cluster on one machine), with the reference's TPU chips as the port's
GPUs. The 2PC runs on a one-node port cluster that declares two GPUs
(faked on the CPU): bundles take GPU ids from the pool leases use, a
lease inside a bundle sees that bundle's ids, and a removed group gives
them back. The local mode's four calls are held to the reference's local
mode. The cluster starts once for the module.
"""

import os
import sys
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
import torch_train_helpers as train_helpers  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu.core.pg_scheduler as jax_pg  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.core.pg_scheduler as port_pg  # noqa: E402
from ray_tpu_torch.util import (gpu_gang_placement_group,  # noqa: E402
                                placement_group, placement_group_table,
                                remove_placement_group)

pytestmark = pytest.mark.unit

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


# ---------------------------------------------------------------------------
# Node choice against the reference
# ---------------------------------------------------------------------------
def _as_reference(table):
    """The port's GPUs as the reference's TPU chips."""
    return {("TPU" if k == "GPU" else k): v for k, v in table.items()}


_NODES = st.lists(st.fixed_dictionaries({
    "cpu": st.sampled_from([0.0, 0.5, 1.0, 2.0, 4.0]),
    "gpu": st.integers(0, 4),
    "stale": st.booleans()}), min_size=1, max_size=4)
_BUNDLES = st.lists(st.fixed_dictionaries({
    "CPU": st.sampled_from([0.0, 0.5, 1.0, 2.0]),
    "GPU": st.sampled_from([0.0, 1.0, 2.0])}).filter(
        lambda b: any(b.values())), min_size=1, max_size=4)


@settings(max_examples=300, deadline=None)
@given(nodes=_NODES, bundles=_BUNDLES, strategy=st.sampled_from(STRATEGIES),
       pin=st.booleans(), data=st.data())
def test_select_pg_nodes_matches_reference(nodes, bundles, strategy, pin,
                                           data):
    """Every strategy, feasible and infeasible tables, with and without
    pinned nodes: the port picks the reference's nodes (or neither
    fits)."""
    table = [{"node_id": f"n{i}", "address": f"127.0.0.1:{7000 + i}",
              "stale_view": n["stale"],
              "resources_available": {"CPU": n["cpu"],
                                      "GPU": float(n["gpu"])}}
             for i, n in enumerate(nodes)]
    targets = (data.draw(st.lists(st.sampled_from([n["node_id"]
                                                   for n in table]),
                                  min_size=len(bundles),
                                  max_size=len(bundles)))
               if pin else None)
    ref_table = [dict(n, resources_available=_as_reference(
        n["resources_available"])) for n in table]
    want = jax_pg.select_pg_nodes([_as_reference(b) for b in bundles],
                                  ref_table, strategy, targets)
    got = port_pg.select_pg_nodes(bundles, table, strategy, targets)
    if want is None:
        assert got is None
    else:
        assert [n["node_id"] for n in got] == [n["node_id"] for n in want]


@pytest.mark.parametrize("bundles,strategy", [
    ([{"CPU": 1}], "BEST"), ([], "PACK"), ([{"CPU": 1}, {}], "SPREAD"),
    (None, "STRICT_PACK")])
def test_validate_pg_args_refusals_match_reference(bundles, strategy):
    with pytest.raises(ValueError) as want:
        jax_pg.validate_pg_args(bundles, strategy)
    with pytest.raises(ValueError) as got:
        port_pg.validate_pg_args(bundles, strategy)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Local mode (runs before the module's cluster starts)
# ---------------------------------------------------------------------------
def _local_calls(pkg):
    pkg.init(local_mode=True, ignore_reinit_error=True)
    try:
        rt = pkg.core.worker.current_runtime()
        pg_id = rt.create_placement_group([{"CPU": 1}, {"CPU": 2}],
                                          strategy="SPREAD", name="g")
        row = dict(rt.placement_group_table(pg_id))
        waited = rt.placement_group_wait(pg_id, timeout=1)
        rt.remove_placement_group(pg_id)
        after = rt.placement_group_table(pg_id)["state"]
        everything = rt.placement_group_table()
        with pytest.raises(ValueError) as bad:
            rt.create_placement_group([{"CPU": 1}], strategy="NOPE")
        return {"row": {k: v for k, v in row.items() if k != "pg_id"},
                "id_len": len(pg_id), "waited": waited, "after": after,
                "listed": list(everything) == [pg_id],
                "bad": str(bad.value)}
    finally:
        pkg.shutdown()


def test_local_mode_placement_groups_match_reference():
    assert _local_calls(ray_tpu_torch) == _local_calls(ray_tpu)


# ---------------------------------------------------------------------------
# The one-node cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    rt = helpers.start(ray_tpu_torch)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _node_stats(rt):
    async def go():
        client = await rt._raylet_client(rt.raylet_address)
        return await client.call("node_stats", timeout=10)

    return rt._loop.run(go())


def _wait_gpus_free(rt, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        free = sorted(_node_stats(rt)["gpus_free"])
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.1)


def _wait_view_gpus(want, timeout=10.0):
    """The GCS's view of free GPUs (what `nodes()` shows), once it
    reads `want` or the timeout passes: raylet heartbeats carry it."""
    deadline = time.monotonic() + timeout
    while True:
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.1)


def _env(pg, index, n, kind="task"):
    opts = {"placement_group": pg, "placement_group_bundle_index": index,
            "num_gpus": n}
    if kind == "task":
        return ray_tpu_torch.get(
            ray_tpu_torch.remote(helpers.device_env).options(
                **opts).remote("CUDA_VISIBLE_DEVICES"), timeout=60)[0]
    holder = ray_tpu_torch.remote(helpers.DeviceHolder).options(
        **opts).remote()
    try:
        return ray_tpu_torch.get(holder.env.remote("CUDA_VISIBLE_DEVICES"),
                                 timeout=60)[0]
    finally:
        ray_tpu_torch.kill(holder)


@pytest.mark.parametrize("strategy", ["PACK", "STRICT_PACK"])
def test_bundles_own_gpu_ids_that_their_leases_see(cluster, strategy):
    """Each bundle reserves one GPU id from the node's pool; every task and
    actor leased in it, whole or half a GPU, sees that id and only it;
    removing the group gives both ids back."""
    assert _wait_gpus_free(cluster, [0, 1]) == [0, 1]
    pg = placement_group([{"CPU": 1, "GPU": 1}] * 2, strategy=strategy)
    assert pg.wait(10)
    assert placement_group_table(pg)["state"] == "CREATED"
    assert ray_tpu_torch.get(pg.ready(), timeout=30) is True
    bundles = _node_stats(cluster)["bundles"]
    ids = {int(k.rsplit(":", 1)[1]): b["gpu_ids"] for k, b in bundles.items()
           if k.startswith(pg.id)}
    assert sorted(ids) == [0, 1] and sorted(ids[0] + ids[1]) == [0, 1]
    assert _node_stats(cluster)["gpus_free"] == []
    for index in (0, 1):
        want = str(ids[index][0])
        seen = [_env(pg, index, 1), _env(pg, index, 1),
                _env(pg, index, 1, "actor"), _env(pg, index, 0.5),
                _env(pg, index, 0.5, "actor")]
        assert seen == [want] * 5
    remove_placement_group(pg)
    assert _wait_gpus_free(cluster, [0, 1]) == [0, 1]
    assert placement_group_table(pg)["state"] == "REMOVED"


def test_infeasible_group_fails_fast(cluster):
    for bundles, strategy in (([{"GPU": 1}] * 2, "STRICT_SPREAD"),
                              ([{"GPU": 3}], "PACK")):
        t0 = time.monotonic()
        pg = placement_group(bundles, strategy=strategy)
        assert pg.wait(10) is False
        assert time.monotonic() - t0 < 10
        assert placement_group_table(pg)["state"] == "INFEASIBLE"
    assert _wait_gpus_free(cluster, [0, 1]) == [0, 1]


def test_removed_group_fails_new_work_and_returns_ids(cluster):
    pg = placement_group([{"CPU": 1, "GPU": 1}])
    assert pg.wait(10)
    assert len(_node_stats(cluster)["gpus_free"]) == 1
    remove_placement_group(pg)
    assert _wait_gpus_free(cluster, [0, 1]) == [0, 1]
    t0 = time.monotonic()
    with pytest.raises(Exception, match="unusable"):
        _env(pg, 0, 1)
    assert time.monotonic() - t0 < 10


def test_gpu_gang_refuses_too_few_cards(cluster):
    assert _wait_view_gpus(2.0) == 2.0
    with pytest.raises(ValueError, match=r"3\.0 free GPU"):
        gpu_gang_placement_group(3)
    pg = gpu_gang_placement_group(2)
    try:
        assert pg.wait(10)
        assert _wait_view_gpus(0.0) == 0.0
        info = placement_group_table(pg)
        assert info["strategy"] == "STRICT_PACK"
        assert len({loc["node_id"] for loc in info["bundle_locations"]}) == 1
        with pytest.raises(ValueError, match="free GPUs by node"):
            gpu_gang_placement_group(1)
    finally:
        remove_placement_group(pg)
    assert _wait_gpus_free(cluster, [0, 1]) == [0, 1]


def test_group_of_a_dead_creator_is_returned(cluster):
    """A group created inside an actor (as Tune's trial actor creates its
    gang's) is removed when that actor dies, and the raylet's reconcile
    returns its GPU ids."""
    owner = ray_tpu_torch.remote(train_helpers.PgOwner).options(
        num_cpus=0).remote()
    pg_id = ray_tpu_torch.get(owner.make.remote(
        "ray_tpu_torch", [{"CPU": 1, "GPU": 1}]), timeout=60)
    assert placement_group_table(pg_id)["state"] == "CREATED"
    assert len(_node_stats(cluster)["gpus_free"]) == 1
    ray_tpu_torch.kill(owner)
    assert _wait_gpus_free(cluster, [0, 1], timeout=20) == [0, 1]
    assert placement_group_table(pg_id)["state"] == "REMOVED"
