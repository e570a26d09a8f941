"""The port's `Queue` (`ray_tpu_torch/util/queue.py`), `Pool`
(`util/multiprocessing.py`) and state API (`util/state.py`): the
reference's tests of them (`test_util_apis.py`, `test_workflow_mp.py`,
`test_observability.py`) on the port's in-process runtime and on its
cluster, one after the other (a module-scoped fixture parametrized over
both: the runtime is one a process).

What the tests send to workers lives in `tests/torch_rllib_helpers.py`:
the port sends functions and classes by reference, so a lambda is
refused with a `TypeError` that names the rule. On local mode, where the
reference keeps no actor table and no object store, the port's state
API answers what the reference's does there (the reference's own local
mode runs beside it in this process for the task events).
"""

import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_rllib_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402

# Every get in this file.
TIMEOUT_S = 120
# The workers' task-event flush interval, and a margin.
FLUSH_S = 1.5


@pytest.fixture(scope="module", params=["local", "cluster"])
def runtime(request):
    if request.param == "local":
        ray_tpu_torch.init(local_mode=True)
    else:
        niced(lambda: ray_tpu_torch.init(num_cpus=4))
    try:
        yield request.param
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# Queue (reference: test_util_apis.py)
# ---------------------------------------------------------------------------
def test_queue_fifo_and_timeout(runtime):
    from ray_tpu_torch.util.queue import Empty, Queue

    q = Queue(maxsize=4)
    for i in range(3):
        q.put(i)
    assert q.qsize() == 3
    assert [q.get(timeout=TIMEOUT_S) for _ in range(3)] == [0, 1, 2]
    assert q.empty()
    with pytest.raises(Empty):
        q.get(block=False)
    t0 = time.monotonic()
    with pytest.raises(Empty):
        q.get(timeout=0.3)
    assert time.monotonic() - t0 >= 0.25
    q.shutdown()


def test_queue_maxsize_full(runtime):
    from ray_tpu_torch.util.queue import Full, Queue

    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Full):
        q.put(3, block=False)
    with pytest.raises(Full):
        q.put(3, timeout=0.2)
    assert q.full()
    assert q.get(timeout=TIMEOUT_S) == 1
    q.put(3, timeout=TIMEOUT_S)
    q.shutdown()


def test_queue_batches_and_numpy_items(runtime):
    from ray_tpu_torch.util.queue import Queue

    q = Queue(maxsize=5)
    assert q.put_nowait_batch(list(range(7))) == 5
    assert q.size() == 5
    assert q.get_nowait_batch(3) == [0, 1, 2]
    assert q.get_nowait() == 3
    arr = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    q.put_nowait(arr)
    assert q.get(timeout=TIMEOUT_S) == 4
    np.testing.assert_array_equal(q.get(timeout=TIMEOUT_S), arr)
    q.shutdown()


# ---------------------------------------------------------------------------
# Pool (reference: test_workflow_mp.py test_multiprocessing_pool)
# ---------------------------------------------------------------------------
def test_multiprocessing_pool(runtime):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as pool:
        assert pool.map(helpers.square, range(10)) == \
            [x * x for x in range(10)]
        assert pool.apply(helpers.add, (3, 4)) == 7
        r = pool.apply_async(helpers.ninety_nine)
        assert r.get(timeout=60) == 99
        assert r.ready() and r.successful()
        assert pool.starmap(helpers.mul, [(2, 3), (4, 5)]) == [6, 20]
        assert list(pool.imap(helpers.plus_one, range(5))) == \
            [1, 2, 3, 4, 5]
        assert sorted(pool.imap_unordered(helpers.plus_one, range(5))) == \
            [1, 2, 3, 4, 5]
        assert pool.map_async(helpers.square, range(4), chunksize=3).get(
            timeout=TIMEOUT_S) == [0, 1, 4, 9]
    with pytest.raises(ValueError):
        pool.map(helpers.identity, [1])
    pool.close()
    pool.join()


@pytest.mark.parametrize("call", ["map", "apply", "starmap", "init"])
def test_pool_refuses_a_lambda(runtime, call):
    from ray_tpu_torch.util.multiprocessing import Pool

    with pytest.raises(TypeError, match="module-level"):
        if call == "init":
            Pool(2, initializer=lambda: None)
        pool = Pool(2)
        if call == "map":
            pool.map(lambda x: x, [1])
        elif call == "apply":
            pool.apply(lambda: 1)
        else:
            pool.starmap(lambda a, b: a, [(1, 2)])


# ---------------------------------------------------------------------------
# The state API (reference: test_observability.py)
# ---------------------------------------------------------------------------
def _reference_local(body):
    """`body(ray_tpu)` on the reference's local mode, in this process."""
    import ray_tpu

    ray_tpu.init(local_mode=True)
    try:
        return body(ray_tpu)
    finally:
        ray_tpu.shutdown()


def _run_tasks(rt):
    f = rt.remote(helpers.work)
    rt.get([f.remote(i) for i in range(3)], timeout=TIMEOUT_S)
    g = rt.remote(helpers.fail)
    with pytest.raises(ValueError):
        rt.get(g.remote(), timeout=60)


def test_list_tasks_and_summary(runtime):
    from ray_tpu_torch.util.state import list_tasks, summarize_tasks

    _run_tasks(ray_tpu_torch)
    time.sleep(FLUSH_S)
    tasks = list_tasks()
    work = [t for t in tasks if t["name"].endswith("work")]
    failed = [t for t in tasks if t["name"].endswith("fail")]
    assert len([t for t in work if t["state"] == "FINISHED"]) >= 3
    assert any(t["state"] == "FAILED" for t in failed)
    summary = summarize_tasks()
    assert sum(v.get("FINISHED", 0) for k, v in summary.items()
               if k.endswith("work")) >= 3
    detailed = list_tasks(detail=True)
    assert all(t["events"] for t in detailed)
    if runtime == "local":
        def reference(rt):
            from ray_tpu.util.state import list_tasks as ref_list

            _run_tasks(rt)
            return ref_list()

        want = _reference_local(reference)
        assert {k for t in want for k in t} <= {k for t in tasks for k in t}
        assert sorted((t["name"], t["state"]) for t in want
                      if t["name"].endswith(("work", "fail"))) == \
            sorted((t["name"], t["state"]) for t in work + failed)


def test_list_actors_and_nodes(runtime):
    from ray_tpu_torch.util.state import list_actors, list_nodes

    a = ray_tpu_torch.remote(helpers.Pinger).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=TIMEOUT_S) == "pong"
    actors = list_actors()
    nodes = list_nodes()
    assert any(n["Alive"] for n in nodes)
    if runtime == "cluster":
        pingers = [x for x in actors if x.get("class_name") == "Pinger"]
        assert any(x.get("state") == "ALIVE" for x in pingers)
        ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                x.get("state") == "ALIVE" for x in list_actors()
                if x.get("class_name") == "Pinger"):
            time.sleep(0.1)
        assert not any(x.get("state") == "ALIVE" for x in list_actors()
                       if x.get("class_name") == "Pinger")
    else:
        # Local mode keeps no actor table: the reference's answer there.
        from ray_tpu.util.state import list_actors as ref_list_actors

        assert actors == _reference_local(lambda rt: ref_list_actors()) \
            == []
        ray_tpu_torch.kill(a)


def test_list_objects_shows_resident(runtime):
    from ray_tpu_torch.util.state import list_objects

    ref = ray_tpu_torch.put(np.zeros(2_000_000, np.float32))  # 8 MB
    objs = list_objects()
    if runtime == "cluster":
        assert any(o["size"] >= 8_000_000 for o in objs)
    else:
        # No object store in process: the reference's answer there.
        from ray_tpu.util.state import list_objects as ref_list_objects

        assert objs == _reference_local(lambda rt: ref_list_objects()) == []
    del ref


def test_actor_task_events(runtime):
    from ray_tpu_torch.util.state import list_tasks

    def hits(rt, list_tasks):
        b = rt.remote(helpers.Hitter).remote()
        rt.get([b.hit.remote() for _ in range(3)], timeout=TIMEOUT_S)
        time.sleep(FLUSH_S)
        return b, [t for t in list_tasks() if t["name"] == "Hitter.hit"]

    b, tasks = hits(ray_tpu_torch, list_tasks)
    if runtime == "cluster":
        assert len([t for t in tasks if t["state"] == "FINISHED"]) >= 3
    else:
        # Local mode records no events for actor methods: the
        # reference's answer there.
        from ray_tpu.util.state import list_tasks as ref_list_tasks

        want = _reference_local(lambda rt: hits(rt, ref_list_tasks)[1])
        assert tasks == want == []
    ray_tpu_torch.kill(b)


def test_node_stats_and_placement_groups(runtime):
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    from ray_tpu_torch.util.state import (list_nodes, list_placement_groups,
                                          node_stats)

    if runtime == "local":
        assert list_placement_groups() == []
        return
    pg = placement_group([{"CPU": 1}])
    assert pg.wait(timeout_seconds=60)
    try:
        assert any(p.get("state") == "CREATED"
                   for p in list_placement_groups())
        address = list_nodes()[0]["NodeManagerAddress"]
        stats = node_stats(address)
        assert stats["node_id"] == list_nodes()[0]["NodeID"]
    finally:
        remove_placement_group(pg)
