"""The port's lazy DAG (`ray_tpu_torch.dag`, `.bind` on remote functions,
actor classes, actor methods and `options(...)`) against the JAX package's
`ray_tpu.dag` on the same graphs and inputs: in local mode both in this
process, and on the cluster, the port's in this process and the
reference's in a child interpreter (`python tests/torch_cgraph_helpers.py
ray_tpu dag`, one JSON line). The graphs and what they send to workers
live in `tests/torch_cgraph_helpers.py`.
"""

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cgraph_helpers as h  # noqa: E402
from torch_cluster_helpers import (CHILD_TIMEOUT_S,  # noqa: E402,F401
                                   NICENESS, ROOT, niced,
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402

pytestmark = pytest.mark.unit

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)


def run_reference(what: str) -> dict:
    """The reference's results of `what`, from a child interpreter. Its
    output goes to files, not pipes: a process the child's cluster leaves
    behind would hold a pipe open, and reading it to its end would wait
    on that process."""
    import json
    import tempfile

    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.run(
            ["nice", "-n", str(NICENESS), sys.executable,
             os.path.join(HERE, "torch_cgraph_helpers.py"), "ray_tpu", what],
            stdin=subprocess.DEVNULL, stdout=out, stderr=err,
            timeout=CHILD_TIMEOUT_S, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT))
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"reference child ({what}) exited {proc.returncode}:\n"
        f"{stdout[-2000:]}\n{stderr[-4000:]}")
    return json.loads(lines[-1])


def _jsonable(value):
    import json

    return json.loads(json.dumps(value))


@pytest.fixture(scope="module")
def local_results():
    """dag_scenarios in local mode: (reference's, port's)."""
    ray_tpu.init(local_mode=True, ignore_reinit_error=True)
    try:
        ref = h.dag_scenarios(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        port = h.dag_scenarios(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    return _jsonable(ref), _jsonable(port)


@pytest.fixture(scope="module")
def cluster_results():
    """dag_scenarios on the clusters: the reference's from a child
    interpreter, the port's here."""
    future = _POOL.submit(run_reference, "dag")
    niced(lambda: ray_tpu_torch.init(num_cpus=4))
    try:
        port = h.dag_scenarios(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    return future.result(), _jsonable(port)


SCENARIOS = ["functions", "kwargs_node", "class_node", "multi_output",
             "handle_methods", "error", "bad_channel", "empty_multi"]


@pytest.mark.parametrize("key", SCENARIOS)
def test_lazy_execute_equals_reference_in_local_mode(local_results, key):
    ref, port = local_results
    assert port[key] == ref[key]


@pytest.mark.parametrize("key", SCENARIOS)
def test_lazy_execute_equals_reference_on_the_cluster(cluster_results, key):
    ref, port = cluster_results
    assert port[key] == ref[key]


def test_lazy_results_are_the_expected_values(local_results):
    _, port = local_results
    assert port["functions"] == [9, 13, 34]
    assert port["kwargs_node"] == 18.0
    assert port["class_node"] == [14, 18, 22]
    assert port["multi_output"] == [[4, 5, 1], 16]
    assert port["handle_methods"] == [201, 202]
    assert port["error"] == "RayTaskError(ValueError)"
    assert port["bad_channel"] == port["empty_multi"] == "ValueError"


def _node_kinds(pkg):
    """(node class name, bound args, options type) of each bind form."""
    dag = __import__(f"{pkg.__name__}.dag", fromlist=["x"])
    fn = pkg.remote(h.square)
    cls = pkg.remote(h.Acc)
    nodes = {
        "function": fn.bind(3),
        "function_options": fn.options(num_cpus=2).bind(4),
        "class": cls.bind(5),
        "class_options": cls.options(max_restarts=1).bind(6),
        "class_method": cls.bind(7).push.bind(8),
    }
    out = {}
    for name, node in nodes.items():
        opts = getattr(node, "_options", None)
        out[name] = (type(node).__name__,
                     [a for a in node._bound_args
                      if not isinstance(a, dag.DAGNode)],
                     type(opts).__name__ if opts is not None else None,
                     getattr(opts, "num_cpus", None),
                     getattr(opts, "max_restarts", None))
    return out


def test_bind_builds_the_reference_nodes():
    """No runtime needed: `.bind` only builds nodes."""
    assert _node_kinds(ray_tpu_torch) == _node_kinds(ray_tpu)


def test_bind_on_a_live_actor_method_and_its_options():
    ray_tpu_torch.init(local_mode=True)
    try:
        from ray_tpu_torch.dag import ClassMethodNode, InputNode

        actor = ray_tpu_torch.remote(h.Stage).remote(5)
        with InputNode() as inp:
            node = actor.add.options(num_returns=1).bind(
                actor.add.bind(inp))
        assert isinstance(node, ClassMethodNode)
        assert node._options.num_returns == 1
        assert ray_tpu_torch.get(node.execute(1), timeout=60) == 11
        assert node.with_channel("array") is node
        assert node._channel_kind == "array"
        with pytest.raises(ValueError):
            node.with_channel("gpu")
    finally:
        ray_tpu_torch.shutdown()


def test_a_lazy_run_carries_torch_tensors_as_the_reference_carries_numpy():
    """The same graph with a tensor input: the port's tensors (through the
    object store between the actors) hold the reference's numpy values."""
    import torch

    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    results = []
    for pkg, value in ((ray_tpu, x), (ray_tpu_torch, torch.from_numpy(x))):
        pkg.init(local_mode=True, **({"ignore_reinit_error": True}
                                     if pkg is ray_tpu else {}))
        try:
            from importlib import import_module

            InputNode = import_module(f"{pkg.__name__}.dag").InputNode
            T = pkg.remote(h.Tensor)
            a, b = T.remote(), T.remote()
            with InputNode() as inp:
                dag = b.plus.bind(a.scale.bind(inp))
            results.append(pkg.get(dag.execute(value), timeout=60))
        finally:
            pkg.shutdown()
    want, got = results
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
