"""The port's durable workflows (`ray_tpu_torch.workflow`) on its cluster
against the JAX package's `ray_tpu.workflow` (in local mode, in this
process) on the same DAGs: the counterparts of tests/test_workflow_mp.py's
two workflow tests, the same step ids (checkpoint file names) and the same
`get_status` dicts after a failed step and its resume, and a child
interpreter where `cloudpickle` (with msgpack and psutil) cannot be
imported that runs and resumes a workflow. The steps live in
`tests/torch_cgraph_helpers.py`: the port stores a workflow's DAG with its
code by reference.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cgraph_helpers as h  # noqa: E402
from torch_cluster_helpers import (CHILD_TIMEOUT_S,  # noqa: E402,F401
                                   ROOT, niced, no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import workflow  # noqa: E402

pytestmark = pytest.mark.cluster


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    """The port's cluster, its workers started with a workflow store of
    this module's (a task that runs a workflow reads the variable of its
    worker's environment)."""
    store = str(tmp_path_factory.mktemp("wf_cluster_store"))
    old = os.environ.get("RAY_TPU_WORKFLOW_STORAGE")
    os.environ["RAY_TPU_WORKFLOW_STORAGE"] = store
    try:
        niced(lambda: ray_tpu_torch.init(num_cpus=4))
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_WORKFLOW_STORAGE")
        else:
            os.environ["RAY_TPU_WORKFLOW_STORAGE"] = old
    try:
        yield store
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture()
def wf_storage(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", str(tmp_path / "store"))
    return tmp_path / "store"


def test_workflow_runs_and_resumes_from_checkpoints(port_cluster, wf_storage,
                                                    tmp_path):
    count_file = str(tmp_path / "executions.log")
    fetch_t = ray_tpu_torch.remote(h.wf_fetch)
    total_t = ray_tpu_torch.remote(h.wf_total)
    dag = total_t.bind(fetch_t.bind(count_file), count_file)

    assert workflow.run(dag, workflow_id="wf-basic") == 6
    status = workflow.get_status("wf-basic")
    assert status["status"] == "SUCCEEDED"
    assert len(status["steps_ran"]) == 2

    assert workflow.resume("wf-basic") == 6
    status2 = workflow.get_status("wf-basic")
    assert len(status2["steps_loaded"]) == 2
    assert status2["steps_ran"] == []
    with open(count_file) as f:
        assert sorted(f.read().strip().splitlines()) == ["fetch", "total"]

    assert any(w["workflow_id"] == "wf-basic" for w in workflow.list_all())
    workflow.delete("wf-basic")
    with pytest.raises(KeyError):
        workflow.get_status("wf-basic")


def test_workflow_failed_step_then_resume_completes(port_cluster,
                                                    wf_storage, tmp_path):
    flag = tmp_path / "now_works"
    dag = ray_tpu_torch.remote(h.wf_flaky).bind(
        ray_tpu_torch.remote(h.wf_good).bind(), str(flag))
    with pytest.raises(RuntimeError):
        workflow.run(dag, workflow_id="wf-flaky")
    assert workflow.get_status("wf-flaky")["status"] == "FAILED"

    flag.write_text("ok")
    assert workflow.resume("wf-flaky") == 20
    status = workflow.get_status("wf-flaky")
    assert len(status["steps_loaded"]) == 1
    assert len(status["steps_ran"]) == 1


def test_run_async_drives_the_workflow_from_a_task(port_cluster, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", port_cluster)
    log = str(tmp_path / "async.log")
    dag = ray_tpu_torch.remote(h.wf_total).bind(
        ray_tpu_torch.remote(h.wf_fetch).bind(log), log)
    ref = workflow.run_async(dag, workflow_id="wf-async")
    assert ray_tpu_torch.get(ref, timeout=120) == 6
    status = workflow.get_status("wf-async")
    assert status["status"] == "SUCCEEDED" and len(status["steps_ran"]) == 2
    assert workflow.resume("wf-async") == 6
    assert len(workflow.get_status("wf-async")["steps_loaded"]) == 2


@pytest.fixture(scope="module")
def both_flows(port_cluster, tmp_path_factory):
    """workflow_flows of the reference (local mode) and of the port (its
    cluster), each with the same paths, the store emptied between."""
    tmp = str(tmp_path_factory.mktemp("wf_flows"))
    old = os.environ.get("RAY_TPU_WORKFLOW_STORAGE")
    ray_tpu.init(local_mode=True, ignore_reinit_error=True)
    try:
        ref = h.workflow_flows(ray_tpu, tmp)
    finally:
        ray_tpu.shutdown()
    shutil.rmtree(os.path.join(tmp, "store"))
    try:
        port = h.workflow_flows(ray_tpu_torch, tmp)
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_WORKFLOW_STORAGE", None)
        else:
            os.environ["RAY_TPU_WORKFLOW_STORAGE"] = old
    return json.loads(json.dumps(ref)), json.loads(json.dumps(port)), tmp


FLOW_KEYS = ["basic_run", "basic_status", "basic_resume",
             "basic_resumed_status", "basic_log", "basic_listed",
             "basic_deleted", "flaky_first", "flaky_failed_status",
             "flaky_resume", "flaky_status", "three_first",
             "three_failed_status", "three_resume", "three_status",
             "three_files"]


@pytest.mark.parametrize("key", FLOW_KEYS)
def test_step_ids_and_statuses_equal_reference(both_flows, key):
    ref, port, _ = both_flows
    assert port[key] == ref[key]


def test_three_step_resume_loads_the_first_step(both_flows):
    _, port, _ = both_flows
    failed, done = port["three_failed_status"], port["three_status"]
    assert failed["status"] == "FAILED" and failed["error"] is True
    assert done["status"] == "SUCCEEDED" and done["error"] is None
    assert [s.split("-")[0] for s in failed["steps_ran"]] == ["wf_good"]
    assert [s.split("-")[0] for s in done["steps_loaded"]] == ["wf_good"]
    assert [s.split("-")[0] for s in done["steps_ran"]] == [
        "wf_flaky", "wf_report"]
    assert port["three_resume"] == {"value": 20, "double": 40}
    assert port["three_files"] == sorted(
        ["dag.pkl", "meta.pkl"] + [f"{s}.pkl" for s in
                                   done["steps_loaded"] + done["steps_ran"]])


_NO_CLOUDPICKLE = """
import json, sys
for name in ("cloudpickle", "msgpack", "psutil", "jax", "ray_tpu"):
    sys.modules[name] = None
sys.path[:0] = [{here!r}, {root!r}]
import ray_tpu_torch
import torch_cgraph_helpers as h
ray_tpu_torch.init(local_mode=True)
try:
    out = h.workflow_flows(ray_tpu_torch, {tmp!r})
finally:
    ray_tpu_torch.shutdown()
print(json.dumps(out), flush=True)
"""


def test_workflows_run_and_resume_without_cloudpickle(both_flows):
    """In an interpreter where cloudpickle, msgpack, psutil, jax and
    ray_tpu cannot be imported, the port's workflows (same paths, the
    store emptied) give the statuses and step ids they give here."""
    _, port, tmp = both_flows
    shutil.rmtree(os.path.join(tmp, "store"))
    script = _NO_CLOUDPICKLE.format(here=HERE, root=ROOT, tmp=tmp)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, proc.stderr[-4000:]
    child = json.loads(lines[-1])
    assert child == port
