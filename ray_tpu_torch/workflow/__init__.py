"""ray_tpu_torch.workflow — durable DAG execution with resume, the port of
`ray_tpu/workflow/__init__.py`.

Reference equivalent: `python/ray/workflow/` (`workflow_executor.py` +
`workflow_storage.py`): run a lazy DAG where every step's result is
checkpointed to storage under a deterministic step id; re-running (or
`workflow.resume`) after a crash loads finished steps from storage and
executes only what's missing.

    import ray_tpu_torch
    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def fetch(): ...
    @ray_tpu_torch.remote
    def train(data): ...

    dag = train.bind(fetch.bind())
    workflow.run(dag, workflow_id="exp1")     # executes both steps
    workflow.resume("exp1")                   # replays from storage

The stored DAG (`dag.pkl`) and each step's checkpoint are written with
the port's own pickler (`core/serialization.dumps`), which sends code by
reference: a workflow's functions must be module-level, as a Dataset's
are. Nothing here needs cloudpickle. The step ids, the storage layout and
`RAY_TPU_WORKFLOW_STORAGE` are the reference's.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode

_STORAGE_ENV = "RAY_TPU_WORKFLOW_STORAGE"

__all__ = ["run", "run_async", "resume", "get_status", "list_all",
           "delete"]


def _storage_root() -> str:
    """`RAY_TPU_WORKFLOW_STORAGE`, else `ray_tpu_workflows` in the
    temporary directory (the reference's `/tmp/ray_tpu_workflows` where
    TMPDIR is unset)."""
    return os.environ.get(_STORAGE_ENV) or os.path.join(
        tempfile.gettempdir(), "ray_tpu_workflows")


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_root(), workflow_id)


# ---------------------------------------------------------------------------
# step identity: deterministic from DAG topology
# ---------------------------------------------------------------------------
def _step_id(node: DAGNode, child_ids: List[str]) -> str:
    if isinstance(node, FunctionNode):
        name = node._remote_function._function_name
    else:
        name = type(node).__name__
    static_args = [repr(a) for a in node._bound_args
                   if not isinstance(a, DAGNode)]
    static_kwargs = [f"{k}={v!r}"
                     for k, v in sorted(node._bound_kwargs.items())
                     if not isinstance(v, DAGNode)]
    payload = "|".join([name, *static_args, *static_kwargs, *child_ids])
    digest = hashlib.sha1(payload.encode()).hexdigest()[:10]
    return f"{name}-{digest}"


class _DurableExecutor:
    def __init__(self, workflow_id: str, input_value: Any):
        self.workflow_id = workflow_id
        self.input_value = input_value
        self.dir = _wf_dir(workflow_id)
        os.makedirs(self.dir, exist_ok=True)
        self.executed: Dict[int, Any] = {}
        self.loaded_steps: List[str] = []
        self.ran_steps: List[str] = []

    def _ckpt_path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"{step_id}.pkl")

    def execute(self, node: DAGNode):
        """Bottom-up: returns (step_id, concrete value)."""
        if id(node) in self.executed:
            return self.executed[id(node)]
        if isinstance(node, InputNode):
            out = ("input", self.input_value)
            self.executed[id(node)] = out
            return out

        resolved_args = []
        child_ids = []
        for arg in node._bound_args:
            if isinstance(arg, DAGNode):
                cid, val = self.execute(arg)
                child_ids.append(cid)
                resolved_args.append(val)
            else:
                resolved_args.append(arg)
        resolved_kwargs = {}
        for k, v in node._bound_kwargs.items():
            if isinstance(v, DAGNode):
                cid, val = self.execute(v)
                child_ids.append(cid)
                resolved_kwargs[k] = val
            else:
                resolved_kwargs[k] = v

        step_id = _step_id(node, child_ids)
        path = self._ckpt_path(step_id)
        if os.path.exists(path):
            with open(path, "rb") as f:
                value = serialization.loads(f.read())
            self.loaded_steps.append(step_id)
        else:
            value = self._run_step(node, resolved_args, resolved_kwargs)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(serialization.dumps(value))
            os.replace(tmp, path)
            self.ran_steps.append(step_id)
        out = (step_id, value)
        self.executed[id(node)] = out
        return out

    def _run_step(self, node: DAGNode, args, kwargs):
        import ray_tpu_torch

        if isinstance(node, FunctionNode):
            ref = node._remote_function._remote(tuple(args), kwargs,
                                                node._options)
            return ray_tpu_torch.get(ref)
        raise TypeError(
            f"workflow steps must be task nodes (f.bind(...)); got "
            f"{type(node).__name__} — actor nodes are not durable")

    def _write_meta(self, status: str, error: Optional[str] = None
                    ) -> None:
        meta = {"workflow_id": self.workflow_id, "status": status,
                "updated_at": time.time(), "error": error,
                "steps_loaded": self.loaded_steps,
                "steps_ran": self.ran_steps}
        tmp = os.path.join(self.dir, "meta.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(meta, f)
        os.replace(tmp, os.path.join(self.dir, "meta.pkl"))


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        input_value: Any = None) -> Any:
    """Execute the DAG durably; returns the root value."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    _store_spec(workflow_id, dag, input_value)
    ex = _DurableExecutor(workflow_id, input_value)
    ex._write_meta("RUNNING")
    try:
        _, value = ex.execute(dag)
    except BaseException as e:  # noqa: BLE001
        ex._write_meta("FAILED", error=repr(e))
        raise
    ex._write_meta("SUCCEEDED")
    return value


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              input_value: Any = None):
    """Run in a task; returns an ObjectRef of the root value."""
    import ray_tpu_torch

    payload = serialization.dumps((dag, workflow_id, input_value))
    return ray_tpu_torch.remote(_driver).remote(payload)


def _driver(blob):
    """`run_async`'s task: the workflow, driven from a worker."""
    d, wid, inp = serialization.loads(blob)
    return run(d, workflow_id=wid, input_value=inp)


def resume(workflow_id: str, dag: Optional[DAGNode] = None,
           input_value: Any = None) -> Any:
    """Re-drive a workflow: checkpointed steps replay from storage.
    The reference persists the serialized DAG; here the spec is stored
    on first run so resume works without re-supplying it."""
    spec_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if dag is None:
        if not os.path.exists(spec_path):
            raise KeyError(
                f"workflow {workflow_id!r} has no stored DAG; pass dag=")
        with open(spec_path, "rb") as f:
            dag, input_value = serialization.loads(f.read())
    return run(dag, workflow_id=workflow_id, input_value=input_value)


def _store_spec(workflow_id: str, dag: DAGNode, input_value: Any) -> None:
    os.makedirs(_wf_dir(workflow_id), exist_ok=True)
    with open(os.path.join(_wf_dir(workflow_id), "dag.pkl"), "wb") as f:
        f.write(serialization.dumps((dag, input_value)))


def get_status(workflow_id: str) -> Dict[str, Any]:
    path = os.path.join(_wf_dir(workflow_id), "meta.pkl")
    if not os.path.exists(path):
        raise KeyError(f"unknown workflow {workflow_id!r}")
    with open(path, "rb") as f:
        return pickle.load(f)


def list_all() -> List[Dict[str, Any]]:
    root = _storage_root()
    if not os.path.isdir(root):
        return []
    out = []
    for wid in sorted(os.listdir(root)):
        try:
            out.append(get_status(wid))
        except KeyError:
            continue
    return out


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
