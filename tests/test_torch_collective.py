"""The port's eager collectives (`ray_tpu_torch.util.collective`) on its
cluster runtime against the JAX package's `ray_tpu.util.collective` on the
same inputs (the reference's tests/test_collective.py): gloo groups of
actors on both, the reference's in a child interpreter (`python
tests/torch_data_helpers.py ray_tpu collective`, one JSON line) while the
port's side runs. Also the port's `nccl` backend in place of `ici`, the
collectives' seconds in a train step's telemetry, and the object store's
zero-copy reads under `get_to_device`.
"""

import concurrent.futures
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_data_helpers as h  # noqa: E402
from torch_cluster_helpers import (CHILD_TIMEOUT_S,  # noqa: E402,F401
                                   NICENESS, ROOT, niced,
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.util import collective as col  # noqa: E402

pytestmark = pytest.mark.unit

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)


def _run_reference(what: str) -> dict:
    proc = subprocess.run(
        ["nice", "-n", str(NICENESS), sys.executable,
         os.path.join(HERE, "torch_data_helpers.py"), "ray_tpu", what],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"reference child ({what}) exited {proc.returncode}:\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def reference():
    future = _POOL.submit(_run_reference, "collective")
    yield future
    future.result()


@pytest.fixture(scope="module")
def port_cluster(reference):
    niced(lambda: ray_tpu_torch.init(num_cpus=8))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port(port_cluster):
    return h.collective_scenarios(ray_tpu_torch)


@pytest.fixture(scope="module")
def ref(reference, port):
    return reference.result()


KEYS = ["ranks", "allreduce_sum", "allreduce_max", "allreduce_min",
        "allreduce_product", "broadcast", "allgather", "reducescatter",
        "reduce_dst", "barrier", "sendrecv", "uninitialized", "declared"]


@pytest.mark.parametrize("key", KEYS)
def test_collective_matches_reference(key, port, ref):
    """Exact on these small integral values (gloo sums them in the same
    ring on both)."""
    assert port[key] == ref[key]


def test_collectives_say_what_they_should(port):
    """The reference's own assertions in tests/test_collective.py."""
    assert port["ranks"] == [0, 1, 2, 3]
    assert port["allreduce_sum"] == [[10.0] * 8] * 4
    assert port["allreduce_max"] == [[4.0] * 8] * 4
    assert port["broadcast"] == [[2.0] * 4] * 4
    assert port["allgather"] == [[[0], [10], [20], [30]]] * 4
    full = 4.0 * np.arange(8)
    assert port["reducescatter"] == [full[i * 2:(i + 1) * 2].tolist()
                                     for i in range(4)]
    assert port["reduce_dst"] == [14.0] * 3
    assert port["barrier"] == [0, 1, 2, 3]
    assert port["sendrecv"] == [42.0]
    assert port["uninitialized"] is True
    assert port["declared"] == [[3.0], [3.0]]


def test_ici_names_nccl_and_nccl_needs_a_card():
    with pytest.raises(ValueError, match="nccl"):
        col.init_collective_group(1, 0, backend="ici", group_name="i")
    with pytest.raises(RuntimeError, match="CUDA card"):
        col.init_collective_group(1, 0, backend="nccl", group_name="n")
    with pytest.raises(ValueError, match="unknown"):
        col.init_collective_group(1, 0, backend="mpi", group_name="m")
    assert "n" not in col._GROUPS and "i" not in col._GROUPS


def test_collective_keeps_the_callers_type(port_cluster):
    """A world-1 gloo group in the driver: numpy in, numpy out; a tensor
    in, a tensor out; the caller's array is never written."""
    import torch

    col.init_collective_group(1, 0, backend="gloo", group_name="one")
    try:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        out = col.allreduce(x, group_name="one")
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, x)
        t = torch.arange(4, dtype=torch.float64)
        got = col.allreduce(t, group_name="one", op=col.ReduceOp.MAX)
        assert isinstance(got, torch.Tensor) and torch.equal(got, t)
        assert got.data_ptr() != t.data_ptr()
        assert col.local_ranks()["one"] == 0
        assert col.get_collective_group_size("one") == 1
    finally:
        col.destroy_collective_group("one")


def test_collective_seconds_land_in_the_step_telemetry(port_cluster,
                                                       tmp_path):
    """`air/session.py _record_collective`: a step that runs collectives
    reports their seconds as its `collective` phase; a step without
    reports none."""
    from ray_tpu_torch import train

    trainer = train.TorchTrainer(
        h.collective_loop, train_loop_config={"ops": 20},
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="tele",
                                   storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics_history[0]["total"] == 40.0
    lines = []
    for path in glob.glob(str(tmp_path / "tele" / "**" / "result.json"),
                          recursive=True):
        with open(path) as f:
            lines += [json.loads(ln) for ln in f if ln.strip()]
    tele = [ln["_telemetry"] for ln in lines]
    assert len(tele) == 2
    assert tele[0]["collective_s"] > 0
    assert tele[1]["collective_s"] == 0
    assert tele[0]["compute_s"] >= 0
    assert abs(tele[0]["step_time_s"] - tele[0]["data_wait_s"]
               - tele[0]["collective_s"] - tele[0]["compute_s"]) < 1e-6


def test_get_returns_shm_view_and_to_torch(port_cluster):
    """A large array round-trips through the store as a read-only view
    over shared memory; `get_to_device` makes it a tensor (one copy, since
    a tensor may be written), and `to_torch` aliases a writable array."""
    from ray_tpu_torch.util import get_to_device, to_torch

    arr = np.arange(2_000_000, dtype=np.float32)
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref, timeout=60)
    np.testing.assert_array_equal(out, arr)
    assert out.base is not None and not out.flags.writeable
    t = get_to_device(ref, timeout=60, device="cpu")
    np.testing.assert_array_equal(t.numpy(), arr)
    assert t.data_ptr() != out.ctypes.data
    w = np.arange(10, dtype=np.int64)
    assert to_torch(w, device="cpu").data_ptr() == w.ctypes.data
