"""The port's Train library (`ray_tpu_torch/train/`, `air/`) against the
JAX package's.

`TorchTrainer` runs gloo gangs on the port's cluster, `JaxTrainer` gloo
CPU gangs on `ray_tpu`'s (in a child interpreter, `python tests/
torch_train_helpers.py ray_tpu train STORAGE`, while the port's side
runs). The same scenarios run on both (`torch_train_helpers.
train_scenarios`): the reference's data-parallel MLP from the same numpy
weights and batches, session ranks, a hard crash with a gang restart
from the latest checkpoint, a failing loop, and what the run leaves on
disk. The cluster starts once for the module.
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_train_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import train  # noqa: E402

pytestmark = pytest.mark.unit

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)


@pytest.fixture(scope="module")
def reference():
    """The reference's results, computed in a child interpreter while the
    port's side runs."""
    future = _POOL.submit(helpers.run_reference, "train")
    yield future
    future.result()


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    niced(lambda: ray_tpu_torch.init(num_cpus=6))
    try:
        yield helpers.train_scenarios(
            ray_tpu_torch, str(tmp_path_factory.mktemp("port_train")))
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ref(reference, port):
    return reference.result()


def test_dp_mlp_losses_match_jax(port, ref):
    """30 Adam steps of the 4-worker DP MLP give JAX's per-step losses to
    1e-4 relative. Both sides average the same global-batch gradient in
    float32, but in different orders (XLA's GSPMD reduction against a
    gloo all-reduce of per-rank PyTorch gradients); Adam divides each
    update by the gradient's running RMS, so those 1e-7 rounding
    differences reach the weights at the scale of the step size and grow
    over the run to a few 1e-5 relative by step 30."""
    got, want = port["dp"], ref["dp"]
    assert got["error"] is None and want["error"] is None
    assert got["world_size"] == want["world_size"] == 4
    assert len(got["losses"]) == len(want["losses"]) == helpers.DP_STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0] / 5


def test_session_ranks_match_jax(port, ref):
    """Rank 0's session (the reference's tests/test_train.py:120), read
    from the 4-worker DP run."""
    assert port["ranks"] == ref["ranks"] == {
        "rank": 0, "world_size": 4, "local_rank": 0, "node_rank": 0}


def test_gang_mesh_matches_jax(port, ref):
    """`train.get_mesh()` in the loop spans the gang's process group: four
    CPU processes are four slices, so dp spans them, as JAX's does. The
    model axes inside a slice differ by construction: each JAX process
    holds the conftest's 8 virtual CPU devices (pp, sp, tp 2 each), each
    port rank one device (1 each)."""
    assert port["mesh"]["dp"] == ref["mesh"]["dp"] == 4
    assert port["mesh"] == {"dp": 4, "pp": 1, "sp": 1, "tp": 1}
    assert ref["mesh"] == {"dp": 4, "pp": 2, "sp": 2, "tp": 2}


def test_gang_restart_matches_jax(port, ref):
    """Every worker exits hard at step 3; the gang restarts once from the
    latest checkpoint and finishes, each step in the history once. Where
    the first attempt's last round is lost (a worker's exit can beat its
    peer's report) is a race on either side, so the attempt's start is
    held to the race's two outcomes."""
    for side in (port["ckpt"], ref["ckpt"]):
        assert side["metrics"]["step"] == 5 and side["metrics"]["w"] == 6.0
        assert side["checkpoint"] == {"step": 5, "w": 6.0}
        assert [s for s, _ in side["history"]] == list(range(6))
        starts = sorted({r for _, r in side["history"]})
        assert starts[0] == 0 and starts[1:] in ([2], [3])
    assert port["ckpt"]["layout"] == ref["ckpt"]["layout"]


def test_result_json_and_checkpoint_layout_match_jax(port, ref):
    """`result.json` holds one line per step with the reference's keys
    (the loop's metrics and `_telemetry`'s step split), and the run's
    directory holds the reference's checkpoint dirs, files and Tune
    state, name for name."""
    assert port["ckpt"]["result_lines"] == ref["ckpt"]["result_lines"]
    assert len(port["ckpt"]["result_lines"]) == 6
    assert port["ckpt"]["layout"] == ref["ckpt"]["layout"]
    assert "<trial>/checkpoint_000005/checkpoint.pkl" in \
        port["ckpt"]["layout"]


def test_training_error_matches_jax(port, ref):
    assert port["error"] == ref["error"] == {
        "type": "TrainingFailedError", "boom": True}


def test_closure_loop_is_refused_by_name():
    """The port sends the loop by reference: a closure raises TypeError
    at construction, naming it."""
    scale = 2.0

    def closure_loop(config):
        train.report({"x": scale})

    with pytest.raises(TypeError, match="closure_loop"):
        train.TorchTrainer(closure_loop)
    with pytest.raises(TypeError, match="lambda"):
        train.TorchTrainer(lambda config: None)


def test_nccl_gang_needs_a_whole_gpu_per_worker():
    with pytest.raises(ValueError, match="whole GPU per worker"):
        train.TorchTrainer(helpers.bad_loop,
                           scaling_config=train.ScalingConfig(
                               num_workers=2, use_gpu=True,
                               gpus_per_worker=0.5))
    with pytest.raises(ValueError, match="whole GPU per worker"):
        train.TorchTrainer(helpers.bad_loop,
                           torch_config=train.TorchConfig(backend="nccl"),
                           scaling_config=train.ScalingConfig(num_workers=2))
    with pytest.raises(ValueError, match="backend"):
        train.TorchConfig(backend="mpi")
    # gloo with half a GPU each is a valid gang.
    train.TorchTrainer(helpers.bad_loop,
                       torch_config=train.TorchConfig(backend="gloo"),
                       scaling_config=train.ScalingConfig(
                           num_workers=2, use_gpu=True, gpus_per_worker=0.5))


def test_scaling_config_reserves_gpus():
    sc = train.ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=1)
    assert sc.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert sc.as_placement_group_factory() == [{"CPU": 1.0, "GPU": 1.0}] * 2
    assert train.ScalingConfig(num_workers=2).worker_resources() == {
        "CPU": 1.0}
