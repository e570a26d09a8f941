"""The port's cluster runtime (`ray_tpu_torch.core.cluster_runtime`: GCS,
raylet and workers as processes) against the JAX package's cluster
runtime on the same inputs.

The port's cluster runs in this process's driver, started once for the
module; the reference's runs in child interpreters
(`torch_cluster_helpers.py`), started at the module's start and read when
a test needs them. Each holds the same scenarios: the codec byte for byte
against msgpack, RPC frames of every wire message kind, tasks, actors,
objects, device leases (the reference's TPU chip ids against the port's
GPU ids, lease for lease), and code exported from a driver's `__main__`.
"""

import concurrent.futures
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
import typing

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu.core.rpc as jax_rpc  # noqa: E402
import ray_tpu.core.wire as jax_wire  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.core.rpc as port_rpc  # noqa: E402
import ray_tpu_torch.core.wire as port_wire  # noqa: E402
from ray_tpu_torch.core import codec  # noqa: E402

pytestmark = pytest.mark.unit

_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=4)


@pytest.fixture(scope="module")
def reference():
    """The reference's results, computed in child interpreters while the
    port's side runs."""
    futures = {what: _POOL.submit(helpers.run_reference, what)
               for what in ("core", "devices")}
    yield {what: f for what, f in futures.items()}
    for f in futures.values():
        f.result()


@pytest.fixture(scope="module")
def port_cluster(reference):
    rt = helpers.start(ray_tpu_torch)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port_cluster):
    return {"core": helpers.core_scenarios(ray_tpu_torch),
            "devices": helpers.device_scenarios(ray_tpu_torch)}


# ---------------------------------------------------------------------------
# The codec and the RPC frames
# ---------------------------------------------------------------------------
_LEAVES = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300)
           | st.binary(max_size=300))
_VALUES = st.recursive(
    _LEAVES,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_VALUES)
def test_codec_is_msgpacks_bytes(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert codec.packb(value) == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("length", [0, 15, 16, 31, 32, 255, 256, 65535,
                                    65536, 70000])
def test_codec_length_forms(length):
    """Every str, bin, array and map length form, at its edges."""
    for value in ("x" * length, b"y" * length, [1] * length,
                  {str(i): i for i in range(length)}):
        want = msgpack.packb(value, use_bin_type=True)
        assert codec.packb(value) == want
        assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_refuses_what_msgpack_refuses():
    for value in ({1, 2}, object(), np.int64(3)):
        with pytest.raises(TypeError):
            msgpack.packb(value, use_bin_type=True)
        with pytest.raises(TypeError):
            codec.packb(value)
    for value in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(value, use_bin_type=True)
        with pytest.raises(OverflowError):
            codec.packb(value)
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb([1, 2])[:-1])


def _sample(hint, rng):
    """A value of a wire field's type, from `rng`."""
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        return _sample([a for a in typing.get_args(hint)
                        if a is not type(None)][0], rng)
    if origin is dict or hint is dict:
        return {"k" + str(int(rng.integers(9))): float(rng.random()),
                "n": int(rng.integers(-5, 5))}
    if origin in (list, tuple) or hint in (list, tuple):
        return [int(rng.integers(1000)), "s" + str(int(rng.integers(9)))]
    return {int: lambda: int(rng.integers(-2 ** 40, 2 ** 40)),
            float: lambda: float(rng.standard_normal()),
            str: lambda: "v" * int(rng.integers(1, 40)),
            bytes: lambda: rng.bytes(int(rng.integers(0, 300))),
            bool: lambda: bool(rng.integers(2))}.get(
                hint, lambda: {"any": [1, None]})()


def _wire_messages():
    """(JAX message, port message) pairs of every registered kind, with
    the same field values from a seeded RNG."""
    rng = np.random.default_rng(0)
    pairs = []
    for name, (jcls, _) in sorted(jax_wire._REGISTRY.items()):
        pcls = port_wire._REGISTRY[name][0]
        hints = typing.get_type_hints(jcls)
        kwargs = {f.name: _sample(hints[f.name], rng)
                  for f in dataclasses.fields(jcls)}
        pairs.append((name, jcls(**kwargs), pcls(**kwargs)))
    return pairs


def test_every_wire_kind_is_ported():
    assert sorted(port_wire._REGISTRY) == sorted(jax_wire._REGISTRY)
    assert port_wire.schema_digest() == jax_wire.schema_digest()


@pytest.mark.parametrize("name", sorted(jax_wire._REGISTRY))
def test_rpc_frames_of_each_wire_kind(name):
    """pack and pack_blob_frames of one message kind, byte for byte the
    reference's, and the port's reader decodes them to the same object."""
    import asyncio

    _, jmsg, pmsg = next(p for p in _wire_messages() if p[0] == name)
    jbody = {"i": 7, "m": "push_task", "a": {"spec": jax_wire.to_wire(jmsg)}}
    pbody = {"i": 7, "m": "push_task", "a": {"spec": port_wire.to_wire(pmsg)}}
    assert port_rpc.pack(pbody) == jax_rpc.pack(jbody)
    chunks = [b"head", np.arange(100, dtype=np.uint8).tobytes()]
    jframes = jax_rpc.pack_blob_frames(jbody, "blob", chunks)
    assert port_rpc.pack_blob_frames(pbody, "blob", chunks) == jframes

    async def read(data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await port_rpc.read_frame(reader)

    assert asyncio.run(read(jax_rpc.pack(jbody))) == msgpack.unpackb(
        jax_rpc.pack(jbody)[4:], raw=False)
    got = asyncio.run(read(b"".join(jframes)))
    assert got["a"]["blob"] == b"".join(chunks)
    decoded = port_wire.from_wire(got["a"]["spec"], expect=name)
    assert port_wire.to_wire(decoded) == port_wire.to_wire(pmsg)


# ---------------------------------------------------------------------------
# Tasks, actors and objects
# ---------------------------------------------------------------------------
CORE_KEYS = ["add", "two", "nested", "error", "retry", "retried", "cancel",
             "ordered", "named", "killed", "restarted", "async",
             "async_concurrent", "put_get", "wait", "freed", "task_events",
             "timeline"]


@pytest.mark.parametrize("key", CORE_KEYS)
def test_core_matches_reference(key, port_results, reference):
    want = reference["core"].result()
    assert port_results["core"][key] == want[key]


def test_core_scenarios_say_what_they_should(port_results):
    out = port_results["core"]
    assert out["ordered"] == list(range(1, 101))
    assert out["error"] == ["RayTaskError(ValueError)", True, True,
                            "ValueError", "no good"]
    assert out["restarted"] == [1, True] and out["freed"] == [True, True]
    assert out["put_get"][2] and out["wait"] == [1, 1, 1, 1, 1]
    assert out["task_events"] == ["FINISHED"] * 3 + ["RUNNING"] * 3 + [
        "SUBMITTED"] * 3
    assert out["timeline"]


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------
def test_device_leases_match_reference(port_results, reference):
    """The reference's TPU_VISIBLE_CHIPS and the port's
    CUDA_VISIBLE_DEVICES, lease for lease, and workers that held devices
    retire."""
    want = reference["devices"].result()
    got = port_results["devices"]
    assert got["sequence"] == want["sequence"] == ["0", "1", "0", "0,1",
                                                   "0"]
    assert got["device_workers_distinct"] and want["device_workers_distinct"]
    assert not got["plain_reused"] and not want["plain_reused"]


def test_task_without_gpus_sees_no_card(port_results):
    assert port_results["devices"]["plain"] == ""


def test_half_gpu_demands_share_one_id(port_results, reference):
    """Where the port departs from the reference: two 0.5 demands pack
    onto one GPU id (upstream Ray's rule; a card opens in several
    processes), where a fractional TPU demand gets no chip."""
    halves = port_results["devices"]["halves"]
    assert halves[0] == halves[1] and halves[0] in ("0", "1")
    assert reference["devices"].result()["halves"] == [None, None]


@pytest.mark.parametrize("visible,cards,want", [
    (None, 4, 4), ("", 4, 0), ("1,3", 4, 2), ("2,7,1", 4, 1),
    ("GPU-abc,0", 2, 2), ("x", 4, 0)])
def test_gpu_count_follows_cuda_visibility(visible, cards, want,
                                           monkeypatch):
    from ray_tpu_torch.core import cuda_platform

    monkeypatch.setattr(cuda_platform, "_count_cards", lambda: cards)
    monkeypatch.delenv("NVIDIA_VISIBLE_DEVICES", raising=False)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert cuda_platform.detect_gpu_count() == want


@pytest.mark.parametrize("granted,want", [
    ("all", 4), ("0", 1), ("1,3", 2), ("none", 0), ("void", 0)])
def test_gpu_count_follows_the_container_grant(granted, want, monkeypatch):
    from ray_tpu_torch.core import cuda_platform

    monkeypatch.setattr(cuda_platform, "_count_cards", lambda: 4)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", granted)
    assert cuda_platform.detect_gpu_count() == want


def test_instance_ids_map_through_the_nodes_cards(monkeypatch):
    from ray_tpu_torch.core import cuda_platform
    from ray_tpu_torch.core.node import detect_node_resources

    monkeypatch.delenv(cuda_platform.NODE_VISIBLE_ENV, raising=False)
    monkeypatch.delenv("NVIDIA_VISIBLE_DEVICES", raising=False)
    assert cuda_platform.visible_gpu_env([1, 0]) == {
        "CUDA_VISIBLE_DEVICES": "1,0"}
    monkeypatch.setenv(cuda_platform.NODE_VISIBLE_ENV, "5,2,7")
    assert cuda_platform.visible_gpu_env([2, 0]) == {
        "CUDA_VISIBLE_DEVICES": "7,5"}
    monkeypatch.setattr(cuda_platform, "_count_cards", lambda: 0)
    assert "GPU" not in detect_node_resources(num_cpus=1)
    assert detect_node_resources(num_cpus=1, num_gpus=3)["GPU"] == 3.0
    monkeypatch.setattr(cuda_platform, "_count_cards", lambda: 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert detect_node_resources(num_cpus=1)["GPU"] == 2.0
    assert "GPU" not in detect_node_resources(num_cpus=1, num_gpus=0)


# ---------------------------------------------------------------------------
# Exporting code
# ---------------------------------------------------------------------------
def test_main_functions_and_classes_run_in_workers(tmp_path):
    futures = {pkg: _POOL.submit(helpers.run_main_script, pkg, str(tmp_path))
               for pkg in ("ray_tpu", "ray_tpu_torch")}
    got = {pkg: f.result() for pkg, f in futures.items()}
    for out in got.values():
        out.pop("main_pid")
    assert got["ray_tpu_torch"] == got["ray_tpu"] == {"square": 49,
                                                      "acc": 15}


def _closure():
    y = 3

    def inner(x):
        return x + y

    return inner


def test_local_functions_raise_a_named_type_error(port_cluster):
    with pytest.raises(TypeError, match="inner.*module level"):
        ray_tpu_torch.remote(_closure()).remote(1)
    with pytest.raises(TypeError, match="lambda.*module level"):
        ray_tpu_torch.put(lambda v: v)

    class Local:
        pass

    with pytest.raises(TypeError, match="Local.*module level"):
        ray_tpu_torch.remote(Local).remote()


# Cancels of a task that spends nearly all its time inside gc.collect(),
# and the time each may take to end it.
GC_CANCELS = 20
GC_CANCEL_BOUND_S = 10.0


def test_cancel_ends_a_task_inside_gc_callbacks(port_cluster, tmp_path):
    """A cancel that lands while the task's thread runs a gc callback (the
    flight recorder's, where Python swallows it as "Exception ignored")
    still ends the task with TaskCancelledError, every time, within
    GC_CANCEL_BOUND_S (`cluster_runtime.py _on_unraisable`). Without the
    re-delivery all 20 ran on past the bound on this CPU."""
    from ray_tpu_torch.exceptions import TaskCancelledError

    churn = ray_tpu_torch.remote(num_cpus=1)(helpers.gc_churn)
    outcomes = []
    for i in range(GC_CANCELS):
        started = tmp_path / f"started-{i}"
        ref = churn.remote(str(started), 2 * GC_CANCEL_BOUND_S)
        deadline = time.monotonic() + 60
        while not started.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert started.exists(), "the task never started"
        time.sleep(0.05)
        t0 = time.monotonic()
        ray_tpu_torch.cancel(ref)
        try:
            ray_tpu_torch.get(ref, timeout=GC_CANCEL_BOUND_S)
            outcomes.append(("returned", time.monotonic() - t0))
        except TaskCancelledError:
            outcomes.append(("cancelled", time.monotonic() - t0))
        except Exception as e:  # noqa: BLE001
            outcomes.append((type(e).__name__, time.monotonic() - t0))
    assert all(kind == "cancelled" for kind, _ in outcomes), outcomes
    assert max(s for _, s in outcomes) < GC_CANCEL_BOUND_S, outcomes

    # Two methods of one actor at once, in one process: a cancel of one
    # (pending through its 3 s sleep) ends that one only; the other's
    # collections meanwhile go on untouched.
    actor = ray_tpu_torch.remote(num_cpus=1, max_concurrency=2)(
        helpers.Churner).remote()
    a_started, b_started = tmp_path / "a", tmp_path / "b"
    a = actor.nap.remote(str(a_started), 3.0)
    b = actor.churn.remote(str(b_started), 2.0)
    deadline = time.monotonic() + 60
    while not (a_started.exists() and b_started.exists()) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    ray_tpu_torch.cancel(a)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(a, timeout=GC_CANCEL_BOUND_S)
    assert ray_tpu_torch.get(b, timeout=60) == 200_000
    ray_tpu_torch.kill(actor)


# Cancels of a task that catches the cancel and cleans up for 200 ms.
CLEANUP_CANCELS = 5


def test_a_caught_cancel_is_delivered_once(port_cluster, tmp_path):
    """A task that catches its cancel, cleans up for 200 ms while still
    collecting, and returns, gets that time and its result: the cancel is
    raised in it once, as the reference raises it, and is raised again
    only where Python swallowed it."""
    churn = ray_tpu_torch.remote(num_cpus=1)(helpers.churn_then_clean_up)
    for i in range(CLEANUP_CANCELS):
        started, cleaned = tmp_path / f"started-{i}", tmp_path / f"clean-{i}"
        ref = churn.remote(str(started), str(cleaned), 2 * GC_CANCEL_BOUND_S)
        deadline = time.monotonic() + 60
        while not started.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert started.exists(), "the task never started"
        time.sleep(0.05)
        t0 = time.monotonic()
        ray_tpu_torch.cancel(ref)
        assert ray_tpu_torch.get(ref, timeout=GC_CANCEL_BOUND_S) \
            == "cleaned up"
        assert time.monotonic() - t0 >= 0.2
        assert int(cleaned.read_text()) > 0


def test_deployment_wrappers_resolve_to_their_class():
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import function_manager as fm
    from ray_tpu_torch.core import serialization

    assert fm.reference_of(helpers.Echo) == (
        "torch_cluster_helpers", "Echo", None)
    wrapped = serve.deployment(helpers.Echo)
    assert fm.resolve(*fm.reference_of(wrapped)) is helpers.Echo
    assert serialization.loads(serialization.dumps(
        [helpers.Counter, helpers.add])) == [helpers.Counter, helpers.add]


# ---------------------------------------------------------------------------
# init, the daemons' imports, and what waits for later slices
# ---------------------------------------------------------------------------
def test_init_defaults_to_the_cluster_runtime(port_cluster):
    import ray_tpu
    from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

    for pkg in (ray_tpu, ray_tpu_torch):
        assert inspect.signature(pkg.init).parameters[
            "local_mode"].default is False
    assert isinstance(port_cluster, ClusterRuntime)
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    (node,) = ray_tpu_torch.nodes()
    assert node["Alive"] and node["Resources"]["GPU"] == 2.0


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.core.raylet", "ray_tpu_torch.core.gcs.server",
    "ray_tpu_torch.core.worker_main"])
def test_daemons_do_not_import_torch(module):
    code = (f"import sys, {module}; "
            f"print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_what_waits_names_its_slice(port_cluster):
    from ray_tpu_torch.core import object_store
    from ray_tpu_torch.core.config import ray_config

    ray_tpu_config = ray_config()
    ray_tpu_config.apply_system_config({"native_object_store": True})
    try:
        with pytest.raises(NotImplementedError, match="later slice"):
            object_store.make_store(1 << 20)
    finally:
        ray_tpu_config._values.pop("native_object_store")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.core.gcs.server",
         "--replica-id", "gcs0", "--peers", "gcs1=127.0.0.1:1",
         "--storage", os.devnull], capture_output=True, text=True,
        timeout=60, cwd=helpers.ROOT)
    assert out.returncode != 0 and "later slice" in out.stderr


def test_port_imports_no_third_party_codec():
    """msgpack, cloudpickle and psutil are absent on the card machine."""
    code = ("import sys; import ray_tpu_torch.core.cluster_runtime, "
            "ray_tpu_torch.core.raylet, ray_tpu_torch.core.gcs.server, "
            "ray_tpu_torch.core.pg_scheduler, ray_tpu_torch.util, "
            "ray_tpu_torch.air, ray_tpu_torch.train, ray_tpu_torch.tune, "
            "ray_tpu_torch.serve; print(json.dumps(sorted(m for m in "
            "('msgpack', 'cloudpickle', 'psutil', 'jax', 'ray_tpu') "
            "if m in sys.modules)))")
    out = subprocess.run([sys.executable, "-c", "import json; " + code],
                         capture_output=True, text=True, timeout=60,
                         cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
    importlib.import_module("ray_tpu_torch.core.function_manager")
