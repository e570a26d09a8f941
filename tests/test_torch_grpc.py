"""The port's gRPC ingress (`ray_tpu_torch/serve/_private/grpc_proxy.py`)
against the JAX package's.

- The request bodies the port's client builds, from the port's codec,
  equal msgpack's bytes (the reference client's) in both payload modes,
  and a msgpack-mode response body, numpy scalars and arrays coerced as
  the reference's `_msgpack_default` does, equals
  `msgpack.packb(..., default=_msgpack_default)`.
- The reference's `GrpcServeClient` talks to the port's ingress, the
  port's client to the port's ingress and to the reference's.
- `allow_pickle=False` refuses a pickled payload (and a later
  pickle-enabled ingress cannot stand in for it), an unknown deployment
  and a missing target are refused, and without grpcio
  (`sys.modules["grpc"] = None`) the ingress and the client raise
  ImportError naming grpcio, and importing the module does not import
  grpc.
- `tests/test_serve_multiplex_grpc.py`'s end-to-end case, on the port's
  in-process runtime and on its cluster.
"""

import os
import pickle
import subprocess
import sys

import msgpack
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
import torch_multiplex_helpers as mux  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu.serve._private.grpc_proxy as ref_grpc  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.serve._private.grpc_proxy as port_grpc  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402

pytestmark = pytest.mark.unit

rng = np.random.default_rng(7)
ARGS = [
    ((21,), {"mult": 2}),
    (("text", b"\x00\xff" * 40, None, True, -3, 2 ** 40),
     {"nested": [[1.5, -2.25], [float(x) for x in rng.standard_normal(5)]]}),
    (([list(range(20))], {"k": {"a": [0.1, 0.2]}}), {}),
    ((), {}),
]
RESULTS = [
    {"x": 42},
    [np.float32(1.5), np.int64(-7), np.bool_(True), np.float64(0.1)],
    {"arr": rng.standard_normal((3, 4)).astype(np.float32),
     "ints": np.arange(6, dtype=np.int32).reshape(2, 3),
     "nested": [(np.int16(3), [np.float16(0.5)])]},
    ["tok", 17, [1.0, 2.5, -0.125] * 30],
    {np.int64(5): "numpy key"},
]


@pytest.mark.parametrize("fmt", ["pickle", "msgpack"])
@pytest.mark.parametrize("case", range(len(ARGS)))
def test_request_bytes_equal_msgpacks(case, fmt):
    args, kwargs = ARGS[case]
    got = port_grpc.GrpcServeClient.request_body(
        "Echo", args, kwargs, method="m", model_id="mx", payload_format=fmt)
    body = {"app": "Echo", "method": "m", "model_id": "mx"}
    if fmt == "msgpack":
        body["msgpack_payload"] = [list(args), kwargs]
    else:
        body["payload"] = pickle.dumps((args, kwargs))
    assert got == msgpack.packb(body, use_bin_type=True)


@pytest.mark.parametrize("case", range(len(RESULTS)))
def test_response_bytes_equal_msgpacks(case):
    result = RESULTS[case]
    got = port_grpc.codec.packb({"ok": True,
                                 "msgpack_payload": port_grpc._coerce(
                                     result)})
    want = msgpack.packb({"ok": True, "msgpack_payload": result},
                         use_bin_type=True,
                         default=ref_grpc._msgpack_default)
    assert got == want


def test_torch_values_coerce_as_their_numpy_twins():
    import torch

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 4
    assert port_grpc._coerce({"t": t, "s": torch.tensor(3)}) == \
        port_grpc._coerce({"t": t.numpy(), "s": np.int64(3)})
    with pytest.raises(TypeError, match="pickle payload mode"):
        port_grpc._coerce(object())


def test_without_grpcio_both_ends_refuse(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError, match="grpcio"):
        port_grpc.GrpcServeClient("127.0.0.1:1")
    with pytest.raises(ImportError, match="grpcio"):
        port_grpc.GrpcIngress().start()
    with pytest.raises(ImportError, match="grpcio"):
        serve.start_grpc_ingress()


def test_importing_the_ingress_imports_no_grpc():
    code = ("import sys, ray_tpu_torch.serve, "
            "ray_tpu_torch.serve._private.grpc_proxy; "
            "print('grpc' in sys.modules, 'msgpack' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_port_client_reads_the_reference_ingress_refusals():
    """No runtime: the reference's ingress (its controller lookup
    stubbed to "no such deployment", which would otherwise start the
    reference's cluster) answers every call with its refusal, which the
    port's client raises as RayServeException."""
    ingress = ref_grpc.GrpcIngress()
    ingress._known_deployment = lambda name: False
    port = ingress.start()
    client = port_grpc.GrpcServeClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(serve.RayServeException, match="no target"):
            client.call("", 1)
        with pytest.raises(serve.RayServeException,
                           match="unknown application 'Echo'"):
            client.call("Echo", 1)
    finally:
        client.close()
        ingress.stop()


# ---------------------------------------------------------------------------
# On the port's runtimes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["in_process", "cluster"])
def runtime(request):
    if request.param == "in_process":
        ray_tpu_torch.init(local_mode=True)
    else:
        helpers.start(ray_tpu_torch)
    try:
        serve.run(serve.deployment(mux.Echo).bind(), name="echo")
        yield request.param
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_grpc_ingress_end_to_end(runtime):
    port = serve.start_grpc_ingress()
    assert port > 0
    # Idempotent: same port on a second start.
    assert serve.start_grpc_ingress() == port

    client = serve.GrpcServeClient(f"127.0.0.1:{port}")
    try:
        # Target = deployment name (the gRPC analogue of the HTTP route).
        assert client.call("Echo", 21, mult=2) == {"x": 42}
        out = client.call("Echo", 5, method="tagged", model_id="mx")
        assert out == {"tag": "mx", "x": 5}
        with pytest.raises(serve.RayServeException, match="no target"):
            client.call("", 1)
    finally:
        client.close()


def test_reference_client_talks_to_port_ingress(runtime):
    port = serve.start_grpc_ingress()
    for fmt in ("pickle", "msgpack"):
        ref = ref_grpc.GrpcServeClient(f"127.0.0.1:{port}",
                                       payload_format=fmt)
        mine = serve.GrpcServeClient(f"127.0.0.1:{port}",
                                     payload_format=fmt)
        try:
            for client in (ref, mine):
                assert client.call("Echo", 21, mult=2) == {"x": 42}
                assert client.call("Echo", [1.5, 2], method="tagged",
                                   model_id="t-1") == {"tag": "t-1",
                                                       "x": [1.5, 2]}
            pid = mine.call("Echo", method="pid")
            assert (pid != os.getpid()) == (runtime == "cluster")
        finally:
            ref.close()
            mine.close()


def test_refusals(runtime):
    port = serve.start_grpc_ingress()
    client = serve.GrpcServeClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(serve.RayServeException,
                           match="unknown application 'Nope'"):
            client.call("Nope", 1)
    finally:
        client.close()
    # A pickle-enabled ingress runs: the no-pickle guarantee cannot be
    # had from it.
    with pytest.raises(serve.RayServeException, match="allow_pickle"):
        serve.start_grpc_ingress(allow_pickle=False)


def test_no_pickle_ingress_rejects_pickled_payloads(runtime):
    from ray_tpu_torch.core.worker import get_actor, kill

    # The running (pickle-enabled) ingress goes first.
    proxy = get_actor(serve._GRPC_PROXY_NAME)
    ray_tpu_torch.get(proxy.stop.remote(), timeout=30)
    kill(proxy)
    serve._grpc_port = None
    port = serve.start_grpc_ingress(allow_pickle=False)
    pickled = serve.GrpcServeClient(f"127.0.0.1:{port}")
    plain = serve.GrpcServeClient(f"127.0.0.1:{port}",
                                  payload_format="msgpack")
    try:
        with pytest.raises(serve.RayServeException,
                           match="allow_pickle=False"):
            pickled.call("Echo", 21, mult=2)
        assert plain.call("Echo", 21, mult=2) == {"x": 42}
        # A default caller attaches to the msgpack-only ingress.
        assert serve.start_grpc_ingress() == port
    finally:
        pickled.close()
        plain.close()
