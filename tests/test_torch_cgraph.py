"""The port's compiled graphs (`ray_tpu_torch.cgraph`: channels, actor
loops, restart through actor death) against the JAX package's
`ray_tpu.cgraph` on the same graphs and inputs.

First the in-process runtime (local mode), where the reference's compiled
graphs run in this process too, as tests/test_cgraph.py runs them; then
the port's cluster, started once for the rest of the module: the
counterparts of tests/test_cgraph.py's cluster tests and of
tests/test_data_plane_cluster.py's compiled-graph tests (the `"device"`
edge over a gloo `util.collective` group), torch tensors on `"array"`
edges across processes, and a two-stage pipeline of a small transformer
held to the port's in-process `forward` (bitwise) and to JAX's `forward`
(REL_TOL). What the graphs send to workers lives in
`tests/torch_cgraph_helpers.py`.
"""

import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cgraph_helpers as h  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu  # noqa: E402
import ray_tpu.core.serialization as jax_ser  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.core.serialization as ser  # noqa: E402
from ray_tpu_torch.dag import InputNode, MultiOutputNode  # noqa: E402

pytestmark = pytest.mark.unit

# float32 on both sides; the two frameworks sum in different orders (the
# tolerance of test_torch_transformer.py).
REL_TOL = 1e-4
WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, d_ff=128,
              max_seq_len=256)


# ---------------------------------------------------------------------------
# local mode
# ---------------------------------------------------------------------------
@pytest.fixture
def local():
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _stage():
    return ray_tpu_torch.remote(h.Stage)


def test_compiled_matches_dag_execute(local):
    Stage = _stage()
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        for x in (0, 5, -3):
            assert local.get(compiled.execute(x)) \
                == local.get(dag.execute(x)) == x + 111
    finally:
        compiled.teardown()


def test_fan_in_constants_and_multi_output(local):
    Stage = _stage()
    a, b, c = Stage.remote(1), Stage.remote(2), Stage.remote()
    with InputNode() as inp:
        x = a.add.bind(inp)
        y = b.add.bind(inp)
        z = c.mul.bind(x, y)
        w = b.mul.bind(z, 10)
        dag = MultiOutputNode([w, x])
    assert local.get(dag.execute(3)) == [(4 * 5) * 10, 4]
    compiled = dag.experimental_compile()
    try:
        assert local.get(compiled.execute(3)) == [200, 4]
        assert local.get(compiled.execute(0)) == [(1 * 2) * 10, 1]
    finally:
        compiled.teardown()


def test_error_fan_out_recovery_and_teardown(local):
    from ray_tpu_torch.cgraph.loop import _live_loop_count

    Stage = _stage()
    a, b, c = Stage.remote(), Stage.remote(), Stage.remote(7)
    with InputNode() as inp:
        dag = c.add.bind(b.boom.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    r_ok1 = compiled.execute(1)
    r_bad = compiled.execute(3)
    r_ok2 = compiled.execute(5)
    assert local.get(r_ok1) == 8
    with pytest.raises(ValueError, match="bad input 3"):
        local.get(r_bad)
    assert local.get(r_ok2) == 12
    compiled.teardown()
    assert _live_loop_count() == 0
    for actor in (a, b, c):
        assert local.get(actor.__ray_call__.remote(
            h.live_loops, "ray_tpu_torch")) == 0
    assert local.get(a.add.remote(1)) == 1
    with pytest.raises(Exception):
        compiled.execute(1)


def test_backpressure_bounds_in_flight(local):
    Stage = _stage()
    src, sink = Stage.remote(1), Stage.remote()
    with InputNode() as inp:
        dag = sink.slow.bind(src.add.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=2, channel_capacity=2)
    try:
        n = 6
        t0 = time.perf_counter()
        refs = [compiled.execute(i) for i in range(n)]
        submit_dt = time.perf_counter() - t0
        assert submit_dt >= (n - 2 - 1) * 0.15, (
            f"execute() never blocked: submitted {n} in {submit_dt:.3f}s")
        assert [local.get(r) for r in refs] == [i + 1 for i in range(n)]
    finally:
        compiled.teardown()


def test_array_channel_hands_a_tensor_over_by_reference(local):
    """Co-located handoff: the tensor the driver wrote is the object the
    stage returns through two `"array"` edges (no copy); numpy as the
    reference's test gives it."""
    T = ray_tpu_torch.remote(h.Tensor)
    a, b = T.remote(), T.remote()
    with InputNode() as inp:
        dag = b.same.bind(a.same.bind(inp).with_channel("array")
                          ).with_channel("array")
    compiled = dag.experimental_compile()
    try:
        x = torch.arange(6.0).reshape(2, 3)
        assert local.get(compiled.execute(x)) is x
    finally:
        compiled.teardown()
    with InputNode() as inp:
        dag = b.plus.bind(a.scale.bind(inp).with_channel("array"))
    compiled = dag.experimental_compile()
    try:
        out = local.get(compiled.execute(np.arange(4.0)))
        np.testing.assert_allclose(np.asarray(out), [1.0, 3.0, 5.0, 7.0])
    finally:
        compiled.teardown()


def test_cgraph_execute_span_is_recorded(local):
    from ray_tpu_torch.util import tracing

    a = _stage().remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    compiled = dag.experimental_compile()
    tracing.clear()
    tracing.enable_tracing()
    try:
        assert local.get(compiled.execute(1)) == 2
        assert local.get(compiled.execute(2)) == 3
    finally:
        tracing.disable_tracing()
        compiled.teardown()
    spans = [s for s in tracing.spans() if s["name"] == "cgraph.execute"]
    assert [s["attributes"]["execution"] for s in spans] == [0, 1]
    assert all(s["attributes"]["graph_id"] == compiled.graph_id
               for s in spans)


FAST_VALUES = [None, b"bytes", "text", True, 7, -3, 2.5, 0, 2 ** 63,
               np.arange(12, dtype=np.float32).reshape(3, 4),
               np.zeros((0, 3), np.int64)]


@pytest.mark.parametrize("i", range(len(FAST_VALUES)))
def test_fast_frames_equal_reference(i):
    """The channel codec's N, B, S, M and A frames are the reference's
    byte for byte, and each side reads the other's."""
    value = FAST_VALUES[i]
    buf = bytearray()
    ser.serialize_fast_into(value, buf)
    assert bytes(buf) == jax_ser.serialize_fast(value)
    for out in (ser.deserialize_fast(bytes(buf), full=True),
                jax_ser.deserialize_fast(bytes(buf))):
        if isinstance(value, np.ndarray):
            assert out.dtype == value.dtype and out.shape == value.shape
            np.testing.assert_array_equal(out, value)
        else:
            assert out == value and type(out) is type(value)


def test_serialize_fast_roundtrip():
    """tests/test_cgraph.py's round trip, on the port's full form: the
    leaf types, a pickled fallback (``P``) and the reused frame buffer."""
    for value in (None, b"bytes", "text", True, 7, -3, 2.5,
                  {"nested": [1, 2]}, 10 ** 30):
        buf = bytearray()
        ser.serialize_fast_into(value, buf)
        assert ser.deserialize_fast(bytes(buf), full=True) == value
    buf = bytearray()
    ser.serialize_fast_into({"k": 1}, buf)
    first = bytes(buf)
    buf.clear()
    ser.serialize_fast_into({"k": 1}, buf)
    assert bytes(buf) == first
    with pytest.raises(ValueError):      # prefix shipping stays strict
        ser.deserialize_fast(first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, "f32_transposed"])
def test_tensor_frames_keep_dtype_shape_and_values(dtype):
    base = torch.arange(24).reshape(4, 6)
    t = (base.float().t() if dtype == "f32_transposed"
         else (base * 1.25).to(dtype))
    chunks = ser.pack_array_chunks(t)
    out = ser.deserialize_fast(b"".join(bytes(c) for c in chunks),
                               full=True)
    assert out.dtype == t.dtype and out.shape == t.shape
    assert out.is_contiguous() and torch.equal(out, t)
    out.add_(1)                                # owns its memory
    assert not torch.equal(out, t)


def test_a_frame_from_a_card_never_lands_on_the_host():
    """A ``T`` frame that left a card lands on the reader's card; a reader
    without one raises instead of handing back a host tensor."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the frame would land on it")
    t = torch.arange(6, dtype=torch.float32)
    frame = bytearray(b"".join(bytes(c) for c in ser.pack_array_chunks(t)))
    head_len = int.from_bytes(frame[1:5], "little")
    head = ser.unpackb(bytes(frame[5:5 + head_len]))
    assert head == {"t": "float32", "s": [6], "c": 0}
    card_head = ser.packb(dict(head, c=1))
    card_frame = (b"T" + len(card_head).to_bytes(4, "little") + card_head
                  + bytes(frame[5 + head_len:]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser.deserialize_fast(card_frame, full=True)
    from ray_tpu_torch.cgraph.channel import ArrayChannel
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrayChannel(capacity=1)._decode(card_frame)


TENSORS = {
    "float32": lambda: torch.randn(8, 16, generator=torch.Generator()
                                   .manual_seed(0)),
    "bfloat16": lambda: torch.randn(8, 16, generator=torch.Generator()
                                    .manual_seed(1)).to(torch.bfloat16),
    "int64": lambda: torch.arange(-64, 64).reshape(8, 16),
    "float32_transposed": lambda: torch.randn(
        16, 8, generator=torch.Generator().manual_seed(2)).t(),
}


@pytest.mark.parametrize("name", list(TENSORS))
def test_array_edges_carry_torch_tensors_in_local_mode(local, name):
    """In one process an `"array"` edge hands the tensor over as it is:
    the same object, its dtype and its strides."""
    T = ray_tpu_torch.remote(h.Tensor)
    a, b = T.remote(), T.remote()
    x = TENSORS[name]()
    with InputNode() as inp:
        dag = b.same.bind(a.same.bind(inp.with_channel("array"))
                          .with_channel("array")).with_channel("array")
    compiled = dag.experimental_compile()
    try:
        out = local.get(compiled.execute(x))
        assert out is x and out.stride() == x.stride()
    finally:
        compiled.teardown()


@pytest.fixture(scope="module")
def compiled_results():
    """cgraph_scenarios in local mode: (reference's, port's)."""
    ray_tpu.init(local_mode=True, ignore_reinit_error=True)
    try:
        ref = h.cgraph_scenarios(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        port = h.cgraph_scenarios(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    return ref, port


@pytest.mark.parametrize("key", ["chain", "multi", "error_fan_out",
                                 "array"])
def test_compiled_result_equals_reference(compiled_results, key):
    ref, port = compiled_results
    assert port[key] == ref[key]


def _transformer_pair(seed=0):
    """(JAX params, JAX config, the numpy tree both sides load)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import TransformerConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init_params

    jcfg = JaxConfig(dtype=jnp.float32, **WIDTHS)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, jcfg, jax.tree.map(np.asarray, jparams)


def _pipeline_logits(pkg, np_tree, batches, threads=None):
    """Each batch's logits through the compiled two-stage pipeline
    (head: embedding and layer 0; tail: layer 1, norm, logits) over an
    `"array"` edge; and through the lazy DAG."""
    Head = pkg.remote(num_cpus=0)(h.TransformerHead)
    Tail = pkg.remote(num_cpus=0)(h.TransformerTail)
    head = Head.remote(np_tree, WIDTHS, 1, threads)
    tail = Tail.remote(np_tree, WIDTHS, 1, threads)
    with InputNode() as inp:
        dag = tail.logits.bind(head.hidden.bind(inp).with_channel("array"))
    lazy = [pkg.get(dag.execute(b), timeout=120) for b in batches]
    compiled = dag.experimental_compile(max_in_flight=2)
    try:
        refs = [compiled.execute(b) for b in batches]
        out = [pkg.get(r, timeout=120) for r in refs]
    finally:
        compiled.teardown()
    return out, lazy


def _pipeline_case(pkg, threads=None):
    """(compiled logits, lazy logits, in-process logits, JAX logits)."""
    import jax.numpy as jnp

    from ray_tpu.models.transformer import forward as jax_forward
    from ray_tpu_torch.models import TransformerConfig, forward, \
        params_from_jax

    jparams, jcfg, np_tree = _transformer_pair()
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, WIDTHS["vocab_size"], (2, 128))
               .astype(np.int64) for _ in range(3)]
    got, lazy = _pipeline_logits(pkg, np_tree, batches, threads)
    params = params_from_jax(np_tree, device="cpu")
    cfg = TransformerConfig(dtype=torch.float32, **WIDTHS)
    old = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with torch.no_grad():
            want = [forward(params, b, cfg, device="cpu")[0]
                    for b in batches]
    finally:
        torch.set_num_threads(old)
    ref = [np.asarray(jax_forward(jparams, jnp.asarray(b.astype(np.int32)),
                                  jcfg)[0]) for b in batches]
    return got, lazy, want, ref


def _check_pipeline(got, lazy, want, ref):
    for g, lz, w, r in zip(got, lazy, want, ref):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert torch.equal(g, w), (
            f"the pipeline's logits differ from the in-process forward by "
            f"{(g - w).abs().max().item():.3e}")
        assert torch.equal(lz, w)
        scale = np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, atol=REL_TOL * scale,
                                   rtol=REL_TOL)


def test_two_stage_transformer_pipeline_in_local_mode(local):
    _check_pipeline(*_pipeline_case(local))


# ---------------------------------------------------------------------------
# the cluster (module-scoped, after every local-mode test)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    niced(lambda: ray_tpu_torch.init(num_cpus=8))
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _ready(pkg, actors):
    pkg.get([x.__ray_call__.remote(h.pid_of) for x in actors], timeout=120)


def test_two_stage_transformer_pipeline_across_processes(cluster):
    """Head and tail in worker processes, one CPU thread each (and in
    the driver's forward), so that the products sum as the in-process
    forward's do: the logits are bitwise."""
    _check_pipeline(*_pipeline_case(cluster, threads=1))


def test_compiled_cluster_end_to_end(cluster):
    from ray_tpu_torch.cgraph.loop import _live_loop_count

    Stage = _stage()
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    cluster.get([s.count.remote() for s in (a, b, c)], timeout=120)
    with InputNode() as inp:
        dag = c.add.bind(b.boom.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    assert cluster.get(compiled.execute(5), timeout=60) \
        == cluster.get(dag.execute(5), timeout=60) == 106
    r_bad = compiled.execute(2)
    r_ok = compiled.execute(5)
    with pytest.raises(ValueError, match="bad input 3"):
        cluster.get(r_bad, timeout=60)
    assert cluster.get(r_ok, timeout=60) == 106
    compiled.teardown()
    for actor in (a, b, c):
        assert cluster.get(actor.__ray_call__.remote(
            h.live_loops, "ray_tpu_torch"), timeout=60) == 0
    assert _live_loop_count() == 0
    assert cluster.get(a.add.remote(1), timeout=60) == 2
    for actor in (a, b, c):
        cluster.kill(actor)


def test_compiled_cluster_loop_actor_death(cluster):
    """Killing a mid-chain loop actor poisons in-flight executions with an
    error at get; actors without restart budget never revive the graph;
    teardown still cleans up."""
    from ray_tpu_torch.exceptions import RayError

    Stage = _stage()
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    cluster.get([s.count.remote() for s in (a, b, c)], timeout=120)
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    assert cluster.get(compiled.execute(0), timeout=60) == 111
    assert compiled._restarts_left == 0
    cluster.kill(b)
    with pytest.raises(RayError):
        cluster.get(compiled.execute(1), timeout=30)
    with pytest.raises(RayError):
        cluster.get(compiled.execute(2), timeout=30)
    compiled.teardown()
    assert cluster.get(a.add.remote(1), timeout=60) == 2
    cluster.kill(a)
    cluster.kill(c)


def test_compiled_graph_restarts_through_actor_death(cluster):
    """SIGKILL of a loop actor's worker with restart budget: executions in
    flight may fail with the death error, a later execute recompiles onto
    the restarted actor, and the restart is a `cgraph.restart` instant in
    the driver's flight ring."""
    from ray_tpu_torch.core import flight

    Stage = _stage().options(max_restarts=2, max_task_retries=2)
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    cluster.get([s.count.remote() for s in (a, b, c)], timeout=120)
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    compiled = dag.experimental_compile()
    assert cluster.get(compiled.execute(0), timeout=60) == 111
    assert compiled._restarts_left >= 1
    pid = cluster.get(b.__ray_call__.remote(h.pid_of), timeout=60)
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 120
    recovered = False
    while time.time() < deadline and not recovered:
        try:
            # A short get: with no execution behind it, the head's broken
            # push surfaces at its next write.
            assert cluster.get(compiled.execute(5), timeout=10) == 116
            recovered = True
        except Exception:  # noqa: BLE001
            time.sleep(0.5)
    assert recovered, "graph never revived through the actor restart"
    for x in (1, 2, 3):
        assert cluster.get(compiled.execute(x), timeout=60) == x + 111
    assert cluster.get(b.__ray_call__.remote(h.pid_of), timeout=60) != pid
    events = flight.dump(include_events=True)["events"]
    assert any(e[3] == "cgraph.restart" for e in events)
    compiled.teardown()
    for actor in (a, b, c):
        cluster.kill(actor)


@pytest.mark.parametrize("name", list(TENSORS))
def test_array_edges_carry_torch_tensors_across_processes(cluster, name):
    """Driver -> stage -> stage -> driver over `"array"` edges: the dtype
    (bfloat16 included), shape and values survive, a non-contiguous
    tensor arrives contiguous, and each stage sees a torch tensor."""
    T = ray_tpu_torch.remote(num_cpus=0)(h.Tensor)
    a, b = T.remote(), T.remote()
    _ready(cluster, (a, b))
    x = TENSORS[name]()
    with InputNode() as inp:
        dag = b.same.bind(a.same.bind(inp.with_channel("array"))
                          .with_channel("array")).with_channel("array")
    compiled = dag.experimental_compile()
    with InputNode() as inp:
        probe = b.describe.bind(a.same.bind(inp.with_channel("array"))
                                .with_channel("array"))
    described = probe.experimental_compile()
    try:
        out = cluster.get(compiled.execute(x), timeout=60)
        assert isinstance(out, torch.Tensor)
        assert out.dtype == x.dtype and out.shape == x.shape
        assert torch.equal(out, x)
        assert cluster.get(described.execute(x), timeout=60) == (
            "Tensor", str(x.dtype), "cpu", list(x.shape), True)
    finally:
        compiled.teardown()
        described.teardown()
        cluster.kill(a)
        cluster.kill(b)


def _group_pair(cluster, group):
    G = ray_tpu_torch.remote(num_cpus=0)(h.GroupStage)
    a = G.remote(0, 2, group)
    b = G.remote(1, 2, group)
    assert cluster.get([a.join_group.remote(), b.join_group.remote()],
                       timeout=120) == [0, 1]
    return a, b


def _chain(kind, a, b):
    with InputNode() as inp:
        dag = b.plus.bind(a.scale.bind(inp).with_channel(kind))
    return dag.experimental_compile()


def test_device_channel_parity_with_push(cluster):
    """The p2p transport (gloo) gives exactly what the push transport
    gives — same chain, same inputs, `"device"` against `"array"` — for
    numpy arrays and torch tensors, and the writer's edge did resolve a
    collective route."""
    a, b = _group_pair(cluster, "cg_parity")
    dev = _chain("device", a, b)
    push = _chain("array", a, b)
    try:
        for i in range(4):
            x = np.arange(64, dtype=np.float32).reshape(8, 8) + i
            got = cluster.get(dev.execute(x), timeout=120)
            want = cluster.get(push.execute(x), timeout=120)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            np.testing.assert_array_equal(np.asarray(got), x * 2.0 + 1.0)
            t = torch.from_numpy(x).to(torch.bfloat16)
            got = cluster.get(dev.execute(t), timeout=120)
            want = cluster.get(push.execute(t), timeout=120)
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        routes = cluster.get(a.__ray_call__.remote(h.device_routes),
                             timeout=60)
        assert routes == [["cg_parity", 0, 1]]
    finally:
        dev.teardown()
        push.teardown()
        cluster.get([a.leave_group.remote(), b.leave_group.remote()],
                    timeout=60)
        cluster.kill(a)
        cluster.kill(b)


def test_execute_input_buffer_reuse_safe(cluster):
    """Driver-side input edges snapshot the value at write time, for a
    numpy array and a torch tensor alike."""
    G = ray_tpu_torch.remote(num_cpus=0)(h.GroupStage)
    a, b = G.remote(), G.remote()
    with InputNode() as inp:
        dag = b.plus.bind(
            a.scale.bind(inp.with_channel("array")).with_channel("array"))
    compiled = dag.experimental_compile()
    try:
        for buf in (np.zeros(1 << 14, dtype=np.float32),
                    torch.zeros(1 << 14, dtype=torch.float32)):
            refs = []
            for i in range(4):
                buf[:] = float(i)
                refs.append(compiled.execute(buf))
            for i, ref in enumerate(refs):
                out = np.asarray(cluster.get(ref, timeout=120))
                np.testing.assert_array_equal(
                    out, np.full(1 << 14, i * 2.0 + 1.0, dtype=np.float32))
    finally:
        compiled.teardown()
        cluster.kill(a)
        cluster.kill(b)


def test_device_channel_falls_back_without_group(cluster):
    G = ray_tpu_torch.remote(num_cpus=0)(h.GroupStage)
    a, b = G.remote(), G.remote()
    compiled = _chain("device", a, b)
    try:
        x = np.arange(16, dtype=np.float32)
        got = cluster.get(compiled.execute(x), timeout=120)
        np.testing.assert_array_equal(np.asarray(got), x * 2.0 + 1.0)
        t = torch.arange(16, dtype=torch.float32)
        got = cluster.get(compiled.execute(t), timeout=120)
        assert torch.equal(got, t * 2.0 + 1.0)
        assert cluster.get(a.__ray_call__.remote(h.device_routes),
                           timeout=60) == []
    finally:
        compiled.teardown()
        cluster.kill(a)
        cluster.kill(b)


def test_device_channel_non_tensor_payload_falls_back(cluster):
    D = ray_tpu_torch.remote(num_cpus=0)(h.Dicty)
    a, b = D.remote(), D.remote()
    with InputNode() as inp:
        dag = b.unwrap.bind(a.wrap.bind(inp).with_channel("device"))
    compiled = dag.experimental_compile()
    try:
        assert cluster.get(compiled.execute(np.ones(4, np.float32)),
                           timeout=120) == 4.0
    finally:
        compiled.teardown()
        cluster.kill(a)
        cluster.kill(b)


def test_teardown_leaves_no_loop_thread_in_the_driver(cluster):
    names = [t.name for t in threading.enumerate()
             if t.name.startswith("cgraph-loop")]
    assert names == []
