"""The port's trace export (`ray_tpu_torch/util/tracing.py`) against the JAX
package's (`ray_tpu/util/tracing.py`).

- The same span files give equal `collect()` and `to_chrome_trace()`
  output in both packages, and a file written by one package is read by
  the other.
- Head sampling and the per-trace span cap, as
  `tests/test_observability.py::test_trace_sampling_and_span_caps`
  checks them.
- `disable_tracing()` ends the flusher thread and gives back the
  environment variables `enable_tracing` set.
- On the port's cluster, with tracing enabled before `init()`: one HTTP
  request, one HTTP SSE stream (where the reference's proxy splits the
  trace in two) and one gRPC request to a deployment each give one trace id
  with the proxy's, the router's and the replica's spans, the replica's
  from the replica process's own file (as
  `test_observability.py::test_serve_request_single_trace_spans`), a
  handle request the router's and the replica's, and with sample rate 0
  a handle request records nothing in any file.
- A compiled graph records one span per execute
  (`test_observability.py::test_cgraph_one_span_per_execute`).

Every test leaves both modules' globals and the environment as it found
them (`tracing_state`): a `RAY_TPU_TRACE_DIR` left behind would make
every later cluster of this pytest process write spans.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_cluster_helpers as helpers  # noqa: E402
import torch_multiplex_helpers as mux  # noqa: E402
from torch_cluster_helpers import (no_leaked_port_processes,  # noqa: E402,F401
                                   per_test_deadline)

import ray_tpu.util.tracing as ref_tracing  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.util.tracing as tracing  # noqa: E402

pytestmark = pytest.mark.unit

ENV = ("RAY_TPU_TRACE_DIR", "RAY_TPU_TRACE_SAMPLE", "RAY_TPU_TRACE_SPAN_CAP")


def _reset(mod):
    if mod is tracing:
        tracing.disable_tracing()
    mod._enabled = False
    mod._dir = None
    mod._sample_rate = 1.0
    mod._span_cap = None
    mod._span_counts.clear()
    mod._buf.clear()


@pytest.fixture(autouse=True)
def tracing_state(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for mod in (tracing, ref_tracing):
        _reset(mod)
    tracing.clear()
    yield
    for mod in (tracing, ref_tracing):
        _reset(mod)
    tracing.clear()
    for k in ENV:
        os.environ.pop(k, None)


def record_tree(mod, out_dir, **kwargs):
    """A root with two children and a grandchild, one child failing,
    recorded by `mod` into out_dir."""
    mod.enable_tracing(out_dir, **kwargs)
    with mod.span("root", attributes={"k": "v"}):
        with mod.span("child-a"):
            with mod.span("grandchild", attributes={"n": 3}):
                pass
        with pytest.raises(ValueError):
            with mod.span("child-b"):
                raise ValueError("boom")
    mod.flush()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_collect_and_chrome_trace_equal_reference(tmp_path, writer):
    """One package writes the files (two processes' worth: this one's and
    a copy under another pid); both packages collect them into the same
    spans and render the same chrome trace."""
    mod = tracing if writer == "port" else ref_tracing
    d = str(tmp_path / "spans")
    record_tree(mod, d)
    own = os.path.join(d, f"{os.getpid()}.jsonl")
    with open(own) as f:
        lines = f.read().splitlines()
    assert len(lines) == 4
    with open(os.path.join(d, "1.jsonl"), "w") as f:
        f.write("\n".join(lines[:2]) + "\n" + '{"torn": \n')
    _reset(mod)
    port_spans = tracing.collect(d)
    ref_spans = ref_tracing.collect(d)
    assert port_spans == ref_spans and len(port_spans) == 6
    names = [s["name"] for s in port_spans]
    assert sorted(names[2:]) == ["child-a", "child-b", "grandchild", "root"]
    by_name = {s["name"]: s for s in port_spans[2:]}
    assert by_name["child-b"]["error"] == "ValueError: boom"
    assert (by_name["grandchild"]["parent_id"]
            == by_name["child-a"]["span_id"])
    assert len({s["trace_id"] for s in port_spans}) == 1
    assert tracing.to_chrome_trace(port_spans) == \
        ref_tracing.to_chrome_trace(port_spans)
    p_file, r_file = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    tracing.to_chrome_trace(port_spans, p_file)
    ref_tracing.to_chrome_trace(port_spans, r_file)
    with open(p_file) as f, open(r_file) as g:
        assert f.read() == g.read()


def test_span_records_equal_reference_fields(tmp_path):
    """The records both packages write for the same tree carry the same
    fields, the same parent structure and the same attributes."""
    record_tree(tracing, str(tmp_path / "p"))
    record_tree(ref_tracing, str(tmp_path / "r"))

    def shape(spans):
        ids = {s["span_id"]: s["name"] for s in spans}
        return sorted((sorted(s), s["name"], ids.get(s["parent_id"]),
                       s["attributes"], s.get("error"), s["pid"])
                      for s in spans)

    assert shape(tracing.collect(str(tmp_path / "p"))) == \
        shape(ref_tracing.collect(str(tmp_path / "r")))


def test_trace_sampling_and_span_caps(tmp_path):
    """Head sampling decides at the trace root and rides the traceparent
    flags (unsampled traces record nothing anywhere but still propagate
    context); per-trace span caps bound recording."""
    d0 = str(tmp_path / "s0")
    tracing.enable_tracing(d0, sample_rate=0.0)
    assert os.environ["RAY_TPU_TRACE_SAMPLE"] == "0.0"
    with tracing.span("root"):
        tp = tracing.current_traceparent()
        assert tp is not None and tp.endswith("-00"), tp
        with tracing.span("child"):
            assert tracing.current_traceparent().split("-")[1] == \
                tp.split("-")[1]
    tracing.flush()
    assert tracing.collect(d0) == []

    # A propagated not-sampled parent suppresses child recording too
    # (cross-process agreement), even at sample rate 1.
    tracing.enable_tracing(d0, sample_rate=1.0)
    with tracing.span("w", parent="00-" + "a" * 32 + "-" + "b" * 16
                      + "-00"):
        pass
    tracing.flush()
    assert tracing.collect(d0) == [] and tracing.spans() == []

    # Sample rate 1 and a cap of 3: at most 3 spans per trace.
    _reset(tracing)
    d1 = str(tmp_path / "s1")
    tracing.enable_tracing(d1, sample_rate=1.0, max_spans_per_trace=3)
    assert os.environ["RAY_TPU_TRACE_SPAN_CAP"] == "3"
    with tracing.span("root"):
        for i in range(10):
            with tracing.span(f"n{i}"):
                pass
    with tracing.span("another-root"):
        pass
    tracing.flush()
    spans = tracing.collect(d1)
    assert [s["name"] for s in spans] == ["n0", "n1", "n2", "another-root"]


def test_sampling_rate_is_a_rate(tmp_path):
    import random

    random.seed(0)
    tracing.enable_tracing(str(tmp_path), sample_rate=0.25)
    for _ in range(400):
        with tracing.span("root"):
            pass
    n = len(tracing.collect(str(tmp_path)))
    assert 50 <= n <= 150, n


def test_disable_ends_the_flusher_and_restores_the_environment(
        tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0.5")
    tracing.enable_tracing(str(tmp_path), sample_rate=1.0)
    assert tracing._sample_rate == 1.0
    assert os.environ["RAY_TPU_TRACE_DIR"] == str(tmp_path)
    assert any(t.name == "trace-flush" for t in threading.enumerate())
    with tracing.span("x"):
        pass
    deadline = time.monotonic() + 5
    while (not os.path.exists(tmp_path / f"{os.getpid()}.jsonl")
           and time.monotonic() < deadline):
        time.sleep(0.05)          # the flusher writes it, unasked
    assert [s["name"] for s in tracing.collect(str(tmp_path))] == ["x"]
    tracing.disable_tracing()
    assert not any(t.name == "trace-flush" for t in threading.enumerate())
    assert "RAY_TPU_TRACE_DIR" not in os.environ
    assert os.environ["RAY_TPU_TRACE_SAMPLE"] == "0.5"
    with tracing.span("after"):
        pass
    assert [s["name"] for s in tracing.spans()] == ["x"]


def test_a_worker_turns_tracing_on_from_its_environment(tmp_path,
                                                        monkeypatch):
    """What a cluster's worker does: RAY_TPU_TRACE_DIR in its environment
    and no enable_tracing call; its first span turns recording on."""
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_TRACE_SPAN_CAP", "7")
    assert not tracing.tracing_enabled()
    with tracing.span("first"):
        pass
    assert tracing.tracing_enabled() and tracing._span_cap == 7
    assert [s["name"] for s in tracing.collect(str(tmp_path))] == ["first"]


# ---------------------------------------------------------------------------
# Across processes: Serve on the port's cluster
# ---------------------------------------------------------------------------
def _wait_for(spans_fn, cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    spans = spans_fn()
    while not cond(spans) and time.monotonic() < deadline:
        time.sleep(0.25)             # the replica's flush interval
        spans = spans_fn()
    return spans


def test_serve_request_single_trace_spans(tmp_path):
    """One HTTP, one gRPC and one handle request each give one trace id
    whose replica span comes from the replica process's file; at sample
    rate 0 a handle request records nothing in any file."""
    from ray_tpu_torch import serve

    trace_dir = str(tmp_path / "spans")
    tracing.enable_tracing(trace_dir)
    helpers.start(ray_tpu_torch)
    try:
        serve.run(serve.deployment(mux.Echo).bind(), name="echo",
                  route_prefix="/echo")
        port = serve.start()
        out = helpers.http(port, "/echo", 21, timeout=60)
        assert json.loads(out) == {"x": 21}
        sse = urllib.request.Request(
            f"http://127.0.0.1:{port}/echo?method=count", data=b"3",
            headers={"Content-Type": "application/json",
                     "Accept": "text/event-stream"})
        with urllib.request.urlopen(sse, timeout=60) as resp:
            assert resp.read().count(b"data: ") == 3
        gport = serve.start_grpc_ingress()
        client = serve.GrpcServeClient(f"127.0.0.1:{gport}")
        try:
            assert client.call("Echo", 21) == {"x": 21}
        finally:
            client.close()
        handle = serve.get_deployment_handle("Echo")
        assert handle.remote(3, mult=2).result(timeout_s=60) == {"x": 6}
        replica_pid = handle.options(method_name="pid").remote().result(
            timeout_s=60)

        def complete(spans):
            roots = [s for s in spans if s["name"] == "serve.proxy"]
            routers = [s for s in spans if s["name"] == "serve.router"]
            traces = {s["trace_id"] for s in roots + routers}
            return len(roots) == 3 and all(
                {"serve.router", "serve.replica"}
                <= {s["name"] for s in spans if s["trace_id"] == t}
                for t in traces)

        spans = _wait_for(lambda: tracing.collect(trace_dir), complete)
        assert complete(spans), [(s["name"], s["pid"]) for s in spans]
        for ingress, streaming in (("http", False), ("http", True),
                                   ("grpc", False)):
            proxy = next(s for s in spans if s["name"] == "serve.proxy"
                         and s["attributes"]["ingress"] == ingress
                         and ("streaming" in s["attributes"]) == streaming)
            same = [s for s in spans if s["trace_id"] == proxy["trace_id"]]
            by_name = {s["name"]: s for s in same}
            # And the replica actor's task span (`actor.run ...`).
            assert {"serve.proxy", "serve.replica", "serve.router"} \
                <= set(by_name), (ingress, same)
            assert all(s["pid"] != os.getpid() for s in same)
            assert (by_name["serve.router"]["parent_id"]
                    == by_name["serve.proxy"]["span_id"])
            assert (by_name["serve.replica"]["parent_id"]
                    == by_name["serve.router"]["span_id"])
            # Three processes: the ingress actor's, the replica's, and
            # neither is this driver.
            assert by_name["serve.replica"]["pid"] == replica_pid
            assert by_name["serve.proxy"]["pid"] not in (os.getpid(),
                                                         replica_pid)
        handle_traces = [s for s in spans if s["name"] == "serve.router"
                         and s["pid"] == os.getpid()]
        assert len(handle_traces) == 2       # the call and the pid call
        replica_files = {s["pid"] for s in spans
                         if s["name"] == "serve.replica"}
        assert replica_files == {replica_pid}
        chrome = str(tmp_path / "trace.json")
        tracing.to_chrome_trace(spans, chrome)
        with open(chrome) as f:
            events = json.load(f)
        assert {e["args"]["trace_id"] for e in events} == \
            {s["trace_id"] for s in spans}

        # Sample rate 0 at the driver: the handle request's root is not
        # sampled, and the replica obeys the flags it is sent.
        # (The controller's health checks are roots of their own, sampled
        # in its process: they are not the request's.)
        def request_spans():
            """The request path's spans once a flush interval adds none."""
            def of_requests():
                return [s for s in tracing.collect(trace_dir)
                        if s["name"].startswith("serve.")
                        or "handle_request" in s["name"]]

            spans, n = of_requests(), -1
            while len(spans) != n:
                n = len(spans)
                time.sleep(1.0)
                spans = of_requests()
            return spans

        before = request_spans()
        tracing.enable_tracing(trace_dir, sample_rate=0.0)
        assert handle.remote(4).result(timeout_s=60) == {"x": 4}
        assert request_spans() == before
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_cgraph_one_span_per_execute(tmp_path):
    """A compiled-graph execution records ONE span per execute, not one
    per node."""
    import torch_cgraph_helpers as cg

    from ray_tpu_torch.dag import InputNode

    d = str(tmp_path / "cg")
    tracing.enable_tracing(d, sample_rate=1.0)
    ray_tpu_torch.init(local_mode=True)
    try:
        a, b, c = (ray_tpu_torch.remote(cg.Stage).remote(1)
                   for _ in range(3))
        with InputNode() as inp:
            dag = c.add.bind(b.add.bind(a.add.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            for i in range(4):
                assert ray_tpu_torch.get(compiled.execute(i)) == i + 3
        finally:
            compiled.teardown()
        spans = tracing.collect(d)
        execs = [s for s in spans if s["name"] == "cgraph.execute"]
        assert len(execs) == 4, [s["name"] for s in spans]
        assert not any(s["name"].startswith("cgraph:") for s in spans)
    finally:
        ray_tpu_torch.shutdown()
