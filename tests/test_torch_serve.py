"""The port's Serve (`ray_tpu_torch.serve`) against the JAX package's.

Three tiers, all on the CPU:

- the pieces, in this process and without a runtime: the router's
  replica choices under one `random.seed`, the autoscaler's load folding
  and decisions over one script of snapshots and clock times,
  `@serve.batch`'s queue, the admission gate under a fake clock, the
  overload back-off, and the proxy's HTTP bytes for the same request
  bytes;
- end to end: `tests/torch_serve_scenarios.py` runs on the reference's
  in-process runtime in a child interpreter (its Serve leaves a thread
  that would keep this one from exiting) and on the port's here, and the
  results must be equal — a numpy model over handle and HTTP with two
  replicas, composition, batching, delete, a rolling update under load,
  `status()`, and TinyLM's tokens streamed over handle and HTTP;
- the transformer: the port's Serve `LLM` over `TransformerEngineModel`
  streams exactly the JAX engine's tokens at the narrow widths of
  `test_torch_engine.py`. And a child interpreter that served a request
  exits within 10 s of `shutdown()`.
"""

import asyncio
import importlib
import json
import math
import os
import random
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params

pytestmark = pytest.mark.cluster

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# The router's choices
# ---------------------------------------------------------------------------
ROUTE_CASES = {
    # name: (replicas, model ids, session ids)
    "p2c": (4, [None], [None]),
    "one_replica": (1, [None, "m"], [None, "s"]),
    "model_affinity": (3, ["m0", "m1", None], [None]),
    "sticky_sessions": (4, [None], ["s0", "s1", "s2", None]),
    "sticky_and_model": (5, ["m0", "m1"], ["s0", None]),
}


def _route_script(pkg, name, seed=3):
    """300 choices with in-flight counts that drift, and the affinity
    bookkeeping `assign` does after each choice."""
    n, models, sessions = ROUTE_CASES[name]
    router = _mod(pkg, "serve._private.router").Router(None, "d")
    router._apply({"version": 1,
                   "replicas": [(f"r{i}", None) for i in range(n)]})
    drift = np.random.default_rng(seed)
    random.seed(seed)
    picks = []
    for _ in range(300):
        rid = f"r{int(drift.integers(n))}"
        router._inflight[rid] = int(drift.integers(0, 12))
        model = models[int(drift.integers(len(models)))]
        session = sessions[int(drift.integers(len(sessions)))]
        chosen, _ = router._choose(model, session)
        picks.append(chosen)
        router._inflight[chosen] += 1
        if model:
            router._model_affinity[model] = chosen
        if session:
            router._session_affinity[session] = chosen
    return picks


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_router_choices_equal_reference(name):
    want = _route_script("ray_tpu", name)
    got = _route_script("ray_tpu_torch", name)
    assert got == want
    assert len(set(got)) == ROUTE_CASES[name][0]


# ---------------------------------------------------------------------------
# The autoscaler
# ---------------------------------------------------------------------------
def _snapshots(ongoing, queued, dead=0.0):
    """The process registry's snapshot shape: the replicas' gauges, a
    router's backlog, a dead replica's lingering gauge and another
    deployment's samples, which must not count."""
    samples = [{"tags": {"deployment": "d", "replica": rid}, "value": v}
               for rid, v in ongoing.items()]
    samples.append({"tags": {"deployment": "d", "replica": "d#dead"},
                    "value": dead})
    samples.append({"tags": {"deployment": "other", "replica": "o#0"},
                    "value": 50.0})
    return [
        {"name": "serve_replica_ongoing_requests", "type": "gauge",
         "samples": samples},
        {"name": "serve_deployment_queued_queries", "type": "gauge",
         "samples": [{"tags": {"deployment": "d"}, "value": queued},
                     {"tags": {"deployment": "other"}, "value": 9.0}]},
        {"name": "serve_router_requests", "type": "counter",
         "samples": [{"tags": {"deployment": "d"}, "value": 1000.0}]},
    ]


# (time, ongoing per live replica, queued): load rises, holds past the
# upscale delay, falls, flickers, and falls past the downscale delay.
SCALE_SCRIPT = [
    (0.0, {"d#0": 1, "d#1": 1}, 0), (0.1, {"d#0": 4, "d#1": 3}, 2),
    (0.3, {"d#0": 4, "d#1": 4}, 2), (0.7, {"d#0": 5, "d#1": 4}, 1),
    (0.8, {"d#0": 9, "d#1": 9}, 9), (1.0, {"d#0": 9, "d#1": 9}, 9),
    (1.4, {"d#0": 9, "d#1": 9}, 9), (1.5, {"d#0": 2, "d#1": 1}, 0),
    (2.0, {"d#0": 2, "d#1": 2}, 0), (2.2, {"d#0": 9, "d#1": 0}, 0),
    (2.3, {"d#0": 1, "d#1": 0}, 0), (3.0, {"d#0": 0, "d#1": 1}, 0),
    (4.4, {"d#0": 0, "d#1": 0}, 0), (4.6, {"d#0": 0, "d#1": 0}, 0),
]
TARGET, LOWEST, HIGHEST, UP_S, DOWN_S = 2.0, 1, 4, 0.5, 2.0


def _autoscale_run(pkg):
    ctl = _mod(pkg, "serve._private.controller")
    cfg = _mod(pkg, "serve.config")
    config = cfg.DeploymentConfig(autoscaling_config=cfg.AutoscalingConfig(
        min_replicas=LOWEST, max_replicas=HIGHEST,
        target_ongoing_requests=TARGET, upscale_delay_s=UP_S,
        downscale_delay_s=DOWN_S))
    state = ctl._DeploymentState(name="d", cls_factory=None, init_args=(),
                                 init_kwargs={}, config=config,
                                 target_replicas=1)
    state.replicas = [ctl._ReplicaState(handle=None, replica_id=f"d#{i}",
                                        version="v", state="RUNNING")
                      for i in range(2)]
    now = [0.0]
    snaps = []

    async def collect():
        return snaps[-1]

    fake_self = types.SimpleNamespace(_collect_metric_snapshots=collect)
    real_time = ctl.time
    ctl.time = types.SimpleNamespace(monotonic=lambda: now[0])
    out = []
    try:
        for t, ongoing, queued in SCALE_SCRIPT:
            now[0] = t
            snaps.append(_snapshots(ongoing, queued, dead=7.0))
            loads = ctl._deployment_load_from_samples(
                snaps[-1], "d", [r.replica_id for r in state.replicas])
            asyncio.run(ctl.ServeController._autoscale(fake_self, state))
            out.append((loads, state.target_replicas,
                        [r.ongoing for r in state.replicas]))
    finally:
        ctl.time = real_time
    return out


def _intended_targets():
    """controller.py's policy, written out: desired is ceil(total /
    target) clamped to [min, max]; a change lands only after the desire
    has held for the up- or downscale delay."""
    target, high_since, low_since, out = 1, None, None, []
    for t, ongoing, queued in SCALE_SCRIPT:
        desired = math.ceil((sum(ongoing.values()) + queued) / TARGET)
        desired = min(max(desired, LOWEST), HIGHEST)
        if desired > target:
            low_since = None
            high_since = t if high_since is None else high_since
            if t - high_since >= UP_S:
                target, high_since = desired, None
        elif desired < target:
            high_since = None
            low_since = t if low_since is None else low_since
            if t - low_since >= DOWN_S:
                target, low_since = desired, None
        else:
            high_since = low_since = None
        out.append(target)
    return out


def test_autoscale_decisions_equal_reference_and_intended():
    want = _autoscale_run("ray_tpu")
    got = _autoscale_run("ray_tpu_torch")
    assert got == want
    targets = [g[1] for g in got]
    assert targets == _intended_targets()
    assert max(targets) == HIGHEST and targets[-1] == LOWEST
    # The dead replica's gauge and the other deployment never count.
    loads, _, ongoing = got[4]
    assert loads == ({"d#0": 9.0, "d#1": 9.0}, 9.0) and ongoing == [9, 9]


# ---------------------------------------------------------------------------
# @serve.batch (the four cases of test_unit_serve_batching.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PKGS)
def test_batch_flush_timer_survives_first_awaiter_cancellation(pkg):
    _BatchQueue = _mod(pkg, "serve")._BatchQueue
    calls = []

    async def batched(owner, items):
        calls.append(list(items))
        return [x * 2 for x in items]

    async def main():
        q = _BatchQueue(batched, max_batch_size=8, wait_timeout_s=0.05)
        first = asyncio.ensure_future(q.submit(None, 1))
        await asyncio.sleep(0.01)
        first.cancel()
        with pytest.raises(asyncio.CancelledError):
            await first
        second = asyncio.ensure_future(q.submit(None, 2))
        return await asyncio.wait_for(second, timeout=2.0)

    assert asyncio.run(main()) == 4
    assert calls and 1 in calls[0] and 2 in calls[-1]


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_fn_exception_rejects_all_waiters(pkg):
    _BatchQueue = _mod(pkg, "serve")._BatchQueue

    async def batched(owner, items):
        raise ValueError("model exploded")

    async def main():
        q = _BatchQueue(batched, max_batch_size=4, wait_timeout_s=0.01)
        futs = [asyncio.ensure_future(q.submit(None, i)) for i in range(3)]
        return await asyncio.gather(*futs, return_exceptions=True)

    results = asyncio.run(main())
    assert len(results) == 3
    assert all(isinstance(r, ValueError) and "model exploded" in str(r)
               for r in results)


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_result_length_mismatch_rejects_all_waiters(pkg):
    _BatchQueue = _mod(pkg, "serve")._BatchQueue
    RayServeException = _mod(pkg, "serve.exceptions").RayServeException

    async def batched(owner, items):
        return [1]

    async def main():
        q = _BatchQueue(batched, max_batch_size=2, wait_timeout_s=0.01)
        futs = [asyncio.ensure_future(q.submit(None, i)) for i in range(2)]
        return await asyncio.gather(*futs, return_exceptions=True)

    assert all(isinstance(r, RayServeException) for r in asyncio.run(main()))


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_max_size_flushes_immediately(pkg):
    _BatchQueue = _mod(pkg, "serve")._BatchQueue
    calls = []

    async def batched(owner, items):
        calls.append(len(items))
        return items

    async def main():
        q = _BatchQueue(batched, max_batch_size=2, wait_timeout_s=5.0)
        return await asyncio.wait_for(
            asyncio.gather(q.submit(None, "a"), q.submit(None, "b")),
            timeout=2.0)

    assert tuple(asyncio.run(main())) == ("a", "b")
    assert calls == [2]


# ---------------------------------------------------------------------------
# The ingress: admission gate, overload back-off, HTTP bytes
# ---------------------------------------------------------------------------
GATE_SCRIPT = [(0.0, 0), (0.0, 1), (0.0, 2), (0.0, 1), (0.1, 0), (0.5, 0),
               (0.5, 0), (0.6, 3), (2.0, 0), (2.0, 0), (2.0, 0), (2.0, 0),
               (9.0, 4), (9.0, 1)]


def _gate_run(pkg):
    proxy = _mod(pkg, "serve._private.proxy")
    now = [0.0]
    real_time = proxy.time
    proxy.time = types.SimpleNamespace(monotonic=lambda: now[0])
    try:
        gate = proxy._AdmissionGate(max_inflight=3, rate=2.0, burst=2)
        out = []
        for t, inflight in GATE_SCRIPT:
            now[0] = t
            out.append(gate.check(inflight))
        gate.configure(None, None)
        out.append(gate.check(100))
        return out, gate.shed_503, gate.shed_429
    finally:
        proxy.time = real_time


def test_admission_gate_equals_reference():
    got = _gate_run("ray_tpu_torch")
    assert got == _gate_run("ray_tpu")
    decisions, shed_503, shed_429 = got
    assert "503" in decisions and "429" in decisions and None in decisions
    assert shed_503 == decisions.count("503")
    assert shed_429 == decisions.count("429")


def _overload_cases(pkg):
    exc = _mod(pkg, "exceptions")
    Overloaded = _mod(pkg, "serve.engine").EngineOverloadedError

    def overloaded(ra):
        e = Overloaded("queue full")
        e.retry_after_s = ra
        return e

    chained = RuntimeError("outer")
    chained.__cause__ = overloaded(0.4)
    wrapped = exc.RayTaskError.from_exception("f", overloaded(2.5))
    return [ValueError("x"), overloaded(2.5), overloaded(None),
            overloaded("junk"), chained,
            wrapped, wrapped.as_instanceof_cause(),
            exc.RayTaskError.from_exception("f", ValueError("y"))]


def test_overload_retry_after_equals_reference():
    got = [_mod("ray_tpu_torch", "serve._private.proxy")
           ._overload_retry_after(e) for e in _overload_cases(
               "ray_tpu_torch")]
    want = [_mod("ray_tpu", "serve._private.proxy")._overload_retry_after(e)
            for e in _overload_cases("ray_tpu")]
    assert got == want == [None, 2.5, 1.0, 1.0, 0.4, 2.5, 2.5, None]


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def write(self, data):
        self.buf += data

    async def drain(self):
        pass

    def close(self):
        pass


class _Response:
    def __init__(self, fn):
        self._fn = fn

    def result(self, timeout_s=None):
        return self._fn()


class _FakeHandle:
    """What the proxy calls on a DeploymentHandle."""

    def __init__(self, fn, method=None, stream=False):
        self._fn, self._method, self._stream = fn, method, stream

    def options(self, method_name=None, stream=None, **_):
        return _FakeHandle(self._fn, method_name or self._method,
                           bool(stream) or self._stream)

    def remote(self, payload):
        if self._stream:
            return iter(self._fn(self._method, payload))
        return _Response(lambda: self._fn(self._method, payload))


def _app(method, payload):
    """A deployment's behaviour by method name."""
    if method == "boom":
        raise KeyError("no such thing")
    if method == "busy":
        e = _app.overloaded("queue full")
        e.retry_after_s = 2.5
        raise e
    if method == "raw":
        return b"\x00\x01raw"
    if method == "text":
        return f"payload {payload!r}"
    if method == "tokens":
        return [payload["n"], payload["n"] + 1, {"done": True}]
    if method == "tokens_then_fail":
        return _fail_after(payload["n"])
    return {"echo": payload, "method": method}


def _fail_after(n):
    yield n
    raise RuntimeError("stream broke")


def _req(line, body=b"", headers=()):
    head = [line.encode() + b" HTTP/1.1", b"Host: localhost"]
    head += [h.encode() for h in headers]
    if body:
        head.append(b"Content-Length: " + str(len(body)).encode())
    return b"\r\n".join(head) + b"\r\n\r\n" + body


JSON = "Content-Type: application/json"
SSE = "Accept: text/event-stream"
PROXY_CASES = {
    "json": (_req("POST /m", b'{"x": [1, 2]}', [JSON]), None),
    "json_method": (_req("POST /m/sub?method=text", b'{"x": 1}', [JSON]),
                    None),
    "query": (_req("GET /m?a=1&b=two"), None),
    "bytes": (_req("GET /m?method=raw"), None),
    "not_found": (_req("GET /elsewhere"), None),
    "error_500": (_req("GET /m?method=boom"), None),
    "overloaded_503": (_req("GET /m?method=busy"), None),
    "keep_alive_two": (_req("POST /m", b'[1]', [JSON])
                       + _req("GET /m?method=text&q=2"), None),
    "sse": (_req("POST /m?method=tokens", b'{"n": 5}', [JSON, SSE]), None),
    "sse_query": (_req("POST /m?stream=1&method=tokens", b'{"n": 7}',
                       [JSON]), None),
    "sse_error": (_req("POST /m?method=tokens_then_fail", b'{"n": 1}',
                       [JSON, SSE]), None),
    "shed_503": (_req("GET /m?a=1"), (0, None)),
    "shed_429": (_req("GET /m?a=1") + _req("GET /m?a=2"), (None, 1e-9, 1)),
}


def _exchange(pkg, name):
    proxy_mod = _mod(pkg, "serve._private.proxy")
    _app.overloaded = _mod(pkg, "serve.engine").EngineOverloadedError
    request, gate = PROXY_CASES[name]
    proxy = proxy_mod.HTTPProxy(None)
    try:
        proxy._routes = {"/m": "M", "/": "Root"}
        proxy._handles["M"] = _FakeHandle(_app)
        proxy._handles["Root"] = _FakeHandle(_app, method="root")
        if name == "not_found":
            proxy._routes = {"/m": "M"}
        if gate is not None:
            proxy._gate.configure(*gate)

        async def go():
            reader = asyncio.StreamReader()
            reader.feed_data(request)
            reader.feed_eof()
            writer = _Writer()
            await proxy._handle_conn(reader, writer)
            return bytes(writer.buf)

        return asyncio.run(go())
    finally:
        proxy._stream_pool.shutdown(wait=True)


@pytest.mark.parametrize("name", sorted(PROXY_CASES))
def test_proxy_http_bytes_equal_reference(name):
    want = _exchange("ray_tpu", name)
    got = _exchange("ray_tpu_torch", name)
    assert got == want
    status = {"not_found": b"404", "error_500": b"500",
              "overloaded_503": b"503", "shed_503": b"503"}.get(name, b"200")
    assert got.startswith(b"HTTP/1.1 " + status)
    if name.startswith("sse"):
        assert b"Transfer-Encoding: chunked" in got and got.endswith(
            b"0\r\n\r\n")
    if name == "shed_429":
        assert b"429 Too Many Requests" in got
    if name == "overloaded_503":
        assert b"Retry-After: 3" in got


# ---------------------------------------------------------------------------
# End to end, against the reference in a child interpreter
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_results():
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_serve_scenarios.py"),
         "ray_tpu"], capture_output=True, text=True, timeout=180, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_results():
    sys.path.insert(0, HERE)
    scenarios = importlib.import_module("torch_serve_scenarios")
    before = set(threading.enumerate())
    ray_tpu_torch.init(local_mode=True)
    t0 = time.perf_counter()
    try:
        out = scenarios.run_all("ray_tpu_torch")
    finally:
        ray_tpu_torch.shutdown()
    out["_seconds"] = time.perf_counter() - t0
    out["_threads_left"] = sorted(
        t.name for t in set(threading.enumerate()) - before)
    return out


E2E_GROUPS = {
    "handle_and_http": ["handle", "http"],
    "spread_over_replicas": ["spread"],
    "status_shapes": ["status_keys", "replica_keys", "status_running",
                      "status_target"],
    "composition": ["composed", "child", "composed_http", "pipeline"],
    "batch": ["batched", "batch_folded"],
    "delete": ["tmp", "deleted"],
    "rolling_update": ["rolling"],
    "llm_streams": ["llm_stream", "llm_first_before_end", "llm_call",
                    "llm_async", "llm_sse", "llm_sse_chunked",
                    "llm_sse_first_before_end", "oracle"],
}


@pytest.mark.parametrize("group", sorted(E2E_GROUPS))
def test_serve_end_to_end_equals_reference(group, reference_results,
                                           port_results):
    for key in E2E_GROUPS[group]:
        got, want = port_results[key], reference_results[key]
        if key == "rolling":
            # The port drops no request (its handle re-sends one that
            # reaches a replica killed under it); the reference's may,
            # when its router's table lags the kill, so its errors are
            # not the bar.
            got, want = dict(got, errors=[]), dict(want, errors=[])
        assert got == want, key
    r = port_results
    if group == "handle_and_http":
        assert (r["handle"], r["http"]) == (18.0, 12.0)
    if group == "spread_over_replicas":
        assert r["spread"] == 2
    if group == "rolling_update":
        roll = r["rolling"]
        assert roll["errors"] == [] and roll["saw_v2"]
        assert roll["tail"] == ["v2"] * 5
        assert roll["final"] == [["v2", "RUNNING"], ["v2", "RUNNING"]]
    if group == "llm_streams":
        assert r["llm_stream"] == r["llm_call"] == r["llm_async"] \
            == r["oracle"][0]
        assert r["llm_sse"] == r["oracle"][1]
        assert r["llm_first_before_end"] and r["llm_sse_first_before_end"]


def test_serve_shutdown_leaves_no_thread(port_results):
    assert port_results["_threads_left"] == []


def _bare_controller(pkg):
    """A controller object with no runtime behind it (the reference's
    constructor reaches for a cluster's KV store) and no reconcile loop."""
    cls = _mod(pkg, "serve._private.controller").ServeController
    ctl = cls.__new__(cls)
    ctl._deployments, ctl._routes = {}, {"/": "d"}
    ctl._routes_version, ctl._shutdown = 3, False
    ctl._ensure_reconciler = lambda: None
    return ctl


@pytest.mark.parametrize("pkg", PKGS)
def test_long_poll_for_a_deployment_waits(pkg):
    """A router polls for its deployment alone and must wait out the
    timeout when nothing changes. The reference answers at once with the
    route table it was not asked for (so its routers spin); the port
    waits. Both answer a route listener that is behind."""
    ctl = _bare_controller(pkg)

    async def poll(versions):
        t0 = time.perf_counter()
        out = await ctl.listen_for_change(versions, timeout_s=0.3)
        return out, time.perf_counter() - t0

    routes, _ = asyncio.run(poll({"__routes__": 1}))
    assert routes == {"__routes__": {"version": 3, "routes": {"/": "d"}}}
    out, waited = asyncio.run(poll({"d": -1}))
    if pkg == "ray_tpu":
        assert "__routes__" in out and waited < 0.2
    else:
        assert out == {} and waited >= 0.29


def test_spans_chain_proxy_router_replica():
    """One HTTP request under an inbound traceparent records the proxy's,
    the router's and the replica's spans on that trace, each the parent
    of the next; an unsampled inbound trace records nothing."""
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.util import tracing

    inbound = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    unsampled = "00-" + "ef" * 16 + "-" + "cd" * 8 + "-00"
    ray_tpu_torch.init(local_mode=True)
    tracing.clear()
    tracing.enable_tracing()
    try:
        port = serve.start()
        serve.run(serve.deployment(Doubling).bind(), route_prefix="/d")
        for tp in (inbound, unsampled):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/d", data=b"21",
                headers={"Content-Type": "application/json",
                         "traceparent": tp})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read()) == 42
        spans = tracing.spans()
    finally:
        tracing.disable_tracing()
        serve.shutdown()
        ray_tpu_torch.shutdown()
    by_name = {s["name"]: s for s in spans
               if s["trace_id"] == "ab" * 16}
    assert sorted(by_name) == ["serve.proxy", "serve.replica",
                               "serve.router"]
    assert by_name["serve.proxy"]["parent_id"] == "cd" * 8
    assert (by_name["serve.router"]["parent_id"]
            == by_name["serve.proxy"]["span_id"])
    assert (by_name["serve.replica"]["parent_id"]
            == by_name["serve.router"]["span_id"])
    assert by_name["serve.replica"]["attributes"]["deployment"] == \
        "Doubling"
    assert not [s for s in spans if s["trace_id"] == "ef" * 16]


class Doubling:
    def __call__(self, x):
        return 2 * x


def test_rolling_update_builds_one_replica_per_version():
    """A 1-replica deployment rolled v1 -> v2 builds two replicas in all
    (the reference's surge slot builds a third and then stops it)."""
    from ray_tpu_torch import serve

    built = []

    class Built:
        def __init__(self, tag):
            built.append(tag)
            self.tag = tag

        def __call__(self, _):
            return self.tag

    ray_tpu_torch.init(local_mode=True)
    try:
        dep = serve.deployment(Built, version="v1")
        h = serve.run(dep.bind("v1"), route_prefix="/b")
        serve.run(dep.options(version="v2").bind("v2"), route_prefix="/b")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            reps = serve.status()["Built"]["replicas"]
            if [(r["version"], r["state"]) for r in reps] == [
                    ("v2", "RUNNING")]:
                break
            time.sleep(0.02)
        time.sleep(0.5)       # a spare replica would have started by now
        answer = h.remote(None).result(timeout_s=30)
        reps = serve.status()["Built"]["replicas"]
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert answer == "v2" and len(reps) == 1
    assert built == ["v1", "v2"]


# ---------------------------------------------------------------------------
# The transformer through Serve
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128)
ENGINE = dict(max_batch_size=4, block_size=8, num_blocks=32)
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(2, 64, n)]
           for s, n in ((1, 5), (2, 17), (3, 9))]
NEW = 8


def _jax_params():
    jcfg = JaxConfig(dtype=jnp.float32, **TINY)
    return jax_init_params(jax.random.PRNGKey(0), jcfg), jcfg


_PARAMS = {}


def tiny_model_factory():
    """The port's engine model over the JAX parameters (what a deployment
    takes as an init argument)."""
    from ray_tpu_torch.models import TransformerConfig, params_from_jax
    from ray_tpu_torch.serve.engine import TransformerEngineModel

    if "p" not in _PARAMS:
        jparams, _ = _jax_params()
        _PARAMS["p"] = params_from_jax(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    return TransformerEngineModel(_PARAMS["p"], cfg, device="cpu")


class TransformerLLM:
    def __init__(self, factory):
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        self.engine = InferenceEngine(factory(), EngineConfig(**ENGINE))
        self.engine.start()

    def generate(self, req):
        yield from self.engine.submit(req["prompt"], req["max_new_tokens"])

    async def __call__(self, req):
        stream = self.engine.submit(req["prompt"], req["max_new_tokens"])
        return [tok async for tok in stream]

    def stop_engine(self):
        self.engine.stop()
        return True


def test_transformer_llm_through_serve_equals_jax_engine():
    import ray_tpu.serve.engine as jax_engine
    from ray_tpu_torch import serve

    jparams, jcfg = _jax_params()
    want = []
    for prompt in PROMPTS:
        eng = jax_engine.InferenceEngine(
            jax_engine.TransformerEngineModel(jparams, jcfg),
            jax_engine.EngineConfig(**ENGINE))
        stream = eng.submit(prompt, NEW)
        while eng.step():
            pass
        want.append(stream.tokens_so_far())

    ray_tpu_torch.init(local_mode=True)
    try:
        handle = serve.run(
            serve.deployment(TransformerLLM, version="v1").bind(
                tiny_model_factory), route_prefix="/llm")
        port = serve.start()
        sys.path.insert(0, HERE)
        sse_tokens = importlib.import_module(
            "torch_serve_scenarios").sse_tokens
        streamed, called, over_http = [], [], []
        for prompt in PROMPTS:
            req = {"prompt": prompt, "max_new_tokens": NEW}
            gen = handle.options(stream=True, method_name="generate").remote(
                req)
            streamed.append(list(gen))
            called.append(handle.remote(req).result(timeout_s=60))
            over_http.append(sse_tokens(
                port, "/llm?method=generate&stream=1", req)[0])
        handle.options(method_name="stop_engine").remote().result(
            timeout_s=30)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert all(type(t) is int for s in streamed for t in s)
    assert streamed == want
    assert called == want
    assert over_http == want


# ---------------------------------------------------------------------------
# Versions and exit
# ---------------------------------------------------------------------------
def _versioned_class(body: str):
    ns = {}
    exec(f"class Echo:\n"
         f"    def __init__(self, tag):\n"
         f"        self.tag = tag\n"
         f"    def __call__(self, _):\n"
         f"        {body}\n", ns)
    return ns["Echo"]


def test_auto_version_follows_code_and_args():
    ctl = _mod("ray_tpu_torch", "serve._private.controller")
    a = _versioned_class("return self.tag")
    a2 = _versioned_class("return self.tag")
    b = _versioned_class("return self.tag + '!'")
    v = ctl._auto_version
    assert v(a, ("x",), {}) == v(a, ("x",), {}) == v(a2, ("x",), {})
    assert v(a, ("x",), {}) != v(a, ("y",), {})
    assert v(a, ("x",), {}) != v(a, (), {"tag": "x"})
    assert v(a, ("x",), {}) != v(b, ("x",), {})
    assert v(a, (lambda: 1,), {}) is None            # does not pickle
    assert v(a, (torch.zeros(2, device="meta"),), {}) is None   # a device
    assert v(a, (torch.zeros(2),), {}) is not None   # host tensors pickle


def test_unversioned_redeploy_rolls_only_on_change():
    from ray_tpu_torch import serve

    def replica_ids():
        return [r["id"] for r in serve.status()["Echo"]["replicas"]]

    def settle(old):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            reps = serve.status()["Echo"]["replicas"]
            if (len(reps) == 1 and reps[0]["state"] == "RUNNING"
                    and reps[0]["id"] not in old):
                return reps[0]["id"]
            time.sleep(0.05)
        return None

    ray_tpu_torch.init(local_mode=True)
    try:
        dep = serve.deployment(_versioned_class("return self.tag"),
                               name="Echo")
        h = serve.run(dep.bind("a"), route_prefix="/echo")
        first = replica_ids()
        serve.run(dep.bind("a"), route_prefix="/echo")
        time.sleep(0.5)
        same = replica_ids()
        serve.run(dep.bind("b"), route_prefix="/echo")
        rolled_arg = settle(first)
        answer_b = h.remote(None).result(timeout_s=30)
        changed = serve.deployment(_versioned_class("return self.tag * 2"),
                                   name="Echo")
        serve.run(changed.bind("b"), route_prefix="/echo")
        rolled_code = settle([rolled_arg])
        answer_bb = h.remote(None).result(timeout_s=30)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert same == first
    assert rolled_arg is not None and rolled_code is not None
    assert (answer_b, answer_bb) == ("b", "bb")


EXIT_CHILD = """
import json, threading, time, urllib.request
import ray_tpu_torch
from ray_tpu_torch import serve

class Echo:
    async def __call__(self, req):
        return {"echo": req}

ray_tpu_torch.init(local_mode=True)
port = serve.start()
serve.run(serve.deployment(Echo).bind(), route_prefix="/echo")
req = urllib.request.Request(
    f"http://127.0.0.1:{port}/echo", data=json.dumps([1, 2]).encode(),
    headers={"Content-Type": "application/json"})
answer = json.loads(urllib.request.urlopen(req, timeout=30).read())
serve.shutdown()
ray_tpu_torch.shutdown()
print(json.dumps({"answer": answer, "shut_at": time.time(),
                  "threads": [t.name for t in threading.enumerate()]}),
      flush=True)
"""


def test_child_that_served_exits_promptly():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", EXIT_CHILD],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    exited_at = time.time()
    assert proc.returncode == 0, err[-4000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert got["answer"] == {"echo": [1, 2]}
    assert got["threads"] == ["MainThread"]
    assert exited_at - got["shut_at"] < 10.0
