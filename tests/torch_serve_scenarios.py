"""Serve scenarios run on either package's in-process runtime, for
`tests/test_torch_serve.py`: the port (`ray_tpu_torch`) in the test
process, the JAX package (`ray_tpu`) in a child interpreter, since its
in-process Serve leaves a thread that keeps the interpreter from exiting.

    python tests/torch_serve_scenarios.py ray_tpu

prints one JSON object of results and leaves with `os._exit`. The module
imports neither package at its top, so either side can load it. The
deployment classes live at the top of the module, so a pickler takes them
by reference (the reference's controller pickles every deployment's
class into its checkpoint).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import socket
import sys
import threading
import time
import urllib.request

_DONE = b"0\r\n\r\n"


def _post(port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def sse_tokens(port, path, payload, timeout=60):
    """POST with `Accept: text/event-stream`; (tokens, head, seconds to
    the first event, seconds to the end)."""
    body = json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as sock:
        sock.sendall(
            b"POST " + path.encode() + b" HTTP/1.1\r\nHost: localhost\r\n"
            b"Accept: text/event-stream\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
            + body)
        buf = b""
        first = None
        t0 = time.perf_counter()
        while _DONE not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError(f"closed early: {buf!r}")
            buf += chunk
            if first is None and b"data: " in buf:
                first = time.perf_counter() - t0
        total = time.perf_counter() - t0
    head = buf.partition(b"\r\n\r\n")[0]
    tokens = [int(line.split(b"data: ")[1]) for line in buf.split(b"\n")
              if line.startswith(b"data: ")]
    return tokens, head.decode(), first, total


def _running(serve, name):
    return [r for r in serve.status()[name]["replicas"]
            if r["state"] == "RUNNING"]


def _wait_running(serve, name, n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(_running(serve, name)) == n:
            return True
        time.sleep(0.05)
    return False


class Model:
    def __init__(self, scale):
        import numpy as np

        self.np = np
        self.scale = scale

    def __call__(self, req):
        x = self.np.asarray(req["x"], self.np.float32)
        return {"y": float((x * self.scale).sum()), "who": id(self)}


class Doubler:
    def __call__(self, x):
        return x * 2


class Ingress:
    def __init__(self, doubler, bias):
        self.doubler = doubler
        self.bias = bias

    async def __call__(self, x):
        y = await self.doubler.remote(x)
        return y + self.bias


class Pre:
    def __call__(self, x):
        return [v * 2 for v in x]


class Summer:
    def __call__(self, x):
        return sum(x)


class Pipeline:
    def __init__(self, pre, model):
        self.pre, self.model = pre, model

    def __call__(self, req):
        half = self.pre.remote(req["x"]).result(timeout_s=30)
        return {"y": self.model.remote(half).result(timeout_s=30)}


class Batched:
    """`handle` is set by `run_all` to the package's `serve.batch` of
    `_double`."""

    def __init__(self):
        self.sizes = []

    async def _double(self, items):
        self.sizes.append(len(items))
        return [x * 2 for x in items]

    async def __call__(self, x):
        return await self.handle(x)

    def batch_sizes(self):
        return self.sizes


class Tmp:
    def __call__(self, _):
        return 1


class Versioned:
    def __init__(self, tag):
        self.tag = tag

    def __call__(self, _):
        time.sleep(0.01)
        return self.tag


class LLM:
    """The TinyLM engine in a replica, as the engine's documentation
    writes it: a sync generator that streams and an async `__call__`."""

    def __init__(self, pkg_name, delay):
        eng = importlib.import_module(f"{pkg_name}.serve.engine")
        self.engine = eng.InferenceEngine(
            eng.TinyLM(step_delay_s=delay),
            eng.EngineConfig(max_batch_size=8, block_size=8,
                             num_blocks=64, max_queue=64))
        self.engine.start()

    def generate(self, req):
        stream = self.engine.submit(req["prompt"],
                                    req.get("max_new_tokens", 8))
        for tok in stream:
            yield tok

    async def __call__(self, req):
        stream = self.engine.submit(req["prompt"],
                                    req.get("max_new_tokens", 8))
        return [tok async for tok in stream]

    def stop_engine(self):
        self.engine.stop()
        return True


def run_all(pkg_name: str) -> dict:
    """Every scenario on `pkg_name`'s runtime and Serve; the results, as
    plain JSON values."""
    pkg = importlib.import_module(pkg_name)
    serve = importlib.import_module(f"{pkg_name}.serve")
    TinyLM = importlib.import_module(f"{pkg_name}.serve.engine").TinyLM
    out: dict = {}
    port = serve.start()

    # -- a numpy model over handle and HTTP, two replicas -------------------
    handle = serve.run(serve.deployment(num_replicas=2)(Model).bind(3.0),
                       route_prefix="/model")
    out["handle"] = handle.remote({"x": [1, 2, 3]}).result(timeout_s=30)["y"]
    out["http"] = _post(port, "/model", {"x": [2, 2]})["y"]
    _wait_running(serve, "Model", 2)
    whos = {handle.remote({"x": [1]}).result(timeout_s=30)["who"]
            for _ in range(20)}
    out["spread"] = len(whos)
    st = serve.status()
    out["status_keys"] = sorted(st["Model"])
    out["replica_keys"] = sorted(st["Model"]["replicas"][0])
    out["status_running"] = len(_running(serve, "Model"))
    out["status_target"] = st["Model"]["target_replicas"]

    # -- composition through handles -----------------------------------------
    dep = serve.deployment
    comp = serve.run(dep(Ingress).bind(dep(Doubler).bind(), 3),
                     route_prefix="/comp")
    out["composed"] = comp.remote(5).result(timeout_s=30)
    out["child"] = serve.get_deployment_handle("Doubler").remote(7).result(
        timeout_s=30)
    out["composed_http"] = _post(port, "/comp", 4)
    pipe = serve.run(dep(Pipeline).bind(dep(Pre).bind(), dep(Summer).bind()),
                     route_prefix="/pipe")
    out["pipeline"] = pipe.remote({"x": [1, 2, 3]}).result(timeout_s=30)

    # -- @serve.batch ---------------------------------------------------------
    Batched.handle = serve.batch(max_batch_size=8,
                                 batch_wait_timeout_s=0.2)(Batched._double)
    bh = serve.run(dep(max_ongoing_requests=16)(Batched).bind(),
                   route_prefix="/batched")
    resps = [bh.remote(i) for i in range(8)]
    out["batched"] = [r.result(timeout_s=30) for r in resps]
    sizes = bh.options(method_name="batch_sizes").remote().result(
        timeout_s=30)
    out["batch_folded"] = max(sizes) > 1 and sum(sizes) == 8

    # -- delete ---------------------------------------------------------------
    th = serve.run(dep(Tmp).bind(), route_prefix="/tmp")
    out["tmp"] = th.remote(None).result(timeout_s=30)
    serve.delete("Tmp")
    out["deleted"] = "Tmp" not in serve.status()

    # -- a rolling update under load ------------------------------------------
    versioned = dep(num_replicas=2, version="v1")(Versioned)
    vh = serve.run(versioned.bind("v1"), route_prefix="/v")
    first = vh.remote(None).result(timeout_s=30)
    stop = threading.Event()
    errors, seen = [], []

    def hammer():
        while not stop.is_set():
            try:
                seen.append(vh.remote(None).result(timeout_s=60))
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    serve.run(versioned.options(version="v2").bind("v2"), route_prefix="/v")
    deadline = time.monotonic() + 60
    try:
        while time.monotonic() < deadline:
            reps = serve.status()["Versioned"]["replicas"]
            if (len(reps) == 2 and all(r["version"] == "v2"
                                       and r["state"] == "RUNNING"
                                       for r in reps)):
                n = len(seen)
                time.sleep(0.2)
                if seen[n:] and all(tag == "v2" for tag in seen[n:]):
                    break
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    out["rolling"] = {
        "first": first, "errors": errors[:1], "saw_v1": "v1" in seen,
        "saw_v2": "v2" in seen, "tail": seen[-5:],
        "final": sorted([r["version"], r["state"]] for r in
                        serve.status()["Versioned"]["replicas"])}

    # -- the TinyLM engine in a replica ----------------------------------------
    lh = serve.run(dep(max_ongoing_requests=32)(LLM).bind(pkg_name, 0.05),
                   route_prefix="/llm")
    req = {"prompt": [5, 9, 3], "max_new_tokens": 10}
    gen = lh.options(stream=True, method_name="generate").remote(req)
    it = iter(gen)
    first_tok = next(it)
    first_completed = gen.completed()
    out["llm_stream"] = [first_tok] + list(it)
    out["llm_first_before_end"] = not first_completed
    out["llm_call"] = lh.remote(req).result(timeout_s=30)

    async def consume():
        agen = lh.options(stream=True, method_name="generate").remote(req)
        return [tok async for tok in agen]

    out["llm_async"] = asyncio.run(consume())
    tokens, head, t_first, t_total = sse_tokens(
        port, "/llm?stream=1&method=generate",
        {"prompt": [7, 2], "max_new_tokens": 8})
    out["llm_sse"] = tokens
    out["llm_sse_chunked"] = ("Transfer-Encoding: chunked" in head
                              and "text/event-stream" in head)
    out["llm_sse_first_before_end"] = t_first < t_total
    out["oracle"] = [TinyLM().oracle([5, 9, 3], 10),
                     TinyLM().oracle([7, 2], 8)]
    lh.options(method_name="stop_engine").remote().result(timeout_s=30)
    serve.shutdown()
    pkg.shutdown()
    return out


def main(name: str) -> None:
    import traceback

    pkg = importlib.import_module(name)
    pkg.init(local_mode=True)
    code = 0
    try:
        print(json.dumps(run_all(name)), flush=True)
    except BaseException:  # noqa: BLE001
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # The reference's in-process Serve leaves a thread parked in an actor
    # coroutine that never ends; the interpreter would wait for it at exit.
    os._exit(code)


if __name__ == "__main__":
    # Import this file under its own name, so its classes pickle by
    # reference rather than as members of __main__.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    importlib.import_module("torch_serve_scenarios").main(sys.argv[1])
