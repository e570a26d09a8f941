"""What `test_torch_cluster.py` and `test_torch_serve_cluster.py` share: the
scenarios both packages' cluster runtimes run, the functions and classes
those scenarios send to workers, the leak reaper of the port's processes
and each test's deadline.

This module imports neither jax nor torch at its top: the port's worker
processes import it to find the functions and classes a test sends them
(the port exports them by reference), and the reference's side runs it as
a child interpreter's main file:

    python tests/torch_cluster_helpers.py ray_tpu core|devices|serve

which prints one JSON line of results and leaves with `os._exit`, so
that nothing the reference sets in its process (environment variables,
threads) reaches the port's side.
"""

import asyncio
import faulthandler
import hashlib
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# A test that runs longer than this dumps every thread's stack and ends
# its pytest process (a failure the suite reports) instead of hanging it.
TEST_DEADLINE_S = 300.0
# The reference's side, in its child interpreter, gets this long.
CHILD_TIMEOUT_S = 240.0
# Processes of a cluster that shut down get this long to exit.
EXIT_GRACE_S = 10.0

PORT_MODULES = ("ray_tpu_torch.core.raylet", "ray_tpu_torch.core.gcs.server",
                "ray_tpu_torch.core.worker_main")


# ---------------------------------------------------------------------------
# Deadlines and the leak reaper
# ---------------------------------------------------------------------------
def port_processes():
    """(pid, argv) of this test session's port daemons and workers: a
    `python -m ray_tpu_torch.core.*` process whose environment carries
    this session's RAY_TPU_TEST_SESSION."""
    marker = "RAY_TPU_TEST_SESSION=" + os.environ.get(
        "RAY_TPU_TEST_SESSION", str(os.getpid()))
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0") if a]
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().decode("utf-8", "replace").split("\0")
        except OSError:
            continue
        if marker not in env:
            continue
        if any(a == "-m" and b in PORT_MODULES
               for a, b in zip(argv, argv[1:])):
            found.append((int(entry), " ".join(argv[1:4])))
    return found


def wait_no_port_processes(timeout: float = EXIT_GRACE_S):
    """The port processes still alive after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    left = port_processes()
    while left and time.monotonic() < deadline:
        time.sleep(0.2)
        left = port_processes()
    return left


@pytest.fixture(scope="module", autouse=True)
def no_leaked_port_processes(request):
    """Fail the module that leaves a port process behind (killing it)."""
    yield
    left = wait_no_port_processes()
    for pid, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    if left:
        pytest.fail(f"{request.module.__name__} leaked port processes "
                    f"(killed): {left}", pytrace=False)


@pytest.fixture(autouse=True)
def per_test_deadline():
    """Every test's own deadline."""
    faulthandler.dump_traceback_later(TEST_DEADLINE_S, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def run_reference(what: str) -> dict:
    """The reference's results of scenario set `what`, from a child
    interpreter, run with its cluster at the port's lower priority
    (NICENESS)."""
    proc = subprocess.run(
        ["nice", "-n", str(NICENESS), sys.executable,
         os.path.abspath(__file__), "ray_tpu", what],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"reference child ({what}) exited {proc.returncode}:\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def start(pkg, **kwargs):
    """`init` of a cluster for `pkg` with its devices: the reference
    counts two TPU chips, the port two GPUs (faked on the CPU)."""
    if pkg.__name__ == "ray_tpu":
        return pkg.init(num_cpus=4, resources={"TPU": 2}, **kwargs)
    return niced(lambda: pkg.init(num_cpus=4, num_gpus=2, **kwargs))


# How much lower the port's test clusters run than the rest of the suite
# (the reference's side runs under `nice -n` of the same): their workers
# import torch and JAX while other modules' clusters time their tasks.
NICENESS = 10


def niced(start_cluster):
    """`start_cluster()` with this process's niceness raised by NICENESS,
    so that the GCS, raylet and workers it spawns inherit it; then this
    process's own niceness back (where the process may lower it)."""
    old = os.getpriority(os.PRIO_PROCESS, 0)
    os.setpriority(os.PRIO_PROCESS, 0, old + NICENESS)
    try:
        return start_cluster()
    finally:
        try:
            os.setpriority(os.PRIO_PROCESS, 0, old)
        except PermissionError:
            pass  # unprivileged: this test process stays lower too


# ---------------------------------------------------------------------------
# What the scenarios send to workers (module level: exported by reference)
# ---------------------------------------------------------------------------
def add(a, b):
    return a + b


def two(x):
    return x, x + 1


def total(refs, pkg_name):
    return sum(importlib.import_module(pkg_name).get(refs, timeout=60))


def boom(msg):
    raise ValueError(msg)


def die_once(marker):
    """SIGKILL this worker the first time; return on the retry."""
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("1")
        os.kill(os.getpid(), signal.SIGKILL)
    return "survived"


def spin(started, seconds):
    """Announce the start in a file, then wait in short sleeps (an
    asynchronous cancel lands between them)."""
    with open(started, "w") as f:
        f.write("1")
    for _ in range(int(seconds / 0.05)):
        time.sleep(0.05)
    return "finished"


def gc_churn(started, seconds):
    """Announce the start in a file, then make cyclic garbage and collect
    it in a tight loop over a heap of 200,000 live lists, for `seconds`:
    the thread spends nearly all its time inside `gc.collect()`, so an
    asynchronous cancel nearly always lands while the gc callbacks (the
    flight recorder's `_gc_callback`) run, where Python reports it as
    "Exception ignored" and swallows it."""
    import gc

    keep = [[i] for i in range(200_000)]
    with open(started, "w") as f:
        f.write("1")
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        cycle = []
        cycle.append(cycle)
        del cycle
        gc.collect()
    return len(keep)


def churn_then_clean_up(started, cleaned, seconds):
    """`gc_churn` until cancelled; the cancel caught, 200 ms of cleanup
    that keeps collecting, then a file with the cleanup's collections."""
    import gc

    from ray_tpu_torch.exceptions import TaskCancelledError

    try:
        gc_churn(started, seconds)
        return "ran out"
    except TaskCancelledError:
        end = time.monotonic() + 0.2
        collections = 0
        while time.monotonic() < end:
            cycle = []
            cycle.append(cycle)
            del cycle
            gc.collect()
            collections += 1
        with open(cleaned, "w") as f:
            f.write(str(collections))
        return "cleaned up"


class Churner:
    """`gc_churn` and a nap as an actor's methods: two run at once in one
    process when the actor has max_concurrency=2."""

    def churn(self, started, seconds):
        return gc_churn(started, seconds)

    def nap(self, started, seconds):
        """One sleep: a cancel sent meanwhile waits until it returns."""
        with open(started, "w") as f:
            f.write("1")
        time.sleep(seconds)
        return "woke"


def probe(x):
    return x


def sleep_then(seconds, value):
    time.sleep(seconds)
    return value


def device_env(var):
    """This worker's (visibility variable, pid)."""
    return os.environ.get(var), os.getpid()


def pid_of(instance):
    """`__ray_call__` body: the actor's process id."""
    return os.getpid()


class Counter:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n

    def pid(self):
        return os.getpid()


class DeviceHolder:
    def env(self, var):
        return device_env(var)


class AsyncWorker:
    async def work(self, i):
        await asyncio.sleep(0.3)
        return i


# ---------------------------------------------------------------------------
# Core scenarios
# ---------------------------------------------------------------------------
def _error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def core_scenarios(pkg) -> dict:
    """Tasks, actors and objects on a running cluster of `pkg`."""
    from importlib import import_module

    exc = import_module(pkg.__name__ + ".exceptions")
    get = pkg.get
    out = {}
    r_add, r_two = pkg.remote(add), pkg.remote(two)
    out["add"] = get(r_add.remote(2, 3), timeout=60)
    a, b = r_two.options(num_returns=2).remote(7)
    out["two"] = get([a, b], timeout=60)
    refs = [pkg.put(i) for i in range(5)]
    out["nested"] = get(pkg.remote(total).remote(refs, pkg.__name__),
                        timeout=60)
    try:
        get(pkg.remote(boom).remote("no good"), timeout=60)
        out["error"] = None
    except Exception as e:
        out["error"] = [type(e).__name__, isinstance(e, exc.RayTaskError),
                        isinstance(e, ValueError),
                        type(e.cause).__name__, str(e.cause)]
    with tempfile.TemporaryDirectory() as tmp:
        marker = os.path.join(tmp, "died")
        out["retry"] = get(pkg.remote(die_once).options(max_retries=2)
                           .remote(marker), timeout=120)
        out["retried"] = os.path.exists(marker)
        started = os.path.join(tmp, "started")
        ref = pkg.remote(spin).remote(started, 60.0)
        deadline = time.monotonic() + 60
        while not os.path.exists(started) and time.monotonic() < deadline:
            time.sleep(0.02)
        pkg.cancel(ref)
        out["cancel"] = _error(lambda: get(ref, timeout=60))

    counter_cls = pkg.remote(Counter)
    c = counter_cls.remote()
    out["ordered"] = get([c.inc.remote() for _ in range(100)], timeout=60)
    named = counter_cls.options(name="the_counter").remote()
    get(named.inc.remote(), timeout=60)
    out["named"] = get(pkg.get_actor("the_counter").inc.remote(), timeout=60)
    pkg.kill(c)
    out["killed"] = _error(lambda: get(c.inc.remote(), timeout=60))
    r = counter_cls.options(max_restarts=1).remote()
    get(r.inc.remote(), timeout=60)
    old = get(r.pid.remote(), timeout=60)
    os.kill(old, signal.SIGKILL)
    deadline = time.monotonic() + 90
    after = None
    while time.monotonic() < deadline:
        try:
            after = [get(r.inc.remote(), timeout=30),
                     get(r.pid.remote(), timeout=30) != old]
            break
        except Exception:
            time.sleep(0.2)
    out["restarted"] = after
    w = pkg.remote(AsyncWorker).remote()
    get(w.work.remote(-1), timeout=60)
    t0 = time.monotonic()
    out["async"] = get([w.work.remote(i) for i in range(5)], timeout=60)
    out["async_concurrent"] = time.monotonic() - t0 < 5 * 0.3

    arr = np.random.default_rng(0).integers(0, 256, 8 << 20, dtype=np.uint8)
    big = pkg.put(arr)
    got = get(big, timeout=60)
    out["put_get"] = [got.dtype.str, list(got.shape),
                      hashlib.sha256(got.tobytes()).hexdigest()
                      == hashlib.sha256(arr.tobytes()).hexdigest()]
    del got
    slow = [pkg.remote(sleep_then).remote(0.0, 1),
            pkg.remote(sleep_then).remote(20.0, 2)]
    ready, rest = pkg.wait(slow, num_returns=1, timeout=15)
    ready2, rest2 = pkg.wait(slow, num_returns=2, timeout=0.5)
    out["wait"] = [len(ready), len(rest), len(ready2), len(rest2),
                   get(ready[0], timeout=60)]
    rt = import_module(pkg.__name__ + ".core.worker").current_runtime()
    oid = big.hex()
    held = any(o.get("object_id") == oid for o in rt.object_store_stats())
    del big
    deadline = time.monotonic() + 30
    freed = False
    while time.monotonic() < deadline and not freed:
        freed = not any(o.get("object_id") == oid
                        for o in rt.object_store_stats())
        time.sleep(0.1)
    out["freed"] = [held, freed]

    # Task events and the timeline built from them (each worker flushes
    # its events within a second).
    get([pkg.remote(probe).options(_metadata={"inline": False}).remote(i)
         for i in range(3)], timeout=60)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        events = [(e["event"]) for e in rt.task_events()
                  if e.get("name") == "probe"]
        if events.count("FINISHED") == 3:
            break
        time.sleep(0.2)
    out["task_events"] = sorted(events)
    out["timeline"] = sorted({e["ph"] + ":" + e["name"]
                              for e in pkg.timeline()
                              if "probe" in e["name"]})
    return out


# ---------------------------------------------------------------------------
# Device leases
# ---------------------------------------------------------------------------
def _dev(pkg, n):
    if pkg.__name__ == "ray_tpu":
        return {"resources": {"TPU": n}}
    return {"num_gpus": n}


def device_scenarios(pkg) -> dict:
    """A fixed sequence of whole-device leases, then two half-device
    actors and a task with no device."""
    var = "TPU_VISIBLE_CHIPS" if pkg.__name__ == "ray_tpu" else \
        "CUDA_VISIBLE_DEVICES"
    get = pkg.get
    task = pkg.remote(device_env)
    holder = pkg.remote(DeviceHolder)
    seq, pids = [], []

    def lease_task(n):
        ids, pid = get(task.options(**_dev(pkg, n)).remote(var), timeout=120)
        seq.append(ids)
        pids.append(pid)

    lease_task(1)
    x = holder.options(**_dev(pkg, 1)).remote()
    ids, pid = get(x.env.remote(var), timeout=120)
    seq.append(ids)
    pids.append(pid)
    lease_task(1)
    pkg.kill(x)
    lease_task(2)
    lease_task(1)
    # In a worker (not inlined into the driver, which the runtime may do
    # for a quick task it has timed before).
    plain = get(task.options(_metadata={"inline": False}).remote(var),
                timeout=120)
    halves = [holder.options(**_dev(pkg, 0.5)).remote() for _ in range(2)]
    half_ids = [get(h.env.remote(var), timeout=120)[0] for h in halves]
    for h in halves:
        pkg.kill(h)
    return {"sequence": seq,
            "device_workers_distinct": len(set(pids)) == len(pids),
            "plain": plain[0], "plain_reused": plain[1] in pids,
            "halves": half_ids}


# ---------------------------------------------------------------------------
# Exporting code from a driver's __main__
# ---------------------------------------------------------------------------
MAIN_SCRIPT = '''
import json, os, sys

def square(x):
    return x * x

class Acc:
    def __init__(self, start):
        self.v = start

    def add(self, x):
        self.v += x
        return self.v

if __name__ == "__main__":
    pkg = __import__(sys.argv[1])
    pkg.init(num_cpus=2)
    try:
        out = {"square": pkg.get(pkg.remote(square).remote(7), timeout=60),
               "acc": pkg.get(pkg.remote(Acc).remote(10).add.remote(5),
                              timeout=60),
               "main_pid": os.getpid()}
    finally:
        pkg.shutdown()
    print(json.dumps(out), flush=True)
    os._exit(0)
'''


def run_main_script(pkg_name: str, directory: str) -> dict:
    path = os.path.join(directory, f"main_{pkg_name}.py")
    with open(path, "w") as f:
        f.write(MAIN_SCRIPT)
    proc = subprocess.run([sys.executable, path, pkg_name],
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"{pkg_name} main script exited {proc.returncode}:\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------
class Echo:
    """A module-level deployment class (the controller's checkpoint and
    the replicas' processes take it by reference)."""

    def __init__(self, tag):
        self.tag = tag

    def __call__(self, req):
        return {"tag": self.tag, "echo": req}

    def pid(self):
        return os.getpid()


class TinyLLM:
    """The small transformer's engine in a replica process, on the CPU,
    over parameters that arrive as numpy arrays in the reference's
    layout."""

    def __init__(self, np_params, tiny, engine):
        import torch

        from ray_tpu_torch.models import TransformerConfig, params_from_jax
        from ray_tpu_torch.serve.engine import (EngineConfig,
                                                InferenceEngine,
                                                TransformerEngineModel)

        cfg = TransformerConfig(dtype=torch.float32, **tiny)
        model = TransformerEngineModel(params_from_jax(np_params, "cpu"),
                                       cfg, device="cpu")
        self.engine = InferenceEngine(model, EngineConfig(**engine))
        self.engine.start()

    def generate(self, req):
        yield from self.engine.submit(req["prompt"], req["max_new_tokens"])

    def pid(self):
        return os.getpid()


def http(port: int, path: str, payload=None, timeout: float = 30.0) -> bytes:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


class Hammer:
    """HTTP requests in a loop on a thread, every answer checked."""

    def __init__(self, port: int, path: str, want_tags):
        self.port, self.path, self.want = port, path, set(want_tags)
        self.ok = self.failed = 0
        self.errors = []
        self.tags = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                body = json.loads(http(self.port, self.path, [1]))
                assert body["tag"] in self.want, body
                self.tags.append(body["tag"])
                self.ok += 1
            except Exception as e:
                self.failed += 1
                self.errors.append(repr(e)[:200])
            time.sleep(0.05)

    def stop(self):
        self._stop.set()
        self._thread.join(60)
        return {"ok": self.ok, "failed": self.failed,
                "errors": self.errors[:3]}


def _serve_status(serve, name):
    return serve.status().get(name, {}).get("replicas", [])


def _wait_for(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            value = cond()
        except Exception:
            value = None
        if value:
            return value
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {what}")


def serve_scenarios(pkg) -> dict:
    """Serve on a running cluster of `pkg`: replicas as processes, HTTP
    bytes, a rolling update under traffic, a replica's SIGKILL and the
    controller's SIGKILL under traffic, then shutdown."""
    from importlib import import_module

    serve = import_module(pkg.__name__ + ".serve")
    ctl = import_module(pkg.__name__ + ".serve._private.controller")
    out = {}
    port = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    dep = serve.deployment(Echo, num_replicas=2, version="v1")
    h = serve.run(dep.bind("v1"), name="echo", route_prefix="/echo")
    pids = {h.options(method_name="pid").remote().result(timeout_s=60)
            for _ in range(16)}
    out["replica_processes"] = len(pids)
    out["replica_pid_is_driver"] = os.getpid() in pids
    out["http_bytes"] = http(port, "/echo", {"a": [1, 2.5, "x"]}).decode()
    out["handle"] = h.remote({"b": None}).result(timeout_s=60)

    hammer = Hammer(port, "/echo", ["v1", "v2"])
    serve.run(dep.options(version="v2").bind("v2"), name="echo",
              route_prefix="/echo")
    _wait_for(lambda: [r["version"] for r in _serve_status(serve, "Echo")]
              == ["v2", "v2"] and all(r["state"] == "RUNNING" for r in
                                      _serve_status(serve, "Echo")),
              120, "the rolling update")
    time.sleep(1.0)
    out["update"] = hammer.stop()
    out["update_served_v2"] = "v2" in hammer.tags

    victim = h.options(method_name="pid").remote().result(timeout_s=60)
    ids_before = {r["id"] for r in _serve_status(serve, "Echo")}
    os.kill(victim, signal.SIGKILL)
    new_ids = _wait_for(
        lambda: (lambda reps: {r["id"] for r in reps} - ids_before
                 if len(reps) == 2 and all(r["state"] == "RUNNING"
                                           for r in reps) else None)(
            _serve_status(serve, "Echo")), 120, "the replacement replica")
    out["replaced"] = len(new_ids)
    out["after_replace"] = json.loads(http(port, "/echo", [3]))["tag"]

    controller = pkg.get_actor(ctl.CONTROLLER_NAME)
    hammer = Hammer(port, "/echo", ["v2"])
    time.sleep(1.0)
    cpid = pkg.get(controller.__ray_call__.remote(pid_of), timeout=60)
    os.kill(cpid, signal.SIGKILL)
    time.sleep(3.0)
    status = _wait_for(
        lambda: pkg.get(controller.status.remote(), timeout=10)
        .get("Echo", {}).get("replicas"), 120, "the controller's recovery")
    time.sleep(1.0)
    out["controller_kill"] = hammer.stop()
    out["recovered_replicas"] = sorted(r["state"] for r in status)
    out["recovered_pid_differs"] = pkg.get(
        controller.__ray_call__.remote(pid_of), timeout=60) != cpid
    serve.run(dep.options(version="v3").bind("v3"), name="echo",
              route_prefix="/echo")
    out["after_recovery_update"] = _wait_for(
        lambda: json.loads(http(port, "/echo", [4]))["tag"] == "v3",
        120, "an update after the recovery")
    serve.shutdown()
    return out


# ---------------------------------------------------------------------------
# The reference's side, as a child interpreter
# ---------------------------------------------------------------------------
def main(pkg_name: str, what: str) -> None:
    sys.path[:0] = [HERE, ROOT]
    pkg = importlib.import_module(pkg_name)
    start(pkg)
    try:
        out = {"core": core_scenarios, "devices": device_scenarios,
               "serve": serve_scenarios}[what](pkg)
    finally:
        pkg.shutdown()
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
