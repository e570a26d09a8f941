"""The port's in-process runtime (`ray_tpu_torch.core`) against the JAX
package's local mode (`ray_tpu.init(local_mode=True)`), both in this
process: the same calls on the same values give the same results.

Core calls only: the reference's local-mode Serve leaves a thread that
keeps an interpreter from exiting, so Serve is held against it in a child
interpreter (`test_torch_serve.py`). Here also the port's own repairs:
`kill` fails pending calls and stops the actor's threads, and `shutdown`
leaves no thread of the runtime alive.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.core.serialization as jax_ser
import ray_tpu_torch
import ray_tpu_torch.core.serialization as torch_ser
from ray_tpu_torch.exceptions import ActorDiedError, RayTaskError

pytestmark = pytest.mark.unit


@pytest.fixture(scope="module")
def both():
    """(reference, port), each with its in-process runtime up."""
    ray_tpu.init(local_mode=True, ignore_reinit_error=True)
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu, ray_tpu_torch
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


VALUES = [
    1, -7, 2.5, "text", b"bytes", None, True, {"a": [1, 2, {"b": None}]},
    (1, "x"), np.arange(12, dtype=np.float32).reshape(3, 4),
    np.zeros((0, 3), np.int64), np.array(7, np.int8),
    np.arange(5000, dtype=np.float64),          # out-of-band pickle buffer
    {"arr": np.ones((2, 2), np.float16), "n": 3},
    np.asfortranarray(np.arange(6).reshape(2, 3)),   # not C-contiguous
]


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (type(b) is np.ndarray and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_put_get_round_trip_equals_reference(both, i):
    ref, port = both
    value = VALUES[i]
    want = ref.get(ref.put(value))
    got = port.get(port.put(value))
    assert _same(want, value) and _same(got, value) and _same(got, want)
    if isinstance(value, np.ndarray) and value.flags.c_contiguous:
        # The array-native form hands back a read-only view, as the
        # reference's does.
        assert got.flags.writeable == want.flags.writeable


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_serialize_equals_reference(i):
    """A plain ndarray's object is the reference's byte for byte; every
    value's metadata is, and each side decodes the other's bytes."""
    value = VALUES[i]
    j, t = jax_ser.serialize(value), torch_ser.serialize(value)
    assert t._metadata() == j._metadata() or not (
        jax_ser.is_plain_ndarray(value))
    if jax_ser.is_plain_ndarray(value):
        assert t.to_bytes() == j.to_bytes()
    assert _same(torch_ser.deserialize(j.to_bytes()), value)
    assert _same(jax_ser.deserialize(t.to_bytes()), value)


def test_serialized_errors_cross_both_ways():
    err = ValueError("bad input")
    for blob in (jax_ser.serialize_error(err).to_bytes(),
                 torch_ser.serialize_error(err).to_bytes()):
        for mod in (jax_ser, torch_ser):
            with pytest.raises(ValueError, match="bad input"):
                mod.deserialize(blob)

    class Local(Exception):          # a class pickle cannot find by name
        pass

    blob = torch_ser.serialize_error(Local("x")).to_bytes()
    with pytest.raises(ray_tpu_torch.exceptions.RaySystemError,
                       match="Unserializable"):
        torch_ser.deserialize(blob)


def test_task_errors_equal_reference(both):
    results = []
    for pkg in both:
        @pkg.remote
        def boom(x):
            raise ValueError(f"boom {x}")

        with pytest.raises(ValueError) as info:
            pkg.get(boom.remote(3))
        err = info.value
        results.append((type(err).__name__, "boom 3" in str(err),
                        isinstance(err, pkg.exceptions.RayTaskError)))
    assert results[0] == results[1] == (
        "RayTaskError(ValueError)", True, True)


def test_tasks_nested_get_and_wait_equal_reference(both):
    results = []
    for pkg in both:
        @pkg.remote
        def square(x):
            return x * x

        @pkg.remote
        def total(n):
            # A nested get inside a task: the pool must grow, not deadlock.
            return sum(pkg.get([square.remote(i) for i in range(n)]))

        @pkg.remote
        def nap(s):
            time.sleep(s)
            return s

        fast, slow = nap.remote(0.0), nap.remote(1.0)
        ready, pending = pkg.wait([slow, fast], num_returns=1, timeout=0.8)
        results.append((pkg.get(total.remote(6)), ready == [fast],
                        pending == [slow], pkg.get(slow)))
        with pytest.raises(pkg.exceptions.GetTimeoutError):
            pkg.get(nap.remote(2.0), timeout=0.05)
    assert results[0] == results[1] == (55, True, True, 1.0)


def test_actors_and_concurrency_equal_reference(both):
    results = []
    for pkg in both:
        @pkg.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def add(self, k):
                self.n += k
                return self.n

        @pkg.remote
        class Sleeper:
            async def nap(self, s):
                await asyncio.sleep(s)
                return s

        @pkg.remote(max_concurrency=1)
        class Serial:
            async def nap(self, s):
                await asyncio.sleep(s)
                return s

        c = Counter.remote(10)
        order = pkg.get([c.add.remote(k) for k in (1, 2, 3)])
        sleeper = Sleeper.remote()
        t0 = time.perf_counter()
        pkg.get([sleeper.nap.remote(0.3) for _ in range(4)])
        concurrent_s = time.perf_counter() - t0
        serial = Serial.remote()
        t0 = time.perf_counter()
        pkg.get([serial.nap.remote(0.1) for _ in range(4)])
        serial_s = time.perf_counter() - t0
        results.append((order, concurrent_s < 0.9, serial_s >= 0.4))
    assert results[0] == results[1] == ([11, 13, 16], True, True)


def test_named_actors_get_actor_and_kill_equal_reference(both):
    results = []
    for pkg in both:
        @pkg.remote
        class Box:
            def get(self):
                return "here"

        Box.options(name="box").remote()
        found = pkg.get_actor("box")
        with pytest.raises(ValueError):
            Box.options(name="box").remote()
        ok = pkg.get(found.get.remote())
        pkg.kill(found)
        with pytest.raises(pkg.exceptions.ActorDiedError):
            pkg.get(found.get.remote(), timeout=10)
        with pytest.raises(ValueError):
            pkg.get_actor("box")
        with pytest.raises(ValueError):
            pkg.get_actor("nobody")
        results.append(ok)
    assert results == ["here", "here"]


def test_streaming_generators_equal_reference(both):
    results = []
    for pkg in both:
        @pkg.remote(num_returns="streaming")
        def count(n):
            for i in range(n):
                yield np.full(2, i)

        @pkg.remote
        class Gen:
            def sync(self, n):
                yield from range(n)

            async def agen(self, n):
                for i in range(n):
                    await asyncio.sleep(0)
                    yield i * 10

        g = Gen.remote()
        results.append((
            [pkg.get(r).tolist() for r in count.remote(3)],
            [pkg.get(r) for r in
             g.sync.options(num_returns="streaming").remote(4)],
            [pkg.get(r) for r in
             g.agen.options(num_returns="streaming").remote(3)]))
    assert results[0] == results[1] == (
        [[0, 0], [1, 1], [2, 2]], [0, 1, 2, 3], [0, 10, 20])


def test_runtime_context_in_an_actor(both):
    _, port = both

    @port.remote
    class Who:
        def me(self):
            ctx = port.get_runtime_context()
            return ctx.get_actor_id(), ctx.get_task_id() is not None

    w = Who.remote()
    actor_id, has_task = port.get(w.me.remote())
    assert actor_id == w._ray_actor_id.hex() and has_task


def test_kill_fails_pending_calls_and_stops_threads(both):
    """What a process's death does: a call in flight and a queued call
    fail with ActorDiedError, and the actor's loop and executor threads
    end."""
    _, port = both

    @port.remote(max_concurrency=1)
    class Stuck:
        async def wait_forever(self):
            await asyncio.Event().wait()

        def ping(self):
            return "pong"

    s = Stuck.remote()
    assert port.get(s.ping.remote()) == "pong"
    before = set(threading.enumerate())
    running = s.wait_forever.remote()
    queued = s.ping.remote()            # behind it: max_concurrency 1
    stream = s.wait_forever.options(num_returns="streaming").remote()
    time.sleep(0.1)
    actor = port.core.worker.current_runtime()._actors[s._ray_actor_id]
    threads = [actor.thread] + list(actor.executor._threads)
    t0 = time.perf_counter()
    port.kill(s)
    for ref in (running, queued):
        with pytest.raises(ActorDiedError):
            port.get(ref, timeout=5)
    with pytest.raises(ActorDiedError):
        list(stream)
    with pytest.raises(ActorDiedError):
        port.get(s.ping.remote(), timeout=5)
    assert time.perf_counter() - t0 < 5
    assert not any(t.is_alive() for t in threads)
    assert actor.instance is None
    assert not (set(threading.enumerate()) - before)


def test_shutdown_ends_every_thread_of_the_runtime():
    """A fresh runtime with a blocked getter, a sleeping async actor and
    a stream: shutdown wakes and ends them all."""
    rt = ray_tpu_torch.core.local_mode.LocalModeRuntime(num_cpus=2)
    before = set(threading.enumerate())

    class Slow:
        async def forever(self):
            await asyncio.Event().wait()

        def count(self):
            yield from range(3)

    cls = ray_tpu_torch.remote(Slow)
    handle = rt.create_actor(cls, cls._default_options, (), {})
    opts = ray_tpu_torch.core.options.task_options({})
    pending = rt.submit_actor_task(handle, "forever", opts, (), {})
    errors = []

    def getter():
        try:
            rt.get(pending)
        except Exception as e:  # noqa: BLE001
            errors.append(type(e).__name__)

    waiter = threading.Thread(target=getter)
    waiter.start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    rt.shutdown()
    waiter.join(5)
    assert time.perf_counter() - t0 < 5
    assert errors == ["ActorDiedError"] or errors == ["RaySystemError"]
    assert not (set(threading.enumerate()) - before)


def test_init_and_what_waits_for_later_slices(both):
    ref, port = both
    with pytest.raises(RuntimeError):
        port.init()
    assert port.init(ignore_reinit_error=True) is \
        port.core.worker.current_runtime()
    # init(address=...) joins a cluster, as the reference's does: where
    # nothing listens, both fail to reach the GCS with the same error.
    assert _init_unreachable(ref, port) == ["ConnectionLost"] * 2
    # The timeline is served from the port's task events now.
    assert isinstance(port.timeline(), list)
    res = port.cluster_resources()
    assert res["CPU"] > 0 and "TPU" not in res


def _init_unreachable(*packages):
    """The error type of init(address=...) at a local port where nothing
    listens, for each package (the module-level runtime set aside while
    it runs; the packages run at once, each waiting out its connect)."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    address = "127.0.0.1:%d" % sock.getsockname()[1]
    sock.close()
    out = [None] * len(packages)

    def attempt(i, pkg):
        try:
            pkg.init(address=address)
            out[i] = "connected"
        except Exception as e:
            out[i] = type(e).__name__

    saved = [pkg.core.worker._runtime for pkg in packages]
    for pkg in packages:
        pkg.core.worker.set_runtime(None)
    try:
        threads = [threading.Thread(target=attempt, args=(i, pkg))
                   for i, pkg in enumerate(packages)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        for pkg, rt in zip(packages, saved):
            pkg.core.worker.set_runtime(rt)
    return out


def test_task_error_is_a_ray_task_error(both):
    _, port = both

    @port.remote
    def fail():
        raise KeyError("k")

    with pytest.raises(RayTaskError):
        port.get(fail.remote())


def _task_event_traces(pkg, fn_ok, fn_bad):
    """What `pkg`'s in-process runtime records for one task that returns
    and one that raises: each event's keys and the events in order for
    each task name, and the timeline's slice and instant keys."""
    job = pkg.core.worker.current_runtime().job_id.hex()
    before = len(pkg.core.worker.current_runtime().task_events(job))
    ok, bad = pkg.remote(fn_ok), pkg.remote(fn_bad)
    assert pkg.get(ok.remote(3)) == 4
    with pytest.raises(Exception):
        pkg.get(bad.remote(0))
    events = pkg.core.worker.current_runtime().task_events(job)[before:]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"].rsplit(".", 1)[-1], []).append(
            e["event"])
    trace = pkg.timeline()
    return {"keys": sorted({k for e in events for k in e}),
            "events": {k: sorted(v) for k, v in by_name.items()},
            "slice_keys": sorted({k for t in trace if t["ph"] == "X"
                                  for k in t}),
            "instant_keys": sorted({k for t in trace if t["ph"] == "i"
                                    for k in t})}


def event_inc(x):
    return x + 1


def event_boom(x):
    raise ValueError("boom")


def test_local_mode_task_events_match_reference(both):
    """Local mode records SUBMITTED, RUNNING and FINISHED or FAILED for
    each task, with the reference's keys, and `timeline` turns them into
    the reference's Chrome-trace records."""
    ref, port = both
    want = _task_event_traces(ref, event_inc, event_boom)
    got = _task_event_traces(port, event_inc, event_boom)
    assert got == want
    assert got["events"] == {
        "event_inc": ["FINISHED", "RUNNING", "SUBMITTED"],
        "event_boom": ["FAILED", "RUNNING", "SUBMITTED"]}


def test_top_level_names_match_reference():
    """`ray_tpu_torch` exports every name of `ray_tpu.__all__` (and
    `resolve_device`, its own), and importing it loads no torch."""
    import subprocess
    import sys

    assert set(ray_tpu.__all__) <= set(ray_tpu_torch.__all__)
    assert set(ray_tpu_torch.__all__) - set(ray_tpu.__all__) == {
        "resolve_device"}
    for name in ray_tpu.__all__:
        assert hasattr(ray_tpu_torch, name), name
    assert ray_tpu_torch.exceptions.TaskCancelledError.__name__ == \
        "TaskCancelledError"
    assert {"PlacementGroup", "placement_group", "remove_placement_group",
            "placement_group_table", "get_current_placement_group"} <= set(
                ray_tpu_torch.util.__all__)
    out = subprocess.run(
        [sys.executable, "-c", "import sys, ray_tpu_torch; "
         "ray_tpu_torch.util; print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]
