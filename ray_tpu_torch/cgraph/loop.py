"""Persistent per-actor execution loops for compiled graphs, the port of
`ray_tpu/cgraph/loop.py`.

Reference equivalent: `ray/dag/compiled_dag_node.py` `do_exec_tasks` —
the long-lived method Ray's Compiled Graphs submit once per actor, which
then blocks on input channels and executes its static operation schedule
forever. Here the schedule is installed through `__ray_call__` (the
run-arbitrary-code-on-the-actor system method); the installed hook spawns
a daemon loop thread so the actor's regular task executor stays free for
control calls (teardown, health checks).

Per iteration the loop: reads each input channel once, resolves the op's
bound args (constants / channel reads / intra-actor results), invokes the
method, and writes the result to the op's output channels. A user
exception becomes an `_ExecError` that rides the channels in place of
data — downstream ops skip execution and forward it, so the original
error surfaces at `ray.get` of exactly the affected execution while later
executions flow untouched. A *transport* failure (a downstream actor
died: the channel push RPC fails) is fatal for the whole graph: the loop
reports it on the driver-hosted error channel and exits.

The loop calls the actor's methods on its own thread, so PyTorch's
per-thread state that the actor set up in `__init__` (`torch.no_grad()`,
`inference_mode()`, the current CUDA stream) is not in force there: a
method that needs it sets it itself.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from ray_tpu_torch.cgraph.channel import ChannelClosed
from ray_tpu_torch.exceptions import RayError, RayTaskError


class _LoopExit(Exception):
    """Internal: channels torn down, exit quietly."""


_LOOPS: Dict[tuple, "_ActorLoop"] = {}
_loops_lock = threading.Lock()


class _ActorLoop:
    def __init__(self, instance: Any, graph_id: str, schedule: List[dict],
                 error_channel) -> None:
        self.instance = instance
        self.graph_id = graph_id
        self.schedule = schedule
        self.error_channel = error_channel
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"cgraph-loop-{graph_id[:6]}")

    def start(self) -> None:
        self.thread.start()

    # -- execution -------------------------------------------------------
    def _read_arg(self, spec, env: Dict[Any, Any]):
        tag, payload = spec
        if tag == "const":
            return payload
        if tag == "local":
            return env[payload]
        # tag == "chan": read once per iteration, cached by channel id.
        key = ("c", payload.id)
        if key not in env:
            env[key] = payload.read(timeout=None)
        return env[key]

    def _run_op(self, op: dict, env: Dict[Any, Any]) -> None:
        from ray_tpu_torch.cgraph.compiler import _ExecError

        args = [self._read_arg(s, env) for s in op["args"]]
        kwargs = {k: self._read_arg(s, env) for k, s in op["kwargs"].items()}
        err = next((v for v in (*args, *kwargs.values())
                    if isinstance(v, _ExecError)), None)
        if err is not None:
            value: Any = err
        else:
            try:
                value = getattr(self.instance, op["method"])(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                wrapped = (e if isinstance(e, RayTaskError)
                           else RayTaskError.from_exception(op["name"], e))
                value = _ExecError(wrapped)
        env[op["node"]] = value
        for ch in op["out"]:
            try:
                ch.write(value, timeout=None)
            except ChannelClosed:
                raise _LoopExit
            except Exception as e:  # noqa: BLE001
                raise _FatalLoopError(
                    f"compiled-graph edge to {ch.reader_addr or 'local'} "
                    f"broke at op {op['name']!r}: {e!r}") from e

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                env: Dict[Any, Any] = {}
                for op in self.schedule:
                    if self._stop.is_set():
                        return
                    self._run_op(op, env)
        except (_LoopExit, ChannelClosed):
            pass
        except _FatalLoopError as e:
            self._report_fatal(RayError(str(e)))
        except BaseException as e:  # noqa: BLE001
            self._report_fatal(RayError(f"compiled-graph loop crashed: {e!r}"))

    def _report_fatal(self, exc: RayError) -> None:
        if self._stop.is_set():
            return
        try:
            from ray_tpu_torch.cgraph.compiler import _ExecError
            self.error_channel.write(_ExecError(exc), timeout=10.0)
        except Exception:  # noqa: BLE001
            pass  # driver gone too: nothing left to notify

    def stop(self, join_timeout: float = 5.0) -> bool:
        self._stop.set()
        # Close every channel this schedule touches: wakes a read blocked
        # on an empty slot and fails any in-flight producer push.
        for op in self.schedule:
            for spec in (*op["args"], *op["kwargs"].values()):
                if spec[0] == "chan":
                    spec[1].close()
            for ch in op["out"]:
                ch.close()
        self.thread.join(timeout=join_timeout)
        return not self.thread.is_alive()


class _FatalLoopError(Exception):
    pass


# ---------------------------------------------------------------------------
# __ray_call__ entry points (run against the live actor instance)
# ---------------------------------------------------------------------------
def _install_loop(instance, graph_id: str, schedule: List[dict],
                  error_channel) -> bool:
    key = (graph_id, id(instance))   # local mode: actors share a process
    with _loops_lock:
        if key in _LOOPS:
            raise RayError(
                f"compiled graph {graph_id} already installed on this actor")
        loop = _ActorLoop(instance, graph_id, schedule, error_channel)
        _LOOPS[key] = loop
    loop.start()
    return True


def _stop_loop(instance, graph_id: str) -> bool:
    with _loops_lock:
        loop = _LOOPS.pop((graph_id, id(instance)), None)
    if loop is None:
        return True
    return loop.stop()


def _loop_alive(instance, graph_id: str) -> bool:
    with _loops_lock:
        loop = _LOOPS.get((graph_id, id(instance)))
    return loop is not None and loop.thread.is_alive()


def _live_loop_count(instance=None) -> int:
    with _loops_lock:
        return sum(1 for lp in _LOOPS.values() if lp.thread.is_alive())
