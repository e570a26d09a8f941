"""Static DAG compilation: one schedule ship, then channel-only execution
(the port of `ray_tpu/cgraph/compiler.py`).

Reference equivalent: `ray/dag/compiled_dag_node.py` (`experimental_compile`)
— Ray's accelerated DAG. `dag.execute()` walks the lazy graph submitting a
fresh task per node per call, paying submission, GCS, and scheduling cost
every time (`perf.py run_microbench`'s `dag_chain_call_ms`). Compilation
removes all of it for graphs whose *shape* is static:

1. topologically sort the bound DAG of actor-method nodes;
2. allocate one bounded reusable channel per cross-process edge
   (`cgraph/channel.py`) — driver->actor for `InputNode` edges,
   actor->actor for data edges, actor->driver for outputs;
3. ship each actor its static operation schedule ONCE (`__ray_call__` ->
   `loop._install_loop`) — a persistent per-actor loop then blocks on
   input channels and executes the schedule with zero per-call control
   traffic;
4. `compiled.execute(x)` writes x into the input channels and returns a
   `CompiledDAGRef`; `ray_tpu_torch.get(ref)` reads the output channel.

Semantics: executions complete in FIFO order; `max_in_flight` bounds the
submission window (execute blocks when full — backpressure); a user
exception rides the channels as `_ExecError`, poisoning only its own
execution and re-raising at `ray.get`; an actor death poisons every
in-flight execution and marks the graph broken; `teardown()` stops every
loop and closes every channel.
"""

from __future__ import annotations

import contextlib
import secrets
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.cgraph.channel import (_KINDS, Channel, ChannelClosed,
                                          ChannelTimeout)
from ray_tpu_torch.exceptions import (ActorDiedError, RayError,
                                      RayTaskError)


class _ExecError:
    """A failed execution's payload: flows through channels in place of
    data so downstream ops forward it instead of computing."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error

    def raise_(self) -> None:
        err = self.error
        if isinstance(err, RayTaskError):
            raise err.as_instanceof_cause()
        raise err


class CompiledDAGRef:
    """Future for one compiled execution. `ray_tpu_torch.get()` accepts
    it."""

    _is_compiled_dag_ref = True

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._dag._get_result(self._index, timeout)

    def __repr__(self):
        return f"CompiledDAGRef({self._dag.graph_id[:6]}, #{self._index})"


class CompiledDAG:
    def __init__(self, *, graph_id: str, actors: List[Tuple[str, Any]],
                 input_channels: List[Channel],
                 output_plan: List[int], output_channels: List[Channel],
                 error_channel: Channel, max_in_flight: int,
                 multi_output: bool, max_buffered_results: int = 1000,
                 rebuild: Optional[dict] = None,
                 restart_budget: int = 0):
        self.graph_id = graph_id
        self._actors = actors
        self._input_channels = input_channels
        self._output_channels = output_channels
        # Output position i reads unique channel output_plan[i] (a node
        # listed twice in MultiOutputNode shares one channel).
        self._output_plan = output_plan
        self._error_channel = error_channel
        self._max_in_flight = max(1, max_in_flight)
        self._multi_output = multi_output
        self._max_buffered_results = max(1, max_buffered_results)
        self._submitted = 0
        self._drained = 0
        self._results: Dict[int, Any] = {}
        self._broken: Optional[BaseException] = None
        self._torn = False
        self._lock = threading.RLock()
        # Restart-through-actor-death: the compile recipe
        # (DAG root + knobs) so a poisoned graph can recompile onto
        # restarted actors, and the remaining restart allowance
        # (min over actors' max_task_retries at compile time — the
        # same budget that lets the actor plane revive the workers).
        self._rebuild = rebuild
        self._restarts_left = max(0, int(restart_budget))
        # Executions in flight at a restart (never completed): list of
        # (lo, hi, error) — lo <= index < hi surfaces that epoch's
        # actor-death error at get().
        self._failed_epochs: List[Tuple[int, int, BaseException]] = []

    # -- execution -------------------------------------------------------
    def execute(self, input_value: Any = None, *,
                timeout: Optional[float] = None) -> CompiledDAGRef:
        """Enqueue one execution; returns a future. Blocks while
        `max_in_flight` executions are UNDRAINED (backpressure against
        the pipeline); completed-but-never-retrieved results buffer up
        to `max_buffered_results`, past which execute() raises — drop
        the refs or get() them, they are not free.

        A graph poisoned by an actor death attempts a RESTART here
        (recompile onto the restarted replacement, bounded by the
        actors' max_task_retries): in-flight executions still fail with
        the death error, this and later executes flow on the revived
        graph."""
        with self._lock:
            if self._broken is not None and not self._torn:
                self._try_restart()
            self._check_usable()
            while self._submitted - self._drained >= self._max_in_flight:
                self._drain_next(timeout)
                if self._broken is not None and not self._torn:
                    # The drain hit an actor death: revive (failing the
                    # in-flight window) so THIS execute can proceed.
                    self._try_restart()
                self._check_usable()
            from ray_tpu_torch.util.tracing import span, tracing_enabled
            index = self._submitted
            ctx = (span("cgraph.execute",
                        attributes={"graph_id": self.graph_id,
                                    "execution": index})
                   if tracing_enabled() else contextlib.nullcontext())
            with ctx:
                for i, ch in enumerate(self._input_channels):
                    try:
                        ch.write(input_value, timeout=timeout)
                    except (ChannelClosed, ChannelTimeout) as e:
                        if i == 0:
                            raise  # nothing written yet: graph intact
                        # Partial input fan-out: branches are now one
                        # item out of step — unrecoverable.
                        self._poison(RayError(
                            f"partial input write (edge {i}): {e!r}"))
                        raise self._broken from e
                    except Exception as e:  # noqa: BLE001
                        self._poison(ActorDiedError(
                            error_msg="compiled-graph input edge broke: "
                                      f"{e!r}"))
                        raise self._broken from e
            self._submitted += 1
            return CompiledDAGRef(self, index)

    def _check_usable(self) -> None:
        if self._torn:
            raise RayError("compiled DAG has been torn down")
        if self._broken is not None:
            raise self._broken

    def _poison(self, exc: BaseException) -> None:
        """An actor died mid-graph: every in-flight execution fails with
        the original error; the graph is unusable until torn down — or
        until execute() revives it through `_try_restart`."""
        if self._broken is None:
            self._broken = exc

    def _try_restart(self) -> None:
        """Recompile the DAG onto its (restarted) actors and resume.
        Caller holds the lock and has seen `_broken`. On success the
        in-flight window [drained, submitted) is recorded as failed
        with the death error and the graph accepts new executes; on
        failure (budget spent, flag off, an actor that cannot come
        back) the original poison re-raises: the graph stays poisoned."""
        from ray_tpu_torch.core.config import ray_config

        err = self._broken
        if (self._rebuild is None or self._restarts_left <= 0
                or not ray_config().cgraph_restart):
            raise err
        self._restarts_left -= 1
        # Stop surviving loops + close this epoch's channels. The dead
        # actor's stop rides the actor plane's retry-through-restart
        # (max_task_retries), which is what revives its worker; a stop
        # that still fails leaves compile to surface the real verdict.
        from ray_tpu_torch.cgraph.loop import _stop_loop
        import ray_tpu_torch
        stop_refs = []
        for _aid, handle in self._actors:
            try:
                stop_refs.append(handle.__ray_call__.remote(
                    _stop_loop, self.graph_id))
            except Exception:  # noqa: BLE001
                pass
        for ref in stop_refs:
            # Submitted first, reaped second: worst-case stop latency
            # is the slowest actor, not the sum across actors (all of
            # this runs under the DAG lock).
            try:
                ray_tpu_torch.get(ref,
                                  timeout=self._rebuild["install_timeout"])
            except Exception:  # noqa: BLE001
                pass
        for ch in (*self._input_channels, *self._output_channels,
                   self._error_channel):
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
        try:
            fresh = compile_dag(
                self._rebuild["node"],
                max_in_flight=self._max_in_flight,
                channel_capacity=self._rebuild["channel_capacity"],
                install_timeout=self._rebuild["install_timeout"])
        except BaseException as e:
            self._broken = err
            raise err from e
        # Adopt the fresh compilation's plumbing; keep OUR monotonic
        # execution indexing (old refs stay addressable).
        self.graph_id = fresh.graph_id
        self._actors = fresh._actors
        self._input_channels = fresh._input_channels
        self._output_channels = fresh._output_channels
        self._output_plan = fresh._output_plan
        self._error_channel = fresh._error_channel
        self._restarts_left = min(self._restarts_left,
                                  fresh._restarts_left)
        fresh._torn = True  # the shell must never tear down adopted guts
        if self._submitted > self._drained:
            self._failed_epochs.append((self._drained, self._submitted,
                                        err))
        self._drained = self._submitted
        self._broken = None
        from ray_tpu_torch.core import flight
        if flight.enabled:
            flight.instant("cgraph", "cgraph.restart",
                           arg=f"{self.graph_id[:6]} "
                               f"left={self._restarts_left}")

    def _check_actor_liveness(self) -> bool:
        """Poison the graph when the owner already knows a loop actor is
        DEAD (ray.kill, restart exhaustion). An externally SIGKILLed
        worker is instead detected by the first push that fails against
        it — its upstream peer reports on the error channel."""
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime(or_none=True)
        states = getattr(rt, "_actors", None)
        if not states:
            return False
        for aid, _handle in self._actors:
            st = states.get(aid)
            if st is not None and getattr(st, "state", None) == "DEAD":
                self._poison(ActorDiedError(
                    error_msg=f"compiled-graph actor {aid[:8]} died"))
                return True
        return False

    def _drain_next(self, timeout: Optional[float] = None) -> None:
        """Read the next completed execution (FIFO) into the result
        buffer, watching the error channel while waiting."""
        import time as _time
        deadline = (None if timeout is None
                    else _time.monotonic() + timeout)
        values: List[Any] = []
        for ch in self._output_channels:
            while True:
                # A pipelined input push may have failed since execute()
                # returned (first actor died): that poisons the graph.
                for ich in self._input_channels:
                    err = ich.pending_error()
                    if err is not None:
                        self._poison(ActorDiedError(
                            error_msg="compiled-graph input edge broke: "
                                      f"{err!r}"))
                        return
                if self._check_actor_liveness():
                    return
                try:
                    fatal = self._error_channel.try_read()
                    self._poison(fatal.error if isinstance(fatal, _ExecError)
                                 else RayError(str(fatal)))
                    return
                except ChannelTimeout:
                    pass
                except ChannelClosed:
                    pass
                try:
                    values.append(ch.read(timeout=0.05))
                    break
                except ChannelTimeout:
                    if deadline is not None and _time.monotonic() > deadline:
                        from ray_tpu_torch.exceptions import GetTimeoutError
                        raise GetTimeoutError(
                            f"compiled execution #{self._drained} not ready "
                            f"after {timeout}s")
                except ChannelClosed:
                    self._poison(RayError(
                        "compiled-graph output channel closed"))
                    return
        result = ([values[i] for i in self._output_plan]
                  if self._multi_output else values[self._output_plan[0]])
        if len(self._results) >= self._max_buffered_results:
            # Unretrieved results are not free: past this the caller is
            # leaking refs (reference: compiled DAG max_buffered_results).
            raise RayError(
                f"{len(self._results)} compiled-graph results buffered "
                "and never retrieved; ray_tpu_torch.get() your "
                "CompiledDAGRefs "
                "(or raise max_buffered_results)")
        self._results[self._drained] = result
        self._drained += 1

    def _get_result(self, index: int, timeout: Optional[float]) -> Any:
        with self._lock:
            while index not in self._results:
                for lo, hi, err in self._failed_epochs:
                    if lo <= index < hi:
                        # In flight at a restart and never completed:
                        # that epoch's actor-death error is this ref's
                        # result.
                        raise err
                if self._broken is not None:
                    raise self._broken
                if self._torn:
                    raise RayError("compiled DAG has been torn down")
                if index < self._drained:
                    raise RayError(
                        f"execution #{index} was already retrieved")
                self._drain_next(timeout)
            result = self._results.pop(index)
        if self._multi_output:
            for v in result:
                if isinstance(v, _ExecError):
                    v.raise_()
            return result
        if isinstance(result, _ExecError):
            result.raise_()
        return result

    # -- lifecycle -------------------------------------------------------
    def teardown(self, timeout: float = 10.0) -> None:
        """Stop every actor loop and close every channel. Idempotent."""
        with self._lock:
            if self._torn:
                return
            self._torn = True
        from ray_tpu_torch.cgraph.loop import _stop_loop
        refs = []
        for _aid, handle in self._actors:
            try:
                refs.append(handle.__ray_call__.remote(
                    _stop_loop, self.graph_id))
            except Exception:  # noqa: BLE001
                pass  # actor already dead
        import ray_tpu_torch
        for r in refs:
            try:
                ray_tpu_torch.get(r, timeout=timeout)
            except Exception:  # noqa: BLE001
                pass
        for ch in (*self._input_channels, *self._output_channels,
                   self._error_channel):
            ch.close()

    def __del__(self):
        try:
            from ray_tpu_torch.core.worker import is_initialized
            # Only tear down against a LIVE runtime: auto-initializing a
            # fresh one during interpreter shutdown would be worse than
            # leaking daemon loop threads.
            if not self._torn and is_initialized():
                self.teardown(timeout=2.0)
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------
def compile_dag(output_node, *, max_in_flight: int = 8,
                channel_capacity: Optional[int] = None,
                install_timeout: float = 60.0) -> CompiledDAG:
    from ray_tpu_torch.core.worker import current_runtime
    from ray_tpu_torch.dag import (ClassMethodNode, ClassNode, InputNode,
                                   MultiOutputNode)

    rt = current_runtime()
    capacity = channel_capacity or max(2, max_in_flight)
    graph_id = secrets.token_hex(8)

    if isinstance(output_node, MultiOutputNode):
        outputs = list(output_node._bound_args)
        multi_output = True
    else:
        outputs = [output_node]
        multi_output = False

    # 1. Collect + topo-sort (post-order DFS == dependencies first).
    topo: List[Any] = []
    seen: Dict[int, Any] = {}
    on_stack: set = set()

    def visit(node):
        if id(node) in seen:
            if id(node) in on_stack:
                raise ValueError("cycle detected in DAG")
            return
        seen[id(node)] = node
        on_stack.add(id(node))
        for child in node._children():
            visit(child)
        on_stack.discard(id(node))
        topo.append(node)

    for out in outputs:
        visit(out)

    input_nodes = [n for n in topo if isinstance(n, InputNode)]
    if len(input_nodes) > 1:
        raise ValueError("compiled DAG supports at most one InputNode")
    ops = [n for n in topo if isinstance(n, ClassMethodNode)]
    unsupported = [n for n in topo
                   if not isinstance(n, (ClassMethodNode, ClassNode,
                                         InputNode, MultiOutputNode))]
    if unsupported:
        raise NotImplementedError(
            "experimental_compile supports actor-method DAGs only; got "
            f"{type(unsupported[0]).__name__} (plain task nodes pay "
            "scheduling per call by design — use dag.execute())")
    if not ops:
        raise ValueError("nothing to compile: DAG has no actor-method nodes")

    # 2. Resolve each op to a live actor handle.
    handle_memo: Dict[int, Any] = {}

    def handle_of(node):
        from ray_tpu_torch.core.actor import ActorHandle
        actor = node._actor
        if isinstance(actor, ActorHandle):
            return actor
        if isinstance(actor, ClassNode):
            if id(actor) not in handle_memo:
                handle_memo[id(actor)] = actor._execute_memo({}, None)
            return handle_memo[id(actor)]
        raise NotImplementedError(
            f"cannot compile method bound to {type(actor).__name__}")

    op_index = {id(n): i for i, n in enumerate(ops)}
    op_handles = [handle_of(n) for n in ops]
    op_aids = [h._ray_actor_id.hex() for h in op_handles]

    local_mode = getattr(rt, "is_local_mode", False)
    driver_addr = None if local_mode else getattr(rt, "address", None)

    addr_memo: Dict[str, Optional[str]] = {}

    def actor_addr(aid: str) -> Optional[str]:
        if local_mode:
            return None
        if aid not in addr_memo:
            rt._loop.run(rt._actor_client(aid), timeout=install_timeout)
            addr_memo[aid] = rt._actors[aid].address
        return addr_memo[aid]

    def channel_cls(producer) -> type:
        kind = getattr(producer, "_channel_kind", "obj") or "obj"
        return _KINDS[kind]

    # 3. Allocate channels and build per-op arg specs.
    op_specs: List[dict] = [
        {"node": i, "method": n._method_name,
         "name": f"cgraph:{n._method_name}", "args": [], "kwargs": {},
         "out": []} for i, n in enumerate(ops)]
    edge_channels: Dict[tuple, Channel] = {}
    input_channels: List[Channel] = []

    def arg_spec(arg, consumer_i: int):
        if isinstance(arg, InputNode):
            key = ("in", id(arg), consumer_i)
            if key not in edge_channels:
                ch = channel_cls(arg)(
                    capacity=capacity,
                    reader_addr=actor_addr(op_aids[consumer_i]))
                # The driver keeps owning execute()'s input value after
                # write() returns — unlike loop actors, it is under no
                # fresh-array-per-iteration contract, so array codecs
                # must snapshot rather than ship a live view.
                ch._snapshot_writes = True
                edge_channels[key] = ch
                input_channels.append(ch)
            return ("chan", edge_channels[key])
        if isinstance(arg, ClassMethodNode):
            pi = op_index[id(arg)]
            if op_aids[pi] == op_aids[consumer_i]:
                return ("local", pi)
            key = ("op", pi, consumer_i)
            if key not in edge_channels:
                ch = channel_cls(arg)(
                    capacity=capacity,
                    reader_addr=actor_addr(op_aids[consumer_i]))
                edge_channels[key] = ch
                op_specs[pi]["out"].append(ch)
            return ("chan", edge_channels[key])
        if isinstance(arg, (ClassNode, MultiOutputNode)):
            raise NotImplementedError(
                f"{type(arg).__name__} cannot be a data argument in a "
                "compiled DAG")
        return ("const", arg)

    for i, node in enumerate(ops):
        op_specs[i]["args"] = [arg_spec(a, i) for a in node._bound_args]
        op_specs[i]["kwargs"] = {k: arg_spec(v, i)
                                 for k, v in node._bound_kwargs.items()}
        op_specs[i]["name"] = (
            f"{op_handles[i]._class_name}.{node._method_name}")

    # 4. Output channels (actor -> driver), deduped per producing node.
    out_chan_of_node: Dict[int, int] = {}
    output_channels: List[Channel] = []
    output_plan: List[int] = []
    for out in outputs:
        if not isinstance(out, ClassMethodNode):
            raise NotImplementedError(
                "compiled DAG outputs must be actor-method nodes")
        pi = op_index[id(out)]
        if pi not in out_chan_of_node:
            ch = channel_cls(out)(capacity=capacity,
                                  reader_addr=driver_addr)
            op_specs[pi]["out"].append(ch)
            out_chan_of_node[pi] = len(output_channels)
            output_channels.append(ch)
        output_plan.append(out_chan_of_node[pi])

    # Unordered: EVERY actor loop writes fatal reports here, and the
    # seq protocol assumes one writer per channel.
    error_channel = Channel(capacity=16, reader_addr=driver_addr,
                            ordered=False)

    # 5. Ship each actor its schedule once; the loop starts immediately.
    from ray_tpu_torch.cgraph.loop import _install_loop
    by_actor: Dict[str, List[dict]] = {}
    actor_handle: Dict[str, Any] = {}
    for i, aid in enumerate(op_aids):
        by_actor.setdefault(aid, []).append(op_specs[i])
        actor_handle[aid] = op_handles[i]
    import ray_tpu_torch
    install_refs = [
        handle.__ray_call__.remote(_install_loop, graph_id,
                                   by_actor[aid], error_channel)
        for aid, handle in actor_handle.items()]
    ray_tpu_torch.get(install_refs, timeout=install_timeout)

    # Restart budget: the graph can be revived through actor death as
    # long as EVERY actor still has task-retry allowance — the same
    # budget `_submit_actor_async` spends restarting the worker under
    # the loop-control calls (max_task_retries=-1 counts as unbounded).
    budgets = []
    for aid in actor_handle:
        st = getattr(rt, "_actors", {}).get(aid) if not local_mode else None
        t = getattr(st, "task_retries", 0) if st is not None else 0
        budgets.append(1 << 30 if t < 0 else t)
    restart_budget = min(budgets) if budgets else 0

    return CompiledDAG(
        graph_id=graph_id,
        actors=[(aid, h) for aid, h in actor_handle.items()],
        input_channels=input_channels,
        output_plan=output_plan,
        output_channels=output_channels,
        error_channel=error_channel,
        max_in_flight=max_in_flight,
        multi_output=multi_output,
        rebuild={"node": output_node,
                 "channel_capacity": channel_capacity,
                 "install_timeout": install_timeout},
        restart_budget=restart_budget)
