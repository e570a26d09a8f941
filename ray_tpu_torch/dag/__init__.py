"""Lazy call-graph (DAG) API, the port of `ray_tpu/dag/__init__.py`.

Reference equivalent: `python/ray/dag/` (`DAGNode`/`FunctionNode`/`ClassNode`/
`InputNode`, `dag/__init__.py:1-9`) — the base for compiled graphs
(`ray_tpu_torch.cgraph`) and Workflows. `f.bind(x)` builds nodes;
`dag.execute(inp)` walks the graph submitting tasks/actor calls bottom-up.
A torch tensor between two nodes of a lazy run is an ordinary task return:
a CUDA tensor crosses the object store as host bytes and lands on the
reading process's card (`core/serialization.py`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A node in a lazy call graph; children are found in args/kwargs."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal -------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = [a for a in self._bound_args if isinstance(a, DAGNode)]
        out += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return out

    def _resolve_args(self, memo: Dict[int, Any], input_value: Any):
        def res(v):
            if isinstance(v, DAGNode):
                return v._execute_memo(memo, input_value)
            return v

        args = tuple(res(a) for a in self._bound_args)
        kwargs = {k: res(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_memo(self, memo: Dict[int, Any], input_value: Any):
        if id(self) in memo:
            return memo[id(self)]
        out = self._execute_impl(memo, input_value)
        memo[id(self)] = out
        return out

    def _execute_impl(self, memo, input_value):
        raise NotImplementedError

    def execute(self, input_value: Any = None):
        """Execute the graph; returns the root's ObjectRef/handle."""
        return self._execute_memo({}, input_value)

    def experimental_compile(self, *, max_in_flight: int = 8,
                             channel_capacity: Optional[int] = None):
        """Compile a static actor-method DAG into persistent per-actor
        execution loops connected by reusable channels (reference:
        `ray/dag/compiled_dag_node.py` experimental_compile). Returns a
        `ray_tpu_torch.cgraph.CompiledDAG`: `execute(x)` costs channel
        writes instead of per-node task submissions."""
        from ray_tpu_torch.cgraph import compile_dag
        return compile_dag(self, max_in_flight=max_in_flight,
                           channel_capacity=channel_capacity)


class InputNode(DAGNode):
    """Placeholder for the runtime input (reference: dag/input_node.py).

    Supports `with InputNode() as inp:` style used by Serve graph builds.
    """

    def __init__(self):
        super().__init__((), {})
        self._channel_kind = "obj"

    def with_channel(self, kind: str) -> "InputNode":
        """Select the compiled-graph channel type for the driver->actor
        input edges (same kinds as `ClassMethodNode.with_channel`).
        Input edges always snapshot the value at write time — the driver
        keeps owning `execute()`'s argument — so `"array"` here buys the
        blob-framed transport and on-device landing, not a live view."""
        if kind not in ("obj", "array", "device"):
            raise ValueError(f"unknown channel kind {kind!r}")
        self._channel_kind = kind
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, memo, input_value):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs, options):
        super().__init__(args, kwargs)
        self._remote_function = remote_function
        self._options = options

    def _execute_impl(self, memo, input_value):
        args, kwargs = self._resolve_args(memo, input_value)
        return self._remote_function._remote(args, kwargs, self._options)


class ClassNode(DAGNode):
    """A bound actor class; executing instantiates the actor."""

    def __init__(self, actor_class, args, kwargs, options):
        super().__init__(args, kwargs)
        self._actor_class = actor_class
        self._options = options
        self._cached_handle = None

    def _execute_impl(self, memo, input_value):
        if self._cached_handle is None:
            args, kwargs = self._resolve_args(memo, input_value)
            self._cached_handle = self._actor_class._remote(
                args, kwargs, self._options)
        return self._cached_handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _UnboundClassMethod(self, name)


class _UnboundClassMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs):
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_or_node, method_name, args, kwargs,
                 options=None):
        super().__init__(args, kwargs)
        self._actor = actor_or_node
        self._method_name = method_name
        self._options = options
        self._channel_kind = "obj"

    def with_channel(self, kind: str) -> "ClassMethodNode":
        """Select the compiled-graph channel type carrying THIS node's
        result (reference: `with_type_hint(TorchTensorType())`).
        `"array"` hands a tensor (on its card) by reference to a
        co-located consumer, and across processes sends its raw bytes
        with torch's dtype name and re-lands them on the reader's card
        when they came from one; `"device"` additionally moves the
        tensor writer->reader via collective p2p when both endpoints
        hold ranks in a shared `util.collective` group (falling back to
        `"array"` semantics otherwise).

        Zero-copy contract: on `"array"`/`"device"` edges the producing
        method hands its result off to the transport as a view — it
        must return a fresh array or tensor each iteration and never mutate a
        returned array afterwards. (Driver-side `execute()` inputs are
        exempt: input edges snapshot the value at write time.)"""
        if kind not in ("obj", "array", "device"):
            raise ValueError(f"unknown channel kind {kind!r}")
        self._channel_kind = kind
        return self

    def _children(self):
        out = super()._children()
        if isinstance(self._actor, DAGNode):
            out.append(self._actor)
        return out

    def _execute_impl(self, memo, input_value):
        actor = self._actor
        if isinstance(actor, DAGNode):
            actor = actor._execute_memo(memo, input_value)
        args, kwargs = self._resolve_args(memo, input_value)
        if self._options is not None:
            return actor._submit(self._method_name, args, kwargs,
                                 self._options)
        return getattr(actor, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Groups several nodes as the DAG's outputs (reference:
    `ray/dag/output_node.py`): `execute` / compiled `execute` return a
    list with one entry per output."""

    def __init__(self, outputs):
        outputs = tuple(outputs)
        if not outputs:
            raise ValueError("MultiOutputNode needs at least one output")
        super().__init__(outputs, {})

    def _execute_impl(self, memo, input_value):
        args, _ = self._resolve_args(memo, input_value)
        return list(args)


__all__ = ["DAGNode", "InputNode", "FunctionNode", "ClassNode",
           "ClassMethodNode", "MultiOutputNode"]
