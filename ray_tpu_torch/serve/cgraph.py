"""Compiled execution for Serve deployment graphs, the port of
`ray_tpu/serve/cgraph.py`.

Reference direction: Ray Serve's replica-on-compiled-graph experiments —
once a deployment pipeline's shape is fixed (ingress -> model A -> model
B), paying router + actor-task cost per request per hop is pure overhead.
`compile_deployment_chain` pins ONE running replica per deployment and
compiles the chain into a `cgraph` pipeline: persistent loops on the
replica actors connected by reusable channels, so a request costs channel
writes instead of N routed actor calls.

Trade-off (deliberate, documented): the compiled pipeline bypasses the
router, so no load balancing across replicas, no autoscaling signal from
this traffic, and a replica death breaks the pipeline (callers see the
error at `ray.get`; `teardown()` + recompile re-pins onto live replicas).
Use it for latency-critical fixed pipelines; keep handles for elastic
traffic. Scaling compiled pipelines across the whole replica set is a
ROADMAP follow-up.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union


def compile_deployment_chain(
        deployments: Sequence[Union[str, Any]], *,
        methods: Optional[List[str]] = None,
        max_in_flight: int = 8,
        channel_capacity: Optional[int] = None):
    """Compile `deployments[0] -> deployments[1] -> ...` (each entry a
    deployment name or an `Application` from `.bind()`) into a
    `ray_tpu_torch.cgraph.CompiledDAG`. `compiled.execute(x)` feeds x
    through one pinned replica of each deployment; `ray_tpu_torch.get`
    returns the last deployment's result."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import ClassMethodNode, InputNode
    from ray_tpu_torch.serve import Application
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    if not deployments:
        raise ValueError("need at least one deployment")
    names = []
    for d in deployments:
        if isinstance(d, Application):
            names.append(d.deployment.name)
        elif isinstance(d, str):
            names.append(d)
        else:
            raise TypeError(
                f"expected deployment name or Application, got {type(d)}")
    methods = methods or ["__call__"] * len(names)
    if len(methods) != len(names):
        raise ValueError("methods must match deployments 1:1")

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    handles = []
    for name in names:
        table = ray_tpu_torch.get(
            controller.get_routing_table.remote(name), timeout=30)
        replicas = table.get("replicas") or []
        if not replicas:
            raise RuntimeError(
                f"deployment {name!r} has no RUNNING replica to compile")
        handles.append(replicas[0][1])   # (replica_id, handle)

    with InputNode() as inp:
        node: Any = inp
        for handle, method in zip(handles, methods):
            node = ClassMethodNode(handle, "cgraph_call",
                                   (node, method), {})
    return node.experimental_compile(max_in_flight=max_in_flight,
                                     channel_capacity=channel_capacity)
