"""Compiled Graphs: a second execution plane beside tasks/actors, the
port of `ray_tpu/cgraph/`.

Reference equivalent: `ray/dag/compiled_dag_node.py` +
`ray/experimental/channel/` — Ray's accelerated DAG ("Compiled Graphs").
A static DAG of actor-method calls is compiled ONCE into persistent
per-actor execution loops connected by bounded reusable channels;
`compiled.execute(x)` then costs channel writes instead of task
submissions (no task spec, no GCS round-trip, no raylet scheduling).

    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile()
    ref = compiled.execute(x)       # returns a CompiledDAGRef
    out = ray_tpu_torch.get(ref)    # reads the output channel
    compiled.teardown()
"""

from ray_tpu_torch.cgraph.channel import (ArrayChannel, Channel,
                                          ChannelClosed, ChannelTimeout)
from ray_tpu_torch.cgraph.compiler import (CompiledDAG, CompiledDAGRef,
                                           compile_dag)

__all__ = [
    "ArrayChannel", "Channel", "ChannelClosed", "ChannelTimeout",
    "CompiledDAG", "CompiledDAGRef", "compile_dag",
]
