"""What the DAG, compiled-graph and workflow tests of the port share: the
actors and functions both packages' graphs run, and the scenarios whose
results the tests hold side by side.

This module imports neither jax nor torch at its top: the port's worker
processes import it to find the classes and functions a graph sends them
(the port exports them by reference), and the reference's side of a
cluster scenario runs it as a child interpreter's main file:

    python tests/torch_cgraph_helpers.py ray_tpu dag|cgraph

which starts the reference's cluster, prints one JSON line of results and
leaves with `os._exit`.
"""

import importlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# ---------------------------------------------------------------------------
# What graphs send to actors and tasks (module level: exported by reference)
# ---------------------------------------------------------------------------
class Stage:
    """tests/test_cgraph.py's stage."""

    def __init__(self, k=0):
        self.k = k
        self.seen = 0

    def add(self, x):
        self.seen += 1
        return x + self.k

    def mul(self, x, y):
        return x * y

    def boom(self, x):
        if x == 3:
            raise ValueError("bad input 3")
        return x

    def count(self):
        return self.seen

    def slow(self, x):
        time.sleep(0.15)
        return x


class Tensor:
    """tests/test_cgraph.py's array stage; a torch tensor stays one (and
    on its device), a numpy array stays one."""

    def scale(self, x):
        return x * 2.0

    def plus(self, x):
        return x + 1.0

    def same(self, x):
        return x

    def describe(self, x):
        """(type name, dtype, device, shape, contiguous) of what arrived."""
        return (type(x).__name__, str(x.dtype), str(getattr(x, "device",
                                                           "numpy")),
                list(x.shape), bool(x.is_contiguous()
                                    if hasattr(x, "is_contiguous")
                                    else x.flags.c_contiguous))


class GroupStage:
    """tests/test_data_plane_cluster.py's `_Stage`: a member of a gloo
    `util.collective` group of the port's, with array methods."""

    def __init__(self, rank=None, world=2, group="cgraph_dp"):
        self.rank = rank
        self.world = world
        self.group = group

    def join_group(self):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(self.world, self.rank, backend="gloo",
                                  group_name=self.group)
        return col.get_rank(self.group)

    def leave_group(self):
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group(self.group)
        return True

    def scale(self, x):
        return x * 2.0

    def plus(self, x):
        return x + 1.0


class Dicty:
    def wrap(self, x):
        return {"v": [float(v) for v in np.asarray(x).ravel()]}

    def unwrap(self, d):
        return sum(d["v"])


class Acc:
    """An actor class bound lazily (`Acc.bind(start)`)."""

    def __init__(self, start=0):
        self.total = start

    def push(self, x):
        self.total += x
        return self.total

    def pair(self, x, y=1):
        return [x, y, self.total]


class Doubler:
    """tests/test_serve.py's chain deployments (module level: Serve's
    replicas take them by reference)."""

    def __call__(self, x):
        return x * 2


class Biaser:
    def __call__(self, x):
        return x + 3


def square(x):
    return x * x


def add(a, b):
    return a + b


def scaled_sum(xs, factor=1):
    return float(np.sum(xs)) * factor


def live_loops(instance, pkg_name):
    """`__ray_call__` body: the compiled-graph loop threads alive in the
    actor's process."""
    loop = importlib.import_module(f"{pkg_name}.cgraph.loop")
    return loop._live_loop_count()


def pid_of(instance):
    return os.getpid()


def device_routes(instance):
    """`__ray_call__` body: the collective routes this process's
    `"device"` edges resolved ((group, my rank, reader rank) each)."""
    from ray_tpu_torch.cgraph import channel

    return [list(c._route) for c in list(channel._registry.values())
            if c.kind == "device" and c._route is not None]


class TransformerHead:
    """The first `split` layers of a small transformer (the port's
    `models.transformer` functions, in `forward`'s order), from numpy
    weights (`params_from_jax`'s tree)."""

    def __init__(self, np_params, widths, split, threads=None):
        import torch

        from ray_tpu_torch.models import TransformerConfig, params_from_jax

        if threads:
            torch.set_num_threads(threads)
        self.cfg = TransformerConfig(dtype=torch.float32, **widths)
        params = params_from_jax(np_params, device="cpu")
        self.embed = params["embed"]
        self.layers = params["layers"][:split]

    def hidden(self, tokens):
        import torch

        from ray_tpu_torch.models.transformer import (_check_ids, _embed,
                                                      _layers)

        # The compiled loop calls this on its own thread: no_grad here.
        with torch.no_grad():
            t = _check_ids(torch.as_tensor(tokens, dtype=torch.long),
                           self.cfg)
            return _layers(_embed(self.embed, t, self.cfg), self.layers,
                           self.cfg, None)[0]


class TransformerTail:
    """The layers from `split` on, the final norm and the tied-embedding
    logits."""

    def __init__(self, np_params, widths, split, threads=None):
        import torch

        from ray_tpu_torch.models import TransformerConfig, params_from_jax

        if threads:
            torch.set_num_threads(threads)
        self.cfg = TransformerConfig(dtype=torch.float32, **widths)
        params = params_from_jax(np_params, device="cpu")
        self.embed = params["embed"]
        self.layers = params["layers"][split:]
        self.ln_f = params["ln_f"]

    def logits(self, hidden):
        import torch

        from ray_tpu_torch.models.transformer import _layers, _rmsnorm

        with torch.no_grad():
            x = _layers(hidden, self.layers, self.cfg, None)[0]
            x = _rmsnorm(x, self.ln_f)
            return torch.einsum("bsd,vd->bsv", x,
                                self.embed.to(self.cfg.dtype))


# ---------------------------------------------------------------------------
# Workflow steps (module level: the port stores a workflow's DAG with code
# by reference)
# ---------------------------------------------------------------------------
def wf_fetch(log):
    with open(log, "a") as f:
        f.write("fetch\n")
    return [1, 2, 3]


def wf_total(xs, log):
    with open(log, "a") as f:
        f.write("total\n")
    return sum(xs)


def wf_good():
    return 10


def wf_flaky(x, flag_file):
    if not os.path.exists(flag_file):
        raise RuntimeError("transient failure")
    return x * 2


def wf_report(x, log):
    with open(log, "a") as f:
        f.write("report\n")
    return {"value": x, "double": x * 2}


def workflow_flows(pkg, tmp: str) -> dict:
    """Both of tests/test_workflow_mp.py's workflows and a three-step one
    whose middle step fails once, on `pkg`'s runtime, with storage under
    `tmp` (through RAY_TPU_WORKFLOW_STORAGE) and every static argument a
    path under `tmp`, so that both packages' step ids agree when they are
    given the same `tmp`. Returns each status after each call, without
    its clock."""
    wf = importlib.import_module(f"{pkg.__name__}.workflow")
    os.environ["RAY_TPU_WORKFLOW_STORAGE"] = os.path.join(tmp, "store")
    log = os.path.join(tmp, "executions.log")
    flag = os.path.join(tmp, "now_works")
    for path in (log, flag):
        if os.path.exists(path):
            os.remove(path)
    rf = pkg.remote
    out = {}

    def status(wid):
        s = dict(wf.get_status(wid))
        s.pop("updated_at")
        err = s.pop("error")
        s["error"] = None if err is None else "transient failure" in err
        return s

    dag = rf(wf_total).bind(rf(wf_fetch).bind(log), log)
    out["basic_run"] = wf.run(dag, workflow_id="wf-basic")
    out["basic_status"] = status("wf-basic")
    out["basic_resume"] = wf.resume("wf-basic")
    out["basic_resumed_status"] = status("wf-basic")
    with open(log) as f:
        out["basic_log"] = sorted(f.read().split())
    out["basic_listed"] = any(w["workflow_id"] == "wf-basic"
                              for w in wf.list_all())
    wf.delete("wf-basic")
    try:
        wf.get_status("wf-basic")
        out["basic_deleted"] = False
    except KeyError:
        out["basic_deleted"] = True

    dag = rf(wf_flaky).bind(rf(wf_good).bind(), flag)
    try:
        wf.run(dag, workflow_id="wf-flaky")
        out["flaky_first"] = "ran"
    except RuntimeError as e:
        out["flaky_first"] = f"RuntimeError: {'transient failure' in str(e)}"
    out["flaky_failed_status"] = status("wf-flaky")
    open(flag, "w").close()
    out["flaky_resume"] = wf.resume("wf-flaky")
    out["flaky_status"] = status("wf-flaky")
    os.remove(flag)

    dag = rf(wf_report).bind(
        rf(wf_flaky).bind(rf(wf_good).bind(), flag), log)
    try:
        wf.run(dag, workflow_id="wf-three")
        out["three_first"] = "ran"
    except RuntimeError:
        out["three_first"] = "RuntimeError"
    out["three_failed_status"] = status("wf-three")
    open(flag, "w").close()
    out["three_resume"] = wf.resume("wf-three")
    out["three_status"] = status("wf-three")
    out["three_files"] = sorted(os.listdir(os.path.join(tmp, "store",
                                                        "wf-three")))
    return out


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------
def _error(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def dag_scenarios(pkg) -> dict:
    """Lazy `execute` of the same graphs: bind on remote functions,
    `options(...)`, actor classes, actor methods, `MultiOutputNode`."""
    dag_mod = importlib.import_module(f"{pkg.__name__}.dag")
    InputNode, MultiOutputNode = dag_mod.InputNode, dag_mod.MultiOutputNode
    get = pkg.get
    sq = pkg.remote(square)
    ad = pkg.remote(add)
    ssum = pkg.remote(scaled_sum)
    out = {}
    with InputNode() as inp:
        dag = ad.bind(sq.bind(inp), sq.options(num_cpus=0).bind(3))
    out["functions"] = [get(dag.execute(x), timeout=60) for x in (0, 2, -5)]
    with InputNode() as inp:
        dag = ssum.bind(inp, factor=ad.bind(1, 2))
    out["kwargs_node"] = get(dag.execute(np.arange(4.0)), timeout=60)
    acc = pkg.remote(Acc).bind(10)
    dag = acc.push.bind(sq.bind(2))
    out["class_node"] = [get(dag.execute(), timeout=60) for _ in range(3)]
    acc_opts = pkg.remote(Acc).options(num_cpus=0).bind(1)
    with InputNode() as inp:
        dag = MultiOutputNode([acc_opts.pair.bind(inp, y=ad.bind(inp, 1)),
                               sq.bind(inp)])
    out["multi_output"] = get(dag.execute(4), timeout=60)
    stage = pkg.remote(Stage).remote(100)
    with InputNode() as inp:
        dag = stage.add.bind(stage.add.options(num_returns=1).bind(inp))
    out["handle_methods"] = [get(dag.execute(x), timeout=60)
                             for x in (1, 2)]
    with InputNode() as inp:
        dag = stage.boom.bind(inp)
    out["error"] = _error(lambda: get(dag.execute(3), timeout=60))
    out["bad_channel"] = _error(lambda: InputNode().with_channel("gpu"))
    out["empty_multi"] = _error(lambda: MultiOutputNode([]))
    return out


def cgraph_scenarios(pkg) -> dict:
    """Compiled execution of the same graphs."""
    dag_mod = importlib.import_module(f"{pkg.__name__}.dag")
    InputNode, MultiOutputNode = dag_mod.InputNode, dag_mod.MultiOutputNode
    get = pkg.get
    S = pkg.remote(Stage)
    a, b, c = S.remote(1), S.remote(10), S.remote(100)
    get([s.count.remote() for s in (a, b, c)], timeout=120)
    out = {}
    with InputNode() as inp:
        dag = c.add.bind(b.add.bind(a.add.bind(inp)))
    comp = dag.experimental_compile()
    out["chain"] = [get(comp.execute(x), timeout=60) for x in (0, 5, -3)]
    comp.teardown()
    with InputNode() as inp:
        x = a.add.bind(inp)
        y = b.add.bind(inp)
        z = c.mul.bind(x, y)
        dag = MultiOutputNode([b.mul.bind(z, 10), x])
    comp = dag.experimental_compile()
    out["multi"] = [get(comp.execute(v), timeout=60) for v in (3, 0)]
    comp.teardown()
    with InputNode() as inp:
        dag = c.add.bind(b.boom.bind(a.add.bind(inp)))
    comp = dag.experimental_compile()
    refs = [comp.execute(v) for v in (1, 2, 5)]
    out["error_fan_out"] = [get(refs[0], timeout=60),
                            _error(lambda: get(refs[1], timeout=60)),
                            get(refs[2], timeout=60)]
    comp.teardown()
    T = pkg.remote(Tensor)
    ta, tb = T.remote(), T.remote()
    with InputNode() as inp:
        dag = tb.plus.bind(ta.scale.bind(inp).with_channel("array"))
    comp = dag.experimental_compile()
    out["array"] = np.asarray(get(comp.execute(np.arange(4.0)),
                                  timeout=60)).tolist()
    comp.teardown()
    return out


def main(pkg_name: str, what: str) -> None:
    sys.path[:0] = [HERE, ROOT]
    pkg = importlib.import_module(pkg_name)
    pkg.init(num_cpus=4)
    try:
        out = {"dag": dag_scenarios, "cgraph": cgraph_scenarios}[what](pkg)
    finally:
        pkg.shutdown()
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
