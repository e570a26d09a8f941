"""What `test_torch_trainer.py` and `test_torch_tune.py` share: the train
loops and trainables both packages' Train and Tune libraries run, the
scenarios that run them on a cluster, and what each scenario reports.

This module imports neither jax nor torch at its top: the port's worker
processes import it to find the loops a test sends them (the port
exports them by reference), and the reference's side runs it as a child
interpreter's main file:

    python tests/torch_train_helpers.py ray_tpu train|tune STORAGE

which prints one JSON line of results and leaves with `os._exit`. Each
loop finds its package's `train` or `tune` module by the name in its
config (`config["pkg"]`), so one loop serves both packages.
"""

import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# The reference's side, in its child interpreter, gets this long.
CHILD_TIMEOUT_S = 240.0

# The data-parallel MLP (the reference's tests/test_train.py:27-87): a
# tanh layer and a linear head on a linear teacher, 4 workers, Adam 1e-2.
DP_STEPS, DP_BATCH, D_IN, D_H = 30, 64, 8, 16


def dp_init():
    """Initial weights and the teacher, as numpy, from one seed."""
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(D_IN, D_H)) * 0.3).astype(np.float32),
            "w2": (rng.normal(size=(D_H, 1)) * 0.3).astype(np.float32),
            "w_true": rng.normal(size=(D_IN, 1)).astype(np.float32)}


def _train(config):
    return importlib.import_module(config["pkg"] + ".train")


def _tune(config):
    return importlib.import_module(config["pkg"] + ".tune")


def _session(train, mesh_axes):
    """What each DP step reports beside its loss: the session's ranks and
    the gang's mesh (`train.get_mesh`) by axis."""
    return {"rank": train.get_world_rank(),
            "world_size": train.get_world_size(),
            "local_rank": train.get_local_rank(),
            "node_rank": train.get_node_rank(), "mesh": mesh_axes}


def _rank_batches(config, rank, world):
    """Each rank's own batches (distinct seeds), the same in both
    packages."""
    local = config["global_batch"] // world
    rng = np.random.default_rng(100 + rank)
    for _ in range(config["steps"]):
        xs = rng.normal(size=(local, D_IN)).astype(np.float32)
        yield xs, xs @ config["w_true"]


def dp_loop_jax(config):
    """The reference's DP MLP on the global mesh: params replicated, the
    batch sharded over dp, XLA's gradient psum."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    train = _train(config)
    mesh = Mesh(np.array(jax.devices("cpu")), ("dp",))
    replicated = NamedSharding(mesh, P())
    batch_sharded = NamedSharding(mesh, P("dp"))
    rank, world = train.get_world_rank(), train.get_world_size()
    params = {k: jax.device_put(jnp.asarray(config[k]), replicated)
              for k in ("w1", "w2")}
    opt = optax.adam(1e-2)
    opt_state = jax.jit(opt.init)(params)

    def loss_fn(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    @jax.jit
    def step(p, s, x, y):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    gang = train.get_mesh()
    info = _session(train, dict(zip(gang.axis_names, gang.devices.shape)))
    gb = config["global_batch"]
    for i, (xs, ys) in enumerate(_rank_batches(config, rank, world)):
        gx = jax.make_array_from_process_local_data(
            batch_sharded, xs, global_shape=(gb, D_IN))
        gy = jax.make_array_from_process_local_data(
            batch_sharded, ys, global_shape=(gb, 1))
        params, opt_state, loss = step(params, opt_state, gx, gy)
        train.report(dict(info, step=i, loss=float(loss)))


def dp_loop_torch(config):
    """The same MLP as data parallelism over the gang's gloo group: each
    rank's gradient of its local mean loss, averaged by all-reduce (the
    global batch's mean gradient, as JAX's psum gives)."""
    import torch
    import torch.distributed as dist

    train = _train(config)
    rank, world = train.get_world_rank(), train.get_world_size()
    w1 = torch.tensor(config["w1"], requires_grad=True)
    w2 = torch.tensor(config["w2"], requires_grad=True)
    opt = torch.optim.Adam([w1, w2], lr=1e-2)
    gang = train.get_mesh(device="cpu")
    info = _session(train, dict(zip(gang.mesh_dim_names, gang.mesh.shape)))
    for i, (xs, ys) in enumerate(_rank_batches(config, rank, world)):
        x, y = torch.from_numpy(xs), torch.from_numpy(ys)
        loss = torch.mean((torch.tanh(x @ w1) @ w2 - y) ** 2)
        opt.zero_grad()
        loss.backward()
        for p in (w1, w2):
            dist.all_reduce(p.grad)
            p.grad /= world
        opt.step()
        total = loss.detach().clone()
        dist.all_reduce(total)
        train.report(dict(info, step=i, loss=float(total / world)))


def checkpointing_loop(config):
    """The reference's tests/test_train.py:130: every worker exits hard at
    `crash_at` on the first attempt; a restart resumes from the latest
    checkpoint (`resumed_from` says where each attempt began)."""
    train = _train(config)
    Checkpoint = importlib.import_module(config["pkg"] + ".air").Checkpoint
    ckpt = train.get_checkpoint()
    start = ckpt.to_dict()["step"] + 1 if ckpt is not None else 0
    crash_at = config.get("crash_at") if ckpt is None else None
    w = float(ckpt.to_dict()["w"]) if ckpt is not None else 0.0
    for step in range(start, config["steps"]):
        w = w + 1.0
        if crash_at is not None and step == crash_at:
            os._exit(1)
        train.report({"step": step, "w": w, "resumed_from": start},
                     checkpoint=Checkpoint.from_dict({"step": step, "w": w}))


def bad_loop(config):
    raise ValueError("boom in train loop")


def gang_loop(config):
    """The reference's tests/test_tune.py:201: a 2-worker gang per trial."""
    train = _train(config)
    for i in range(3):
        train.report({"loss": config["lr"] * (i + 1),
                      "world": train.get_world_size()})


def grid_objective(config):
    tune = _tune(config)
    for i in range(3):
        tune.report({"loss": (config["x"] - 3) ** 2 + 0.1 * i})


def error_objective(config):
    tune = _tune(config)
    if config["x"] == 2:
        raise RuntimeError("bad trial")
    tune.report({"loss": config["x"]})


def constant_wd():
    """A PBT mutation given as a function (module level in both
    packages' tests)."""
    return 0.123


class PgOwner:
    """Creates a placement group from inside an actor, as Tune's trial
    actor does for its gang."""

    def make(self, pkg_name, bundles):
        util = importlib.import_module(pkg_name + ".util")
        pg = util.placement_group(bundles, strategy="PACK")
        assert pg.wait(30)
        return pg.id


# ---------------------------------------------------------------------------
# Scenarios (each package runs the same ones)
# ---------------------------------------------------------------------------
def trainer_of(pkg):
    """(trainer class, its backend keyword) of `pkg`: gloo on the CPU."""
    train = importlib.import_module(pkg.__name__ + ".train")
    if pkg.__name__ == "ray_tpu":
        return train.JaxTrainer, {"jax_config": train.JaxConfig(
            platform="cpu")}
    return train.TorchTrainer, {"torch_config": train.TorchConfig(
        backend="gloo")}


def _layout(root):
    """Every path under `root`, relative, with trial ids as <trial>."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            parts = rel.split(os.sep)
            if len(parts) > 0 and len(parts[0]) == 8 and all(
                    c in "0123456789abcdef" for c in parts[0]):
                parts[0] = "<trial>"
            out.append("/".join(parts))
    return sorted(out)


def _result_lines(root):
    """Each result.json line's keys (and its telemetry's keys)."""
    for dirpath, _, filenames in os.walk(root):
        if "result.json" in filenames:
            with open(os.path.join(dirpath, "result.json")) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            return [[sorted(k for k in ln if k != "_telemetry"),
                     sorted(ln.get("_telemetry", {}))] for ln in lines]
    return None


def train_scenarios(pkg, storage) -> dict:
    Trainer, backend = trainer_of(pkg)
    train = importlib.import_module(pkg.__name__ + ".train")
    name = pkg.__name__
    out = {}
    init = dp_init()
    dp = Trainer(
        dp_loop_jax if name == "ray_tpu" else dp_loop_torch,
        train_loop_config=dict(init, pkg=name, steps=DP_STEPS,
                               global_batch=DP_BATCH),
        scaling_config=train.ScalingConfig(num_workers=4),
        run_config=train.RunConfig(name="dp_mlp", storage_path=storage),
        **backend).fit()
    out["dp"] = {"losses": [m["loss"] for m in dp.metrics_history],
                 "world_size": dp.metrics["world_size"],
                 "error": dp.error}
    out["ranks"] = {k: dp.metrics[k] for k in
                    ("rank", "world_size", "local_rank", "node_rank")}
    out["mesh"] = dp.metrics["mesh"]
    ckpt = Trainer(
        checkpointing_loop,
        train_loop_config={"pkg": name, "steps": 6, "crash_at": 3},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            name="ckpt_restart", storage_path=storage,
            failure_config=train.FailureConfig(max_failures=1)),
        **backend).fit()
    exp = os.path.join(storage, "ckpt_restart")
    out["ckpt"] = {
        "metrics": ckpt.metrics,
        "history": [(m["step"], m["resumed_from"])
                    for m in ckpt.metrics_history],
        "checkpoint": ckpt.checkpoint.to_dict(),
        "layout": _layout(exp),
        "result_lines": _result_lines(exp),
    }
    try:
        Trainer(bad_loop, train_loop_config={"pkg": name},
                scaling_config=train.ScalingConfig(num_workers=2),
                run_config=train.RunConfig(name="err", storage_path=storage),
                **backend).fit()
        out["error"] = None
    except Exception as e:  # noqa: BLE001
        out["error"] = {"type": type(e).__name__,
                        "boom": "boom in train loop" in str(e)}
    return json.loads(json.dumps(out, default=str))


def _trials(grid):
    return sorted(({"config": {k: v for k, v in t.config.items()
                               if k != "pkg"},
                    "status": t.status, "iterations": t.iterations,
                    "last": {k: v for k, v in t.last_result.items()
                             if k != "trial_id"},
                    "error": ("bad trial" in t.error) if t.error else None}
                   for t in (grid[i] for i in range(len(grid)))),
                  key=lambda r: json.dumps(r["config"], sort_keys=True))


def tune_scenarios(pkg, storage) -> dict:
    tune = importlib.import_module(pkg.__name__ + ".tune")
    air = importlib.import_module(pkg.__name__ + ".air")
    name = pkg.__name__
    out = {}
    grid = tune.Tuner(
        grid_objective,
        param_space={"x": tune.grid_search([1, 2, 3, 4]), "pkg": name},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=air.RunConfig(name="grid", storage_path=storage)).fit()
    out["grid"] = {"trials": _trials(grid),
                   "best": grid.get_best_result().config["x"],
                   "terminated": grid.num_terminated,
                   "errors": grid.num_errors}
    err = tune.Tuner(
        error_objective,
        param_space={"x": tune.grid_search([1, 2]), "pkg": name},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=air.RunConfig(name="err", storage_path=storage)).fit()
    out["error"] = {"trials": _trials(err),
                    "best": err.get_best_result().config["x"],
                    "terminated": err.num_terminated,
                    "errors": err.num_errors}
    Trainer, backend = trainer_of(pkg)
    trainer = Trainer(
        gang_loop, train_loop_config={"pkg": name},
        scaling_config=air.ScalingConfig(num_workers=2),
        run_config=air.RunConfig(name="tune_gang", storage_path=storage),
        **backend)
    gang = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=air.RunConfig(name="tune_gang_exp",
                                 storage_path=storage)).fit()
    out["gang"] = {"trials": _trials(gang),
                   "best": gang.get_best_result().config["lr"],
                   "terminated": gang.num_terminated}
    return json.loads(json.dumps(out, default=str))


# ---------------------------------------------------------------------------
# The reference's side, as a child interpreter
# ---------------------------------------------------------------------------
def run_reference(what: str) -> dict:
    """The reference's results of scenario set `what`, from a child
    interpreter, with storage in a directory of its own, at the port's
    test clusters' lower priority (`torch_cluster_helpers.NICENESS`)."""
    from torch_cluster_helpers import NICENESS

    storage = tempfile.mkdtemp(prefix=f"ref_{what}_")
    proc = subprocess.run(
        ["nice", "-n", str(NICENESS), sys.executable,
         os.path.abspath(__file__), "ray_tpu", what, storage],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"reference child ({what}) exited {proc.returncode}:\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def main(pkg_name: str, what: str, storage: str) -> None:
    sys.path[:0] = [HERE, ROOT]
    pkg = importlib.import_module(pkg_name)
    pkg.init(num_cpus=6)
    try:
        out = {"train": train_scenarios,
               "tune": tune_scenarios}[what](pkg, storage)
    finally:
        pkg.shutdown()
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3])
