"""The port's Tune (`ray_tpu_torch/tune/`) against the JAX package's.

Search domains, the variant generator and the ASHA and PBT schedulers are
plain Python: the same seeds and the same trial tables go through both
packages' in the test process. Grid search, an error trial and a
TorchTrainer gang per trial run on the port's cluster, and the same
scenarios (`torch_train_helpers.tune_scenarios`) on `ray_tpu`'s in a
child interpreter while the port's side runs. The cluster starts once for
the module.
"""

import concurrent.futures
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_train_helpers as helpers  # noqa: E402
from torch_cluster_helpers import (niced,  # noqa: E402,F401
                                   no_leaked_port_processes,
                                   per_test_deadline)

import ray_tpu.tune.schedulers as jax_sched  # noqa: E402
import ray_tpu.tune.search as jax_search  # noqa: E402
import ray_tpu.tune.trial as jax_trial  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.tune.schedulers as port_sched  # noqa: E402
import ray_tpu_torch.tune.search as port_search  # noqa: E402
import ray_tpu_torch.tune.trial as port_trial  # noqa: E402

pytestmark = pytest.mark.unit


# ---------------------------------------------------------------------------
# Search spaces and schedulers, in the test process
# ---------------------------------------------------------------------------
def _space(search):
    return {"lr": search.loguniform(1e-5, 1e-1), "x": search.uniform(-1, 1),
            "layers": search.randint(1, 9),
            "act": search.choice(["relu", "gelu", "tanh"]),
            "batch": search.grid_search([16, 32]),
            "seed": search.grid_search([0, 1, 2]), "fixed": 7}


@pytest.mark.parametrize("seed", [0, 1, 123])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_variants_match_reference(seed, num_samples):
    want = jax_search.BasicVariantGenerator(
        _space(jax_search), num_samples=num_samples, seed=seed).variants()
    got = port_search.BasicVariantGenerator(
        _space(port_search), num_samples=num_samples, seed=seed).variants()
    assert got == want
    assert len(got) == 6 * num_samples


def test_domains_sample_as_reference():
    import random

    for make in (lambda s: s.loguniform(1e-4, 1.0),
                 lambda s: s.uniform(2, 5), lambda s: s.randint(0, 100),
                 lambda s: s.choice("abcdef")):
        a, b = random.Random(5), random.Random(5)
        want = [make(jax_search).sample(a) for _ in range(20)]
        assert [make(port_search).sample(b) for _ in range(20)] == want
    assert port_search.grid_search([1, 2]) == jax_search.grid_search([1, 2])


def _asha_decisions(sched_mod, trial_mod, mode):
    """One trial table, fed round-robin with staggered arrivals."""
    sched = sched_mod.ASHAScheduler(metric="score", mode=mode, max_t=20,
                                    grace_period=2, reduction_factor=2)
    trials = [trial_mod.Trial(config={"lr": lr}, trial_id=f"t{i}")
              for i, lr in enumerate([0.01, 0.1, 1.0, 10.0, 3.0, 0.5])]
    out = []
    for it in range(1, 21):
        for t in trials[::-1] if it % 3 else trials:
            if t.status == "TERMINATED":
                continue
            d = sched.on_trial_result(
                t, {"score": t.config["lr"] * it, "training_iteration": it})
            if d == sched_mod.TrialScheduler.STOP:
                t.status = "TERMINATED"
            out.append((t.trial_id, it, d))
    return out, {m: list(v) for m, v in sched.rungs.items()}


@pytest.mark.parametrize("mode", ["max", "min"])
def test_asha_decisions_match_reference(mode):
    got = _asha_decisions(port_sched, port_trial, mode)
    want = _asha_decisions(jax_sched, jax_trial, mode)
    assert got == want
    assert any(d == "STOP" for _, _, d in got[0])


def _pbt_exploit(sched_mod, trial_mod):
    """The reference's tests/test_tune_pbt.py:29 table."""
    sched = sched_mod.PBTScheduler(
        metric="score", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 0.2, 0.4]},
        quantile_fraction=0.25, seed=0)
    trials = {f"t{i}": trial_mod.Trial(config={"lr": 0.1 * (i + 1)},
                                       trial_id=f"t{i}") for i in range(4)}
    trials["t3"].checkpoint_dir = "/ckpt/t3"
    out = [sched.on_trial_result(t, {"score": float(i),
                                     "training_iteration": 1})
           for i, t in enumerate(trials.values())]
    out.append(sched.on_trial_result(
        trials["t3"], {"score": 3.0, "training_iteration": 2}))
    out.append(sched.on_trial_result(
        trials["t0"], {"score": 0.0, "training_iteration": 2}))
    out.append(sched.on_trial_result(
        trials["t0"], {"score": 0.1, "training_iteration": 3}))
    return out, {k: (t.config, t.checkpoint_dir) for k, t in trials.items()}


def _pbt_explore(sched_mod, search_mod, p, seed):
    """The reference's tests/test_tune_pbt.py:61 mutation rules."""
    sched = sched_mod.PBTScheduler(metric="m", hyperparam_mutations={
        "lr": search_mod.loguniform(1e-5, 1e-1), "batch": [16, 32, 64],
        "wd": helpers.constant_wd}, resample_probability=p, seed=seed)
    return [sched._explore({"lr": 1e-3, "batch": 32, "wd": 0.5})
            for _ in range(10)]


def test_pbt_decisions_match_reference():
    got = _pbt_exploit(port_sched, port_trial)
    assert got == _pbt_exploit(jax_sched, jax_trial)
    assert got[0][:4] == ["CONTINUE"] * 4
    assert got[0][4:] == ["CONTINUE", "RESTART", "CONTINUE"]
    assert got[1]["t0"][1] == "/ckpt/t3"
    for p, seed in ((0.0, 1), (1.0, 2), (0.25, 3)):
        assert _pbt_explore(port_sched, port_search, p, seed) == \
            _pbt_explore(jax_sched, jax_search, p, seed)


# ---------------------------------------------------------------------------
# Experiments on the clusters
# ---------------------------------------------------------------------------
_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=1)


@pytest.fixture(scope="module")
def reference():
    future = _POOL.submit(helpers.run_reference, "tune")
    yield future
    future.result()


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    niced(lambda: ray_tpu_torch.init(num_cpus=6))
    try:
        yield helpers.tune_scenarios(
            ray_tpu_torch, str(tmp_path_factory.mktemp("port_tune")))
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ref(reference, port):
    return reference.result()


def test_grid_search_matches_reference(port, ref):
    assert port["grid"] == ref["grid"]
    assert port["grid"]["best"] == 3 and port["grid"]["terminated"] == 4


def test_error_trial_matches_reference(port, ref):
    assert port["error"] == ref["error"]
    assert port["error"]["errors"] == 1 and port["error"]["best"] == 1


def test_trainer_gang_via_tuner_matches_reference(port, ref):
    assert port["gang"] == ref["gang"]
    assert port["gang"]["terminated"] == 2 and port["gang"]["best"] == 0.1
    assert {t["last"]["world"] for t in port["gang"]["trials"]} == {2}
