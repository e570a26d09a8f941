"""The port's pipelined model and sharded train steps against the JAX
package's: GPipe forward on two meshes, the pipelined MoE aux, the 4-D MoE
train step of tests/test_pipeline.py, and `__graft_entry__._dryrun_one`'s
configurations.

Every mesh runs in one spawn of 8 gloo ranks on the CPU for the whole
module (`torch_dist.run_ranks`, bodies in `torch_parallel_ranks.py`); the JAX
side runs on the conftest's 8 virtual CPU devices with the same numpy
inputs and the JAX package's params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_parallel_ranks as ranks
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.models.transformer import (forward_pipelined as jax_pipelined,
                                        lm_loss as jax_lm_loss,
                                        lm_loss_pipelined as jax_loss_pp,
                                        param_specs as jax_param_specs,
                                        pipelined_param_specs as jax_pp_specs,
                                        to_pipelined as jax_to_pipelined)
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import mesh_shape_for
from ray_tpu.parallel.spmd import (batch_sharding as jax_batch_sharding,
                                   make_train_step as jax_train_step,
                                   shard_pytree as jax_shard)
from ray_tpu_torch.models.transformer import (param_specs,
                                              pipelined_param_specs)
from torch_dist import run_ranks

# tests/test_pipeline.py's tolerance for the pipelined forward.
FWD_TOL = 5e-5
# The port and JAX sum in different orders (and the ring, the pipeline's
# psums and FSDP's reduce-scatters add more): float32 noise on a loss.
LOSS_RTOL = 1e-5
# Adam divides each moment by its own root mean square, so where an
# element's gradient sits at float32 noise that noise decides its delta:
# leaves are compared by rel L2, as tests/test_torch_moe.py does.
DELTA_REL_L2 = 1e-3

CFG = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, d_ff=128,
           max_seq_len=64)
MOE = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
           num_experts=2, max_seq_len=32)


def jcfg(widths):
    return JaxConfig(dtype=jnp.float32, **widths)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jmesh(shape):
    return jax_make_mesh(shape, devices=jax.devices("cpu")[:8])


def tokens(seed, b, s, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                         vocab, jnp.int32))


def jax_pipelined_fwd(params, toks, cfg, shape, m):
    mesh = jmesh(shape)
    pp = jax_shard(jax_to_pipelined(params, shape[1]), jax_pp_specs(cfg),
                   mesh)
    toks_s = jax.device_put(toks, NamedSharding(mesh, JP("dp", None)))
    return jax.jit(lambda p, t: jax_pipelined(
        p, t, cfg, mesh, num_microbatches=m))(pp, toks_s)


# -- forward_pipelined -------------------------------------------------------


def _dp2_inputs():
    """Mesh (2, 2, 1, 2): the dense forward with 4 microbatches, and the
    MoE forward with 2 and 4 (its aux)."""
    dense = jax_init_params(jax.random.PRNGKey(0), jcfg(CFG))
    moe = jax_init_params(jax.random.PRNGKey(0), jcfg(MOE))
    toks = tokens(1, 8, 32, 128)
    moe_toks = tokens(1, 8, 32, 64)
    runs = [("dense", "pipelined", (np_tree(dense), toks, CFG, (4,))),
            ("moe", "pipelined", (np_tree(moe), moe_toks, MOE, (2, 4)))]
    return (dense, toks, moe, moe_toks), ((2, 2, 1, 2), runs)


def _sp2_inputs():
    """Mesh (1, 2, 2, 2): the dense forward with 2 microbatches (the ring
    inside the stages); the 4-D MoE train step of tests/test_pipeline.py
    (2 experts, AdamW 3e-3, 8 steps, 2 microbatches); `_dryrun_one`'s
    configuration for this shape (mesh_shape_for(8)), one AdamW 1e-3
    step."""
    dense = jax_init_params(jax.random.PRNGKey(0), jcfg(CFG))
    toks = tokens(1, 8, 32, 128)
    moe = jax_init_params(jax.random.PRNGKey(0), jcfg(MOE))
    moe_toks = tokens(3, 8, 17, 64)
    shape = mesh_shape_for(8)
    assert shape == (1, 2, 2, 2)
    dry_widths = _dryrun_cfg(shape)
    dry = jax_init_params(jax.random.PRNGKey(0), jcfg(dry_widths))
    dry_toks = tokens(1, 2, 33, dry_widths["vocab_size"])
    runs = [("dense", "pipelined", (np_tree(dense), toks, CFG, (2,))),
            ("4d", "train", (np_tree(moe), moe_toks, MOE, 3e-3, 8, 2)),
            ("dryrun", "train", (np_tree(dry), dry_toks, dry_widths, 1e-3,
                                 1, 2))]
    return (dict(dense=(dense, toks), moe=(moe, moe_toks),
                 dryrun=(dry, dry_toks, dry_widths)), (shape, runs))


def _pure_dp_inputs():
    """`_dryrun_one`'s pure-dp shape (8, 1, 1, 1): 16 experts over dp,
    lm_loss(mesh=), batch 16 x 33, one AdamW 1e-3 step."""
    shape = (8, 1, 1, 1)
    widths = _dryrun_cfg(shape)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg(widths))
    toks = tokens(1, 16, 33, widths["vocab_size"])
    runs = [("dryrun", "train", (np_tree(params), toks, widths, 1e-3, 1,
                                 2))]
    return (params, toks, widths), (shape, runs)


@pytest.fixture(scope="module")
def mesh_runs():
    """One spawn of 8 ranks for every mesh of this module, in turn: (2, 2,
    1, 2), (1, 2, 2, 2), (8, 1, 1, 1). Each mesh's (inputs, each rank's
    {case: result})."""
    inputs = [_dp2_inputs(), _sp2_inputs(), _pure_dp_inputs()]
    results = run_ranks(ranks.calls, 8, [("cases", mesh_cases)
                                         for _, mesh_cases in inputs])
    return [(given, [r[i] for r in results])
            for i, (given, _) in enumerate(inputs)]


@pytest.fixture(scope="module")
def dp2_run(mesh_runs):
    return mesh_runs[0]


@pytest.fixture(scope="module")
def sp2_run(mesh_runs):
    return mesh_runs[1]


def test_pipelined_matches_plain(dp2_run):
    (dense, toks, _, _), results = dp2_run
    ref, _ = jax_forward(dense, jnp.asarray(toks), jcfg(CFG))
    for r in results:
        np.testing.assert_allclose(r["dense"][4][0], np.asarray(ref),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_pipelined_with_sp_matches_plain(sp2_run):
    inputs, results = sp2_run
    dense, toks = inputs["dense"]
    ref, _ = jax_forward(dense, jnp.asarray(toks), jcfg(CFG))
    for r in results:
        np.testing.assert_allclose(r["dense"][2][0], np.asarray(ref),
                                   rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_pipelined_moe_aux_matches_jax_pipelined(dp2_run, m):
    """The pipelined MoE aux (capacity per microbatch, each window counted
    once, over n_micro) against JAX's `forward_pipelined` on the same mesh
    shape; test_pipeline.py holds that one within 0.2 of the unpipelined
    aux, and so is this."""
    (_, _, moe, moe_toks), results = dp2_run
    cfg = jcfg(MOE)
    logits, aux = jax_pipelined_fwd(moe, jnp.asarray(moe_toks), cfg,
                                    (2, 2, 1, 2), m)
    _, aux_ref = jax_forward(moe, jnp.asarray(moe_toks), cfg)
    for r in results:
        got_logits, got_aux = r["moe"][m]
        np.testing.assert_allclose(got_aux, float(aux), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got_logits, np.asarray(logits),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(got_aux, float(aux_ref), rtol=0.2)


def test_pipelined_shares(dp2_run):
    """Stage leaves [n_stages, L/n, ...]: each rank holds one stage, and
    within it its dp/tp share (wqkv [2, 2, 64, 3, 64] -> [1, 2, 32, 3,
    32] on (2, 2, 1, 2))."""
    _, results = dp2_run
    for r in results:
        full, local = r["dense"]["shares"]["layers/wqkv"]
        assert full == (2, 2, 64, 3, 64) and local == (1, 2, 32, 3, 32)
        full, local = r["dense"]["shares"]["embed"]
        assert local == (full[0] // 2, full[1] // 2)


# -- train steps -------------------------------------------------------------


def jax_steps(cfg, params, toks, shape, lr, steps, n_micro=2):
    """`steps` of the JAX package's sharded train step (as _dryrun_one and
    test_full_4d_training_step build it): (losses, first step's deltas)."""
    mesh = jmesh(shape)
    if shape[1] > 1:
        p = jax_shard(jax_to_pipelined(params, shape[1]), jax_pp_specs(cfg),
                      mesh)

        def loss_fn(p, b):
            return jax_loss_pp(p, b, cfg, mesh, num_microbatches=n_micro)
    else:
        p = jax_shard(params, jax_param_specs(cfg), mesh)

        def loss_fn(p, b):
            return jax_lm_loss(p, b, cfg, mesh=mesh)
    before = np_tree(p)
    optimizer = optax.adamw(lr)
    state = jax.jit(optimizer.init)(p)
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      jax_batch_sharding(mesh))}
    step = jax_train_step(loss_fn, optimizer, donate=False)
    losses, delta = [], None
    for i in range(steps):
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
        if i == 0:
            delta = jax.tree.map(lambda a, b: np.asarray(a) - b, p, before)
    return losses, delta


def flat_delta(delta, pipelined):
    """JAX deltas under the port's path names: stacked layer leaves as
    `to_pipelined` stacks them ("layers/wqkv"), or per layer
    ("layers/wqkv/1")."""
    out = {"embed": np.asarray(delta["embed"]),
           "ln_f": np.asarray(delta["ln_f"])}
    for k, a in delta["layers"].items():
        a = np.asarray(a)
        if pipelined:
            out[f"layers/{k}"] = a
        else:
            out.update({f"layers/{k}/{i}": a[i] for i in range(a.shape[0])})
    return out


def assert_deltas_close(got, want):
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].reshape(w.shape)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= DELTA_REL_L2, (path, rel)


def test_full_4d_training_step(sp2_run):
    """Every parallelism mode in one train step: pp 2 (GPipe), sp 2 (the
    ring in the stages), tp 2, experts over dp. The first step's AdamW
    deltas match JAX's; 8 steps lower the loss, as JAX's do. The loss
    includes aux, which under sp is each sequence block's own: the port
    adds their mean (the objective JAX's gradient follows, since its
    transpose splits a replicated output's cotangent over the sp blocks),
    while JAX's value is one block's, so the losses agree to 2e-3 here,
    not to float32 noise."""
    inputs, results = sp2_run
    moe, toks = inputs["moe"]
    want_losses, want_delta = jax_steps(jcfg(MOE), moe, toks, (1, 2, 2, 2),
                                        3e-3, 8)
    for r in results:
        losses, delta, _ = r["4d"]
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        np.testing.assert_allclose(losses, want_losses, rtol=2e-3)
        assert_deltas_close(delta, flat_delta(want_delta, True))


def _dryrun_cfg(shape):
    """`__graft_entry__._dryrun_one`'s configuration for `shape`."""
    dp, pp, _, tp = shape
    return dict(vocab_size=256 * tp, d_model=64 if 64 % dp == 0 else 64 * dp,
                n_layers=2 * max(pp, 1), n_heads=4, d_ff=128 * tp,
                max_seq_len=64,
                num_experts=4 if 4 % dp == 0 else 2 * dp, moe_top_k=2)


@pytest.fixture(scope="module")
def pure_dp_run(mesh_runs):
    given, results = mesh_runs[2]
    return given, [r["dryrun"] for r in results]


def _spec_share(full, spec, sizes):
    return tuple(n // (sizes[a] if a else 1)
                 for n, a in zip(full, tuple(spec) + (None,) * len(full)))


@pytest.mark.parametrize("name", ["mixed", "pure_dp"])
def test_dryrun_one_configurations(name, sp2_run, pure_dp_run):
    """One sharded train step of each `_dryrun_one` configuration against
    JAX's: the loss, the AdamW deltas, and each rank's share of every leaf
    (its spec's, on the port's specs)."""
    if name == "mixed":
        inputs, results = sp2_run
        params, toks, widths = inputs["dryrun"]
        results = [r["dryrun"] for r in results]
        shape = (1, 2, 2, 2)
    else:
        (params, toks, widths), results = pure_dp_run
        shape = (8, 1, 1, 1)
    want_losses, want_delta = jax_steps(jcfg(widths), params, toks, shape,
                                        1e-3, 1)
    sizes = dict(zip(("dp", "pp", "sp", "tp"), shape))
    cfg = ranks.config(**widths)
    specs = (pipelined_param_specs(cfg) if shape[1] > 1
             else param_specs(cfg))
    flat = {"embed": specs["embed"], "ln_f": specs["ln_f"]}
    layers = specs["layers"]
    if isinstance(layers, dict):
        flat.update({f"layers/{k}": s for k, s in layers.items()})
    else:
        for i, lp in enumerate(layers):
            flat.update({f"layers/{k}/{i}": s for k, s in lp.items()})
    for losses, delta, leaf_shares in results:
        # Under sp > 1 JAX's loss value carries one sequence block's aux
        # (see test_full_4d_training_step); without sp, float32 noise.
        np.testing.assert_allclose(losses, want_losses,
                                   rtol=2e-3 if shape[2] > 1 else LOSS_RTOL)
        assert_deltas_close(delta, flat_delta(want_delta, shape[1] > 1))
        for path, (full, local) in leaf_shares.items():
            assert local == _spec_share(full, flat[path], sizes), path
