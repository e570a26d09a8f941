"""The port's parallel layer (`ray_tpu_torch.parallel`, ring attention, the
sharded model) against the JAX package's on the same inputs.

Mesh arithmetic runs here; everything on a mesh runs on 8 gloo ranks on the
CPU (`torch_dist.run_ranks`, bodies in `torch_parallel_ranks.py`), spawned
once for the whole module, while the JAX side runs on the conftest's 8
virtual CPU devices. Inputs are numpy arrays made from a seed; the JAX package's
params cross over through `params_from_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_parallel_ranks as ranks
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.transformer import backbone as jax_backbone
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.ops.attention import plain_attention as jax_plain
from ray_tpu.ops.attention import ring_attention as jax_ring
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.models.transformer import param_specs
from ray_tpu_torch.parallel import MeshSpec, make_mesh, mesh_shape_for
from ray_tpu_torch.parallel.mesh import hybrid_layout
from ray_tpu_torch.parallel.spmd import P, placements
from torch_dist import run_ranks

MESH = (2, 1, 2, 2)
# The JAX tests' tolerances: ring forward 2e-5 and gradients 2e-4
# (test_ops_attention.py), sharded forward 5e-5 (test_transformer.py).
RING_TOL, RING_GRAD_TOL, FWD_TOL = 2e-5, 2e-4, 5e-5
WIDTHS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_seq_len=64)
MOE_WIDTHS = dict(WIDTHS, num_experts=4)


def jax_devices_mesh(shape):
    return jax_mesh.make_mesh(shape, devices=jax.devices("cpu")[:8])


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- mesh arithmetic ---------------------------------------------------------


def test_mesh_shape_and_spec_resolve_match_jax():
    for n in range(1, 65):
        assert mesh_shape_for(n) == jax_mesh.mesh_shape_for(n), n
        for kw in ({}, {"tp": 2}, {"pp": 2, "sp": 2}, {"dp": 2, "tp": 4},
                   {"dp": 3, "pp": 1, "sp": 1, "tp": 1}):
            try:
                want = jax_mesh.MeshSpec(**kw).resolve(n)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    MeshSpec(**kw).resolve(n)
                assert str(got.value) == str(e)
            else:
                assert MeshSpec(**kw).resolve(n) == want, (n, kw)


class _FakeSliceDev:
    """A device with an explicit slice (as tests/test_hybrid_mesh.py's)."""

    platform = "tpu"

    def __init__(self, id_, slice_index):
        self.id = id_
        self.slice_index = slice_index


def _fakes(n_slices, per_slice):
    return [_FakeSliceDev(s * per_slice + i, s)
            for s in range(n_slices) for i in range(per_slice)]


@pytest.mark.parametrize("n_slices,per_slice,shape", [
    (2, 4, (4, 1, 1, 2)), (2, 4, None), (1, 8, (4, 1, 1, 2)),
    (4, 2, (4, 1, 1, 2)), (2, 4, (2, 2, 1, 2))])
def test_hybrid_layout_matches_jax(n_slices, per_slice, shape):
    devs = _fakes(n_slices, per_slice)
    want = np.vectorize(lambda d: d.id)(np.asarray(
        jax_mesh.make_hybrid_mesh(shape, devices=devs).devices))
    got = hybrid_layout(shape, [d.id for d in devs],
                        [d.slice_index for d in devs])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 1, 1, 2), (1, 1, 1, 8)])
def test_hybrid_layout_errors_match_jax(shape):
    devs = _fakes(2, 4)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_hybrid_mesh(shape, devices=devs)
    with pytest.raises(ValueError) as got:
        hybrid_layout(shape, [d.id for d in devs],
                      [d.slice_index for d in devs])
    assert str(got.value) == str(want.value)


def test_specs_become_placements():
    spec = param_specs(ranks.config(**WIDTHS))
    layer = spec["layers"][0]
    assert spec["embed"] == P("tp", "dp") and layer["wo"] == P("tp", "dp")
    assert layer["wqkv"] == P("dp", None, "tp") == layer["w13"]
    moe = param_specs(ranks.config(**MOE_WIDTHS))["layers"][1]
    assert moe["moe_w1"] == P("dp", None, "tp")
    assert moe["moe_w2"] == P("dp", "tp", None)
    assert moe["router"] == P(None, None)

    class FakeMesh:
        mesh_dim_names = ("dp", "pp", "sp", "tp")

    from torch.distributed.tensor import Replicate, Shard
    assert placements(FakeMesh, P("tp", "dp")) == (
        Shard(1), Replicate(), Replicate(), Shard(0))
    assert placements(FakeMesh, P(("dp", "sp"), None)) == (
        Shard(0), Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="twice"):
        placements(FakeMesh, P("dp", "dp"))
    with pytest.raises(ValueError, match="mesh order"):
        placements(FakeMesh, P(("sp", "dp")))


def test_make_mesh_in_one_process_makes_its_own_group():
    """A single process with no process group gets a world of one (gloo on
    the CPU): an all-1 mesh, as JAX's make_mesh on one device."""
    assert not dist.is_initialized()
    try:
        mesh = make_mesh((1, 1, 1, 1), device="cpu")
        assert mesh.mesh_dim_names == ("dp", "pp", "sp", "tp")
        assert tuple(mesh.shape) == (1, 1, 1, 1)
        with pytest.raises(ValueError, match="mesh shape"):
            make_mesh((2, 1, 1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


# -- on 8 gloo ranks: ring attention, the sharded forward ---------------------


def _qkv(seed, shape=(2, 32, 4, 8)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _sharded_inputs():
    jcfg = JaxConfig(dtype=jnp.float32, **WIDTHS)
    jmoe = JaxConfig(dtype=jnp.float32, **MOE_WIDTHS)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jmoe_params = jax_init_params(jax.random.PRNGKey(0), jmoe)
    tokens = np.random.default_rng(1).integers(0, 128, (4, 32)).astype(
        np.int32)
    return jcfg, jmoe, jparams, jmoe_params, tokens


@pytest.fixture(scope="module")
def rank_runs():
    """One spawn of 8 ranks for every case of this module: the ring, then
    the sharded forward; each rank's results by case."""
    q, k, v = _qkv(0)
    _, _, jparams, jmoe_params, tokens = _sharded_inputs()
    results = run_ranks(ranks.calls, 8, [
        ("ring", (q, k, v)),
        ("sharded_forward", (np_tree(jparams), np_tree(jmoe_params), tokens,
                             WIDTHS, MOE_WIDTHS))])
    return {"ring": [r[0] for r in results],
            "sharded": [r[1] for r in results]}


@pytest.fixture(scope="module")
def ring_run(rank_runs):
    return _qkv(0), rank_runs["ring"]


def test_make_mesh_layout_matches_jax_device_ids(ring_run):
    _, results = ring_run
    ids = np.vectorize(lambda d: d.id)
    want = ids(np.asarray(jax_devices_mesh(MESH).devices))
    want_auto = ids(np.asarray(jax_mesh.auto_mesh(dp=2, tp=4).devices))
    for r in results:
        np.testing.assert_array_equal(np.array(r["layout"]), want)
        np.testing.assert_array_equal(np.array(r["auto"]), want_auto)


def test_hybrid_mesh_of_cpu_ranks(ring_run):
    """Each CPU rank is its own slice (JAX's process_index rule): the
    default hybrid mesh puts all 8 on dp, slice-major; a model axis wider
    than a slice of one raises."""
    _, results = ring_run
    for r in results:
        h = r["hybrid"]
        assert h["shape"] == (8, 1, 1, 1)
        assert np.array(h["layout"]).ravel().tolist() == list(range(8))
        assert "multiple of the slice count 8" in h["error"]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_plain_forward(ring_run, causal):
    (q, k, v), results = ring_run
    want = np.asarray(jax_plain(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    # JAX's own ring on the same mesh, as test_ops_attention.py runs it.
    mesh = jax_devices_mesh(MESH)
    sharding = NamedSharding(mesh, JP("dp", "sp", "tp", None))
    ring = jax.jit(lambda a, b, c: jax_ring(a, b, c, mesh=mesh,
                                            causal=causal))(
        *(jax.device_put(x, sharding) for x in (q, k, v)))
    np.testing.assert_allclose(np.asarray(ring), want, rtol=RING_TOL,
                               atol=RING_TOL)
    for r in results:
        np.testing.assert_allclose(r["causal" if causal else "full"], want,
                                   rtol=RING_TOL, atol=RING_TOL)


def test_ring_gradients_match(ring_run):
    (q, k, v), results = ring_run
    want = jax.grad(lambda a, b, c: jax_plain(a, b, c, causal=True).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for r in results:
        for got, w in zip(r["grads"], want):
            np.testing.assert_allclose(got, np.asarray(w),
                                       rtol=RING_GRAD_TOL,
                                       atol=RING_GRAD_TOL)


def test_manual_sp_takes_positions_from_the_rank(ring_run):
    """The ring body on each rank's (dp, sp, tp) blocks with no positions
    given: the causal mask must use the block's global positions."""
    (q, k, v), results = ring_run
    want = np.asarray(jax_plain(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True))
    for r in results:
        np.testing.assert_allclose(r["manual"], want, rtol=RING_TOL,
                                   atol=RING_TOL)


@pytest.fixture(scope="module")
def sharded_run(rank_runs):
    jcfg, jmoe, jparams, jmoe_params, tokens = _sharded_inputs()
    results = rank_runs["sharded"]
    want = {name: jax_forward(p, jnp.asarray(tokens), c)
            for name, p, c in (("dense", jparams, jcfg),
                               ("moe", jmoe_params, jmoe))}
    want["backbone"] = jax_backbone(jparams, jnp.asarray(tokens), jcfg)
    return results, want


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_forward_matches_unsharded(sharded_run, name):
    """test_transformer.py::test_sharded_matches_unsharded's mesh and
    tolerance, plus an MoE model (experts over dp, gating over the whole
    batch as JAX's global arrays give it)."""
    results, want = sharded_run
    logits, aux = want[name]
    for r in results:
        got, got_aux = r[name]
        np.testing.assert_allclose(got, np.asarray(logits), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(got_aux, float(aux), rtol=FWD_TOL)
        if name == "dense":
            np.testing.assert_allclose(r["backbone"],
                                       np.asarray(want["backbone"][0]),
                                       rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_each_rank_holds_only_its_share(sharded_run, name):
    """Every leaf's local block is its global shape divided, dim by dim, by
    the sizes of the mesh axes its spec names: 1/8 of wqkv (dp 2, tp 2 of
    a 2 x 2 x 2 mesh, replicated over sp), nothing replicated that the
    spec shards."""
    results, _ = sharded_run
    sizes = dict(zip(("dp", "pp", "sp", "tp"), MESH))
    widths = MOE_WIDTHS if name == "moe" else WIDTHS
    specs = param_specs(ranks.config(**widths))
    flat = {"embed": specs["embed"], "ln_f": specs["ln_f"]}
    for i, lp in enumerate(specs["layers"]):
        flat.update({f"layers/{k}/{i}": s for k, s in lp.items()})
    for r in results:
        for path, (full, local) in r[f"{name}_shares"].items():
            spec = flat[path]
            want = tuple(n // (sizes[a] if a else 1)
                         for n, a in zip(full, tuple(spec) + (None,) * 4))
            assert local == want, (path, full, local, spec)


def test_init_sharded_equals_unsharded_init(sharded_run):
    results, _ = sharded_run
    assert all(r["init_equal"] for r in results)


def test_sharded_adamw_step_matches_unsharded(sharded_run):
    """One AdamW step on DTensor params (mesh (2, 1, 2, 2)) against the
    same step on plain params: the loss within float32 noise, each leaf's
    delta within 1e-3 rel L2 (tests/test_torch_moe.py's bound: Adam
    divides by the gradient's own magnitude, so elements whose gradient
    sits at float32 noise move by noise)."""
    results, _ = sharded_run
    for r in results:
        (loss0, delta0), (loss1, delta1) = r["step"]
        np.testing.assert_allclose(loss1, loss0, rtol=1e-5)
        for path, want in delta0.items():
            got = delta1[path]
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-3, (path, rel)
