"""The port's mixture of experts (`ray_tpu_torch.ops.moe` and the MoE half of
`ray_tpu_torch.models.transformer`) against the JAX package's on the same
inputs.

Router logits, tokens and masks come from numpy; model weights come from
the JAX package's `init_params` and cross over as numpy through
`params_from_jax` (`make_pair` and the gradient helpers are the dense
training tests'). Everything runs on the CPU. At the FLASH widths (head_dim
64, S 256) the port's attention takes its flash path, whose kernels run
their plain versions here; the JAX package's attention on the CPU is its
plain softmax.
"""

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.models.transformer import lm_loss as jax_lm_loss
from ray_tpu.ops import moe as jax_moe
from ray_tpu.parallel import spmd as jax_spmd
from ray_tpu_torch.models import (TransformerConfig, forward, init_params,
                                  lm_loss, moe_ffn, params_from_jax,
                                  top_k_gating)
from ray_tpu_torch.parallel import adamw, make_train_step
from ray_tpu_torch.serve.engine import TransformerEngineModel
from test_torch_train import (_paths, jax_leaf, make_batch, make_pair,
                              port_grads)

# `ops` re-exports the `attention` function under the submodule's name.
torch_attention = importlib.import_module("ray_tpu_torch.ops.attention")

# Gating: the same float32 softmax on identical logits, in another order
# of operations: the choices and positions are exact, combine and aux
# agree to float32 rounding.
GATING_TOL = 1e-6
# moe_ffn in float32: products summed in different orders (relative to
# the output's largest element).
FFN_TOL = 1e-5
# bf16 keeps 8 mantissa bits; the expert products round their inputs and
# outputs at 2^-8 relative on both sides (relative to the largest
# element).
BF16_TOL = 2e-2
# The model, its loss and gradients, float32 on both sides, as the dense
# model's tests hold them.
REL_TOL = 1e-4
# AdamW deltas, per leaf in relative L2. Adam divides each element's
# moment by its own root mean square, so where an element's gradient sits
# at float32 noise (near eps = 1e-8, or two steps' gradients cancelling)
# that noise decides its delta: elementwise bounds would read those few
# elements, an L2 bound reads the leaf. 10 x the gradients' REL_TOL.
DELTA_REL_L2 = 1e-3
POLICIES = [None, "dots", "dots_batch", "save_attn", "save_attn_qkv"]

# FLASH: head_dim 64, S % 128 == 0, so the port's attention takes the
# flash path; TINY: head_dim 16, plain attention.
FLASH = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, d_ff=128,
             max_seq_len=256, num_experts=4)
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128, num_experts=4)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("k,capacity,drops", [
    (1, 8, True), (1, 64, False), (2, 24, True), (2, 128, False)])
def test_top_k_gating_matches_jax(k, capacity, drops):
    """64 tokens over 4 experts: a capacity under the load drops tokens
    (their one-hot position rows are all zero on both sides), one of 64 k
    slots an expert drops none."""
    logits = np.random.default_rng(k).standard_normal(
        (64, 4)).astype(np.float32)
    dispatch, combine, aux = top_k_gating(torch.from_numpy(logits), k,
                                          capacity)
    jd, jc, ja = jax_moe.top_k_gating(jnp.asarray(logits), k, capacity)
    assert dispatch.shape == combine.shape == (64, 4, capacity)
    assert dispatch.dtype == combine.dtype == aux.dtype == torch.float32
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    assert (dispatch.sum().item() < 64 * k) == drops
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc),
                               atol=GATING_TOL)
    np.testing.assert_allclose(aux.item(), float(ja), atol=GATING_TOL)


def test_top_k_gating_ties_take_the_first_expert_as_jax():
    """Logits of two values only, so most tokens tie between experts: both
    frameworks' argmax takes the first index, and the dispatch is the
    same."""
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 2, (48, 4)).astype(np.float32)
    dispatch, combine, aux = top_k_gating(torch.from_numpy(logits), 2, 20)
    jd, jc, ja = jax_moe.top_k_gating(jnp.asarray(logits), 2, 20)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc),
                               atol=GATING_TOL)
    np.testing.assert_allclose(aux.item(), float(ja), atol=GATING_TOL)


def _ffn_inputs(seed, dtype=np.float32):
    """x [2, 16, 32], router [32, 4], w1 [4, 32, 48], w2 [4, 48, 32]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 32))
    router = rng.standard_normal((32, 4)) / 32 ** 0.5
    w1 = rng.standard_normal((4, 32, 48)) / 32 ** 0.5
    w2 = rng.standard_normal((4, 48, 32)) / 48 ** 0.5
    return [a.astype(dtype) for a in (x, router, w1, w2)]


@pytest.mark.parametrize("top_k,capacity_factor", [
    (1, 1.25), (2, 1.25), (1, 0.5), (2, 0.5)])
def test_moe_ffn_matches_jax(top_k, capacity_factor):
    """float32; a capacity factor of 0.5 drops tokens (capacity 4 of 8
    at top_k 1, 8 of 16 at top_k 2)."""
    arrays = _ffn_inputs(top_k)
    y, aux = moe_ffn(*(torch.from_numpy(a) for a in arrays), top_k=top_k,
                     capacity_factor=capacity_factor)
    jy, jaux = jax_moe.moe_ffn(*(jnp.asarray(a) for a in arrays),
                               top_k=top_k, capacity_factor=capacity_factor)
    assert y.shape == (2, 16, 32) and y.dtype == torch.float32
    _close(y.numpy(), jy, FFN_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=GATING_TOL)


def test_moe_ffn_bf16_matches_jax():
    """bf16 tokens, float32 weights (the model's types): the router still
    runs in float32, the expert products in bf16."""
    arrays = _ffn_inputs(3)
    x = arrays[0].astype(jnp.bfloat16)
    y, aux = moe_ffn(torch.from_numpy(arrays[0]).bfloat16(),
                     *(torch.from_numpy(a) for a in arrays[1:]))
    jy, jaux = jax_moe.moe_ffn(jnp.asarray(x),
                               *(jnp.asarray(a) for a in arrays[1:]))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y.float().numpy(), np.asarray(jy, np.float32), BF16_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=GATING_TOL)


def test_moe_ffn_activation_is_tanh_gelu():
    """The default activation is `jax.nn.gelu`'s tanh form: passing
    torch's exact GELU changes the output."""
    arrays = [torch.from_numpy(a) for a in _ffn_inputs(4)]
    y, _ = moe_ffn(*arrays)
    tanh, _ = moe_ffn(*arrays, activation=lambda h: torch.nn.functional
                      .gelu(h, approximate="tanh"))
    exact, _ = moe_ffn(*arrays, activation=torch.nn.functional.gelu)
    assert torch.equal(y, tanh)
    assert not torch.allclose(y, exact, rtol=0, atol=1e-6)


def test_moe_products_split_as_jax_dots_policy_reads_them():
    """The "dots" remat policy saves products without batch dims and
    "dots_batch" all of them: the port's router, dispatch and combine run
    as `aten.mm` and the expert products as `aten.bmm`, as many of each as
    JAX's moe_ffn has dot_generals without and with batch dims."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    arrays = _ffn_inputs(5)
    with Record():
        moe_ffn(*(torch.from_numpy(a) for a in arrays))
    jaxpr = jax.make_jaxpr(jax_moe.moe_ffn)(*(jnp.asarray(a)
                                              for a in arrays))
    dots = [eq for eq in jaxpr.jaxpr.eqns if eq.primitive.name ==
            "dot_general"]
    batched = sum(bool(eq.params["dimension_numbers"][1][0]) for eq in dots)
    assert seen.count(torch.ops.aten.mm.default) == len(dots) - batched == 3
    assert seen.count(torch.ops.aten.bmm.default) == batched == 2


@pytest.mark.parametrize("widths,seq,flash_calls", [
    (FLASH, 256, 2), (TINY, 9, 0)])
def test_moe_forward_matches_jax(widths, seq, flash_calls, monkeypatch):
    jparams, jcfg, params, cfg = make_pair(widths)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    got, aux = forward(params, tokens, cfg, device="cpu")
    want, want_aux = jax_forward(jparams, jnp.asarray(tokens), jcfg)
    assert got.shape == (2, seq, cfg.vocab_size)
    assert len(calls) == flash_calls
    _close(got.numpy(), want, REL_TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=REL_TOL)
    assert aux.item() > 0


@pytest.mark.parametrize("loss_chunk,masked,top_k,capacity_factor", [
    (0, False, 2, 1.25), (128, False, 2, 1.25), (0, True, 1, 1.25),
    (128, True, 2, 0.5)])
def test_moe_lm_loss_and_grads_match_jax(loss_chunk, masked, top_k,
                                         capacity_factor):
    """Loss (cross-entropy plus aux_loss_weight times the layers' aux) and
    every gradient leaf, router and experts included, against
    `jax.value_and_grad(lm_loss)`; capacity factor 0.5 drops tokens."""
    jparams, jcfg, params, cfg = make_pair(
        FLASH, loss_chunk=loss_chunk, moe_top_k=top_k,
        capacity_factor=capacity_factor)
    batch = make_batch(cfg, 2, 256, masked=masked)
    loss, grads = port_grads(params, batch, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg)))(jparams)
    np.testing.assert_allclose(loss, float(want), rtol=REL_TOL)
    assert {p.split("/")[1] for p in grads if p.startswith("layers")} == {
        "ln1", "wqkv", "wo", "ln2", "router", "moe_w1", "moe_w2"}
    for path, g in grads.items():
        _close(g, jax_leaf(jgrads, path), REL_TOL, path)


def test_aux_loss_weight_scales_the_aux_term():
    """lm_loss(weight w) - lm_loss(weight 0) is w times forward's aux."""
    _, _, params, cfg = make_pair(TINY)
    batch = make_batch(cfg, 2, 16, seed=2)
    _, aux = forward(params, batch["tokens"][:, :-1], cfg, device="cpu")
    base = lm_loss(params, batch, replace(cfg, aux_loss_weight=0.0),
                   device="cpu")
    full = lm_loss(params, batch, replace(cfg, aux_loss_weight=0.5),
                   device="cpu")
    np.testing.assert_allclose((full - base).item(), 0.5 * aux.item(),
                               rtol=1e-5)


def test_moe_grads_equal_across_remat_policies():
    """Recomputing a layer repeats its gating on the same inputs, so every
    policy routes the same tokens and gives the gradients of no remat."""
    _, _, params, cfg = make_pair(FLASH)
    batch = make_batch(cfg, 1, 256, seed=3)
    loss0, want = port_grads(params, batch, cfg)
    for policy in POLICIES:
        loss, got = port_grads(params, batch,
                               replace(cfg, remat=True, remat_policy=policy))
        assert loss == pytest.approx(loss0, rel=1e-6), policy
        for path, g in got.items():
            np.testing.assert_allclose(g, want[path], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{policy}: {path}")


def test_moe_train_step_deltas_match_optax():
    """Param deltas after two AdamW steps of the port's `make_train_step`
    and the JAX package's with `optax.adamw(1e-4)`, on an MoE model."""
    jparams, jcfg, params, cfg = make_pair(FLASH)
    batch = make_batch(cfg, 2, 256, seed=6)
    before = jax.tree.map(np.asarray, jparams)
    jstep = jax_spmd.make_train_step(
        lambda p, b: jax_lm_loss(p, b, jcfg), optax.adamw(1e-4),
        donate=False)
    opt = optax.adamw(1e-4)
    jstate = opt.init(jparams)
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    for _ in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jbatch)
    jdelta = jax.tree.map(lambda a, b: np.asarray(a) - b, jparams, before)

    start = {path: t.detach().clone() for path, t in _paths(params).items()}
    optimizer = adamw(1e-4)
    state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, device="cpu"),
                           optimizer)
    for _ in range(2):
        params, state, loss = step(params, state, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    for path, t in _paths(params).items():
        got = (t.detach() - start[path]).numpy()
        want = jax_leaf(jdelta, path)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= DELTA_REL_L2, (path, rel)


def test_params_from_jax_keeps_moe_layouts():
    jparams, _, params, cfg = make_pair(TINY)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    shapes = {"router": (d, e), "moe_w1": (e, d, f), "moe_w2": (e, f, d)}
    for i, lp in enumerate(params["layers"]):
        assert "w13" not in lp and "w2" not in lp
        for key, shape in shapes.items():
            assert tuple(lp[key].shape) == shape
            np.testing.assert_array_equal(
                lp[key].numpy(), np.asarray(jparams["layers"][key][i]))
    with pytest.raises(ValueError, match="neither"):
        params_from_jax({"layers": {"ln1": np.zeros((1, 2)),
                                    "router": np.zeros((1, 2, 2))}},
                        device="cpu")


def test_init_params_moe_layouts_and_scale():
    """N(0, 1/fan_in) with fan_in D for router and moe_w1, F for moe_w2,
    as JAX's `init_params`."""
    cfg = TransformerConfig(dtype=torch.float32, **dict(TINY, d_ff=256))
    params = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    lp = params["layers"][0]
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    assert set(lp) == {"ln1", "wqkv", "wo", "ln2", "router", "moe_w1",
                       "moe_w2"}
    for key, shape, fan_in in (("router", (d, e), d),
                               ("moe_w1", (e, d, f), d),
                               ("moe_w2", (e, f, d), f)):
        assert tuple(lp[key].shape) == shape
        assert lp[key].std().item() == pytest.approx(fan_in ** -0.5,
                                                     rel=0.15), key
    logits, aux = forward(params, [[1, 2, 3]], cfg, device="cpu")
    assert torch.isfinite(logits).all() and aux.item() > 0


def test_engine_rejects_moe_configs():
    """As the JAX engine does (dense configs only)."""
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        TransformerEngineModel(params, cfg, device="cpu")
