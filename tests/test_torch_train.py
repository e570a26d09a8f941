"""The port's training half (`lm_loss`, the remat policies, the flash
attention backward, `parallel.spmd`) against the JAX package's on the same
inputs.

Weights come from the JAX package's `init_params` and cross over as numpy
through `params_from_jax`; tokens and masks come from numpy. Everything runs
in float32 on the CPU. At the FLASH widths (head_dim 64, S 256) the port's
attention takes its flash path, whose kernels run their plain versions here;
the JAX package's attention on the CPU is its plain softmax.
"""

import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.ad_checkpoint import checkpoint_name

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.models.transformer import lm_loss as jax_lm_loss
from ray_tpu.parallel import spmd as jax_spmd
from ray_tpu_torch.kernels import flash_attn
from ray_tpu_torch.models import (TransformerConfig, forward, lm_loss,
                                  params_from_jax)
from ray_tpu_torch.parallel import adamw, make_eval_step, make_train_step

torch_attention = importlib.import_module("ray_tpu_torch.ops.attention")
transformer = importlib.import_module("ray_tpu_torch.models.transformer")
jax_attention = importlib.import_module("ray_tpu.ops.attention")

# float32 on both sides; the two frameworks sum in different orders, and
# the port's flash backward and JAX's autodiff of plain softmax attention
# are different (equal in exact arithmetic) formulas.
REL_TOL = 1e-4

FLASH = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, d_ff=128,
             max_seq_len=256)
# head_dim 256: one head of 256 at S 128, and two at S 256 over two
# layers; both take the flash path (the kernels' plain versions here).
WIDE_HEAD = dict(vocab_size=64, d_model=256, n_layers=1, n_heads=1,
                 d_ff=128, max_seq_len=128)
WIDE = dict(vocab_size=64, d_model=512, n_layers=2, n_heads=2, d_ff=128,
            max_seq_len=256)
# Heads wider than 256 (the D-slice kernels on the card): one head of D
# over two layers at S 256.
WIDER = {d: dict(vocab_size=64, d_model=d, n_layers=2, n_heads=1, d_ff=128,
                 max_seq_len=256) for d in (384, 512)}
POLICIES = [None, "dots", "dots_batch", "save_attn", "save_attn_qkv"]


def make_pair(widths, seed=0, **extra):
    jcfg = JaxConfig(dtype=jnp.float32, **widths, **extra)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    cfg = TransformerConfig(dtype=torch.float32, **widths, **extra)
    return jparams, jcfg, params_from_jax(np_tree, device="cpu"), cfg


def make_batch(cfg, batch, seq, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, seq + 1)).astype(np.int32)}
    if masked:
        out["mask"] = (rng.random((batch, seq)) < 0.7).astype(np.float32)
    return out


def _paths(params):
    """{path: leaf}, paths in the JAX package's stacked layout
    ("layers/wqkv/1" is layer 1's leaf)."""
    out = {"embed": params["embed"], "ln_f": params["ln_f"]}
    for i, lp in enumerate(params["layers"]):
        out.update({f"layers/{k}/{i}": t for k, t in lp.items()})
    return out


def port_grads(params, batch, cfg):
    """(loss, {path: grad}) of the port's lm_loss."""
    leaves = _paths(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = lm_loss(params, batch, cfg, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, (g.numpy() for g in grads)))


def jax_leaf(tree, path):
    parts = path.split("/")
    if parts[0] == "layers":
        return np.asarray(tree["layers"][parts[1]][int(parts[2])])
    return np.asarray(tree[parts[0]])


def assert_grads_close(got, want_tree, rel=REL_TOL):
    for path, g in got.items():
        w = jax_leaf(want_tree, path)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale,
                                   err_msg=path)


@pytest.mark.parametrize("loss_chunk,masked", [
    (0, False), (128, False), (0, True), (128, True)])
def test_lm_loss_and_grads_match_jax(loss_chunk, masked, monkeypatch):
    jparams, jcfg, params, cfg = make_pair(FLASH, loss_chunk=loss_chunk)
    batch = make_batch(cfg, 2, 256, masked=masked)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    loss, grads = port_grads(params, batch, cfg)
    assert len(calls) == cfg.n_layers          # the flash path ran
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg)))(jparams)
    np.testing.assert_allclose(loss, float(want), rtol=REL_TOL)
    assert_grads_close(grads, jgrads)


def test_grads_equal_across_remat_policies():
    """Recomputing a layer repeats the same float32 ops on the same inputs,
    so every policy gives the gradients of no remat at all."""
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


@pytest.mark.parametrize("policy,k1_calls_per_layer", [
    ("save_attn", 1), ("save_attn_qkv", 1), (None, 2), ("dots", 2)])
def test_named_policies_do_not_rerun_k1(policy, k1_calls_per_layer,
                                        monkeypatch):
    """Under save_attn and save_attn_qkv the backward reads K1's saved
    output and logsumexp (JAX re-runs its K1 there); the other policies
    recompute K1 with the rest of the layer, as JAX does."""
    _, _, params, cfg = make_pair(FLASH)
    cfg = replace(cfg, remat=True, remat_policy=policy)
    calls = []
    real = flash_attn.flash_attn_fwd_plain
    monkeypatch.setattr(flash_attn, "flash_attn_fwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    bwd = []
    real_bwd = flash_attn.flash_attn_bwd_dkv_plain
    monkeypatch.setattr(flash_attn, "flash_attn_bwd_dkv_plain",
                        lambda *a: bwd.append(1) or real_bwd(*a))
    port_grads(params, make_batch(cfg, 1, 256, seed=4), cfg)
    assert len(calls) == k1_calls_per_layer * cfg.n_layers
    assert len(bwd) == cfg.n_layers


@pytest.mark.parametrize("policy", ["save_attn", None])
def test_jax_save_attn_reruns_its_forward_kernel(policy):
    """What the port's named policies change: the gradient of a JAX
    checkpointed flash attention holds four pallas_calls (K1, K1 again, K2,
    K3) under save_only_these_names("attn_out") as under no policy, since
    the kernel's residuals l and m carry no name. The port saves K1's
    logsumexp with its output instead (see the test above)."""
    names = {"save_attn": jax.checkpoint_policies.save_only_these_names(
        "attn_out"), None: None}

    def attend(q, k, v):
        return checkpoint_name(jax_attention.flash_attention_tpu(q, k, v),
                               "attn_out")

    grad = jax.grad(lambda q, k, v: jax.checkpoint(
        attend, policy=names[policy])(q, k, v).astype(jnp.float32).sum(),
        argnums=(0, 1, 2))
    x = jnp.ones((1, 256, 2, 128), jnp.bfloat16)
    assert str(jax.make_jaxpr(grad)(x, x, x)).count("pallas_call") == 4


@pytest.mark.parametrize("grad", [False, True])
def test_calls_without_grad_skip_names_and_lse(grad, monkeypatch):
    """A forward that needs no gradient (the serving engine's) opens no
    name scope and launches K1 without its logsumexp; one that needs
    gradients takes K1 with the logsumexp, through the autograd
    function."""
    _, _, params, cfg = make_pair(FLASH)
    with transformer.checkpoint_name("qkv"):
        assert transformer._NAME.get() is None
    lse = []
    real = torch_attention.flash_attn_fwd
    monkeypatch.setattr(torch_attention, "flash_attn_fwd",
                        lambda *a, **k: lse.append(k.get("return_lse",
                                                         False))
                        or real(*a, **k))
    if grad:
        params["embed"].requires_grad_(True)
    tokens = make_batch(cfg, 1, 128)["tokens"][:, :-1]
    out, _ = forward(params, tokens, cfg, device="cpu")
    assert lse == [grad] * cfg.n_layers
    assert out.requires_grad == grad


def test_unknown_remat_policy_raises():
    _, _, params, cfg = make_pair(FLASH)
    with pytest.raises(ValueError, match="remat_policy"):
        lm_loss(params, make_batch(cfg, 1, 128),
                replace(cfg, remat=True, remat_policy="nothing"),
                device="cpu")


def test_wide_head_dim_matches_jax(monkeypatch):
    """head_dim 256: the port gives JAX's forward and gradients through
    the flash path (the kernels take 256): K1 once per forward, and its
    saved logsumexp feeds K2/K3's plain versions, with and without
    remat."""
    jparams, jcfg, params, cfg = make_pair(WIDE_HEAD)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    batch = make_batch(cfg, 2, 128, seed=5)
    tokens = batch["tokens"][:, :-1]
    got = forward(params, tokens, cfg, device="cpu")[0].detach().numpy()
    want, _ = jax.jit(jax_forward, static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=REL_TOL,
                               atol=REL_TOL * np.abs(want).max())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg)))(jparams)
    assert len(calls) == cfg.n_layers
    for c in (cfg, replace(cfg, remat=True, remat_policy="save_attn")):
        loss, grads = port_grads(params, batch, c)
        np.testing.assert_allclose(loss, float(jloss), rtol=REL_TOL)
        assert_grads_close(grads, jgrads)
    assert len(calls) >= 3 * cfg.n_layers


@pytest.mark.parametrize("policy", [None, "save_attn_qkv"])
def test_head_dim_256_loss_and_grads_match_jax(policy, monkeypatch):
    """Two layers of two heads of 256 at S 256: `lm_loss` and its
    gradients against JAX's `value_and_grad`, through the flash path (the
    flash function once a layer, again under remat; K2 and K3 once a layer
    in the backward), plainly and under bench.py's remat policy."""
    jparams, jcfg, params, cfg = make_pair(WIDE)
    if policy is not None:
        cfg = replace(cfg, remat=True, remat_policy=policy)
    batch = make_batch(cfg, 2, 256, seed=6)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    bwd = []
    real_dkv = flash_attn.flash_attn_bwd_dkv
    monkeypatch.setattr(flash_attn, "flash_attn_bwd_dkv",
                        lambda *a: bwd.append(1) or real_dkv(*a))
    loss, grads = port_grads(params, batch, cfg)
    # Remat runs each layer's forward again in the backward, flash call
    # and all (the named policy keeps K1's outputs, not the call).
    assert calls == [(2, 256, 2, 256)] * cfg.n_layers * (1 + cfg.remat)
    assert len(bwd) == cfg.n_layers
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg)))(jparams)
    np.testing.assert_allclose(loss, float(want), rtol=REL_TOL)
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("head_dim", [384, 512])
def test_head_dim_above_256_forward_loss_and_grads_match_jax(head_dim,
                                                             monkeypatch):
    """Two layers of one head of 384 or 512 at S 256: the forward, then
    `lm_loss` and its gradients under bench.py's remat policy, against
    JAX's, through the flash path: the flash function once a layer in the
    forward and twice in the remat step, K2 and K3 once a layer in the
    backward."""
    jparams, jcfg, params, cfg = make_pair(WIDER[head_dim])
    assert cfg.head_dim == head_dim
    batch = make_batch(cfg, 2, 256, seed=8)
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    bwd = []
    real_dq = flash_attn.flash_attn_bwd_dq
    monkeypatch.setattr(flash_attn, "flash_attn_bwd_dq",
                        lambda *a: bwd.append(1) or real_dq(*a))
    tokens = batch["tokens"][:, :-1]
    got = forward(params, tokens, cfg, device="cpu")[0].detach().numpy()
    want, _ = jax.jit(jax_forward, static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=REL_TOL,
                               atol=REL_TOL * np.abs(want).max())
    assert calls == [(2, 256, 1, head_dim)] * cfg.n_layers
    cfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
    loss, grads = port_grads(params, batch, cfg)
    assert len(calls) == 3 * cfg.n_layers
    assert len(bwd) == cfg.n_layers
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jbatch, jcfg)))(jparams)
    np.testing.assert_allclose(loss, float(jloss), rtol=REL_TOL)
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_deltas_match_optax(steps):
    """Param deltas (not params: at lr 1e-4 they barely move) after AdamW
    steps of the port's `make_train_step` and the JAX package's with
    `optax.adamw(1e-4)`, the optimizer bench.py trains with."""
    jparams, jcfg, params, cfg = make_pair(FLASH)
    batch = make_batch(cfg, 2, 256, seed=6)
    before = jax.tree.map(np.asarray, jparams)
    jstep = jax_spmd.make_train_step(
        lambda p, b: jax_lm_loss(p, b, jcfg), optax.adamw(1e-4),
        donate=False)
    opt = optax.adamw(1e-4)
    jstate = opt.init(jparams)
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    for _ in range(steps):
        jparams, jstate, jloss = jstep(jparams, jstate, jbatch)
    jdelta = jax.tree.map(lambda a, b: np.asarray(a) - b, jparams, before)

    start = {path: t.detach().clone()
             for path, t in _paths(params).items()}
    optimizer = adamw(1e-4)
    state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, device="cpu"),
                           optimizer)
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    for path, t in _paths(params).items():
        got = (t.detach() - start[path]).numpy()
        want = jax_leaf(jdelta, path)
        # One Adam step moves each element by about lr (1e-4); deltas agree
        # to a small share of that.
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-7,
                                   err_msg=path)


def test_adamw_pins_optax_defaults():
    state = adamw(1e-4).init({"w": torch.zeros(2)})
    group = state.param_groups[0]
    assert group["lr"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4


def test_train_step_applies_its_own_optimizer():
    """The step applies the settings of the optimizer it was made with,
    not those of the one that made the state (optax's split: settings in
    the optimizer, moments in the state)."""
    deltas = []
    for init_lr in (1e-3, 1e-4):
        _, _, params, cfg = make_pair(FLASH)
        start = {path: t.detach().clone()
                 for path, t in _paths(params).items()}
        state = adamw(init_lr).init(params)
        step = make_train_step(
            lambda p, b: lm_loss(p, b, cfg, device="cpu"), adamw(1e-3))
        params, state, _ = step(params, state, make_batch(cfg, 1, 128))
        deltas.append({path: (t.detach() - start[path]).numpy()
                       for path, t in _paths(params).items()})
    for path, want in deltas[0].items():
        np.testing.assert_array_equal(deltas[1][path], want, err_msg=path)
    assert state.param_groups[0]["lr"] == 1e-3


def test_eval_step_has_no_grad():
    _, _, params, cfg = make_pair(FLASH)
    evaluate = make_eval_step(lambda p, b: lm_loss(p, b, cfg, device="cpu"))
    loss = evaluate(params, make_batch(cfg, 1, 128))
    assert loss.dim() == 0 and not loss.requires_grad
