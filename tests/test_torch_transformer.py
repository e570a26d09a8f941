"""The port's transformer (`ray_tpu_torch.models.transformer`) against the
JAX package's `forward` on the same weights.

Weights come from the JAX package's `init_params` and cross over as numpy
through `params_from_jax`; token ids come from numpy. Everything runs in
float32 on the CPU, where the port's flash path runs its kernel's plain
version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu_torch.models import (TransformerConfig, forward, init_params,
                                  params_from_jax)

torch_attention = importlib.import_module("ray_tpu_torch.ops.attention")

# float32 on both sides; the two frameworks sum in different orders.
REL_TOL = 1e-4

# A config whose attention takes the flash path (head_dim 64, S % 128 == 0),
# one whose heads are 256 wide (the flash path's widest head dim) and the
# tiny config of the JAX engine's unit tests (head_dim 16: plain).
FLASH = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=1, d_ff=128,
             max_seq_len=256)
WIDE = dict(vocab_size=64, d_model=512, n_layers=2, n_heads=2, d_ff=128,
            max_seq_len=256)
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=128)


def make_pair(widths, seed=0):
    """(JAX params, JAX config, port params on the CPU, port config)."""
    jcfg = JaxConfig(dtype=jnp.float32, **widths)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    cfg = TransformerConfig(dtype=torch.float32, **widths)
    return jparams, jcfg, params_from_jax(np_tree, device="cpu"), cfg


def _count_flash(monkeypatch):
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


@pytest.mark.parametrize("widths,seq,flash_calls", [
    (FLASH, 256, 2), (FLASH, 130, 0), (TINY, 128, 0), (TINY, 9, 0),
    (WIDE, 256, 2)])
def test_forward_matches_jax(widths, seq, flash_calls, monkeypatch):
    jparams, jcfg, params, cfg = make_pair(widths)
    calls = _count_flash(monkeypatch)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    got, aux = forward(params, tokens, cfg, device="cpu")
    got = got.numpy()
    want, want_aux = jax_forward(jparams, jnp.asarray(tokens), jcfg)
    want = np.asarray(want)
    # Each side again on the same inputs: both are deterministic, so a
    # run that varies is named here, apart from the two sides' distance.
    again = forward(params, tokens, cfg, device="cpu")[0].numpy()
    assert np.array_equal(again, got), (
        f"the port's forward varied between two calls: max diff "
        f"{np.abs(again - got).max():.3e}")
    again = np.asarray(jax_forward(jparams, jnp.asarray(tokens), jcfg)[0])
    assert np.array_equal(again, want), (
        f"JAX's forward varied between two calls: max diff "
        f"{np.abs(again - want).max():.3e}")
    # A dense model's load-balancing loss: a float32 zero on both sides.
    assert aux.dtype == torch.float32 and aux.item() == float(want_aux) == 0
    assert got.shape == want.shape == (2, seq, cfg.vocab_size)
    assert len(calls) == 2 * flash_calls      # one per layer when eligible
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=REL_TOL * scale,
                               rtol=REL_TOL)


def test_forward_explicit_positions_take_the_plain_path(monkeypatch):
    jparams, jcfg, params, cfg = make_pair(FLASH)
    calls = _count_flash(monkeypatch)
    tokens = np.random.default_rng(2).integers(0, 64, (1, 256))
    flash, _ = forward(params, tokens, cfg, device="cpu")
    plain, _ = forward(params, tokens, cfg, positions=np.arange(256),
                       device="cpu")
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(plain.numpy(), flash.numpy(), atol=1e-5)


def test_params_from_jax_keeps_layouts():
    jparams, jcfg, params, cfg = make_pair(TINY)
    assert len(params["layers"]) == cfg.n_layers
    hh = cfg.n_heads * cfg.head_dim
    shapes = {"ln1": (32,), "wqkv": (32, 3, hh), "wo": (hh, 32),
              "ln2": (32,), "w13": (32, 2, 64), "w2": (64, 32)}
    for i, lp in enumerate(params["layers"]):
        for key, shape in shapes.items():
            assert tuple(lp[key].shape) == shape
            np.testing.assert_array_equal(
                lp[key].numpy(), np.asarray(jparams["layers"][key][i]))
    assert tuple(params["embed"].shape) == (64, 32)
    assert tuple(params["ln_f"].shape) == (32,)


def test_init_params_layouts_and_seed():
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert tuple(a["layers"][1]["w13"].shape) == (32, 2, 64)
    assert a["embed"].dtype == torch.float32
    torch.testing.assert_close(a["layers"][1]["wqkv"], b["layers"][1]["wqkv"])
    logits, _ = forward(a, [[1, 2, 3]], cfg, device="cpu")
    assert logits.shape == (1, 3, 64) and torch.isfinite(logits).all()


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward(params, [[1, 2]], cfg)
    with pytest.raises(ValueError, match="token ids"):
        forward(params, [[1, 64]], cfg, device="cpu")
