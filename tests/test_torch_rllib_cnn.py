"""The port's Nature-CNN trunk (`ray_tpu_torch/models/cnn.py`), conv RL
module, module catalog and synthetic pixel env against the JAX
package's, on the CPU, at the full published width (84x84x4 uint8 frames
-> 20x20x32 -> 9x9x64 -> 7x7x64 -> 512).

The port runs its convolutions in NCHW and must turn the last feature
map back to NHWC before the flatten: `dense_w`'s 3136 rows are in
(h, w, c) order. Holding the features to JAX's from the same weights is
what shows it does. Tolerance: float32 on both sides, sums of up to 3136
products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import cnn as jcnn
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.env import synthetic_atari as jenv
from ray_tpu_torch.models import cnn as tcnn
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.env import synthetic_atari as tenv

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
# The Nature-CNN module with 3 action heads.
NATURE_PARAMS = 1_686_180


def _frames(seed: int, n: int = 4):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, 84, 84, 4), dtype=np.uint8)


def test_cnn_init_names_layouts_and_scales_match_jax():
    cfg = jcnn.CNNConfig()
    want = jcnn.cnn_init(jax.random.PRNGKey(0), cfg)
    got = tcnn.cnn_init(torch.Generator().manual_seed(0), tcnn.CNNConfig(),
                        device="cpu")
    assert {k: v.shape for k, v in want.items()} == {
        k: tuple(v.shape) for k, v in got.items()}
    assert got["conv0_w"].shape == (8, 8, 4, 32)      # HWIO
    assert got["dense_w"].shape == (7 * 7 * 64, 512)  # [in, out]
    for k, v in got.items():
        if k.endswith("_w"):
            assert abs(float(v.std()) / float(np.asarray(want[k]).std())
                       - 1) < 0.1, k
        else:
            assert not v.any(), k


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_cnn_apply_matches_jax_at_full_width(dtype):
    cfg = jcnn.CNNConfig()
    params = jcnn.cnn_init(jax.random.PRNGKey(1), cfg)
    # Biases away from zero so that their broadcast is held too.
    rng = np.random.default_rng(9)
    params = {k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape)
                  ).astype(np.float32) if k.endswith("_b") else np.asarray(v)
              for k, v in params.items()}
    x = _frames(2).astype(dtype)
    want = np.asarray(jcnn.cnn_apply(params, cfg, x))
    got = tcnn.cnn_apply({k: torch.from_numpy(v) for k, v in params.items()},
                         tcnn.CNNConfig(), torch.from_numpy(x))
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_cnn_gradients_match_jax():
    cfg = jcnn.CNNConfig()
    params = {k: np.asarray(v)
              for k, v in jcnn.cnn_init(jax.random.PRNGKey(4), cfg).items()}
    x = _frames(5, n=2)
    grads = jax.grad(lambda p: jnp.sum(jcnn.cnn_apply(p, cfg, x) ** 2))(
        params)
    tparams = {k: torch.from_numpy(v).requires_grad_()
               for k, v in params.items()}
    (tcnn.cnn_apply(tparams, tcnn.CNNConfig(), torch.from_numpy(x)) ** 2
     ).sum().backward()
    for k, p in tparams.items():
        g = np.asarray(grads[k])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_conv_module_apply_matches_jax():
    jmod = jrm.DiscreteConvModule(obs_shape=(84, 84, 4), num_actions=3)
    jparams = jmod.init(jax.random.PRNGKey(6))
    tmod = trm.DiscreteConvModule((84, 84, 4), 3)
    assert sum(p.numel() for p in tmod.parameters()) == NATURE_PARAMS
    assert {k: v.shape for k, v in jparams.items()} == {
        k: tuple(v.shape) for k, v in tmod.params().items()}
    trm.module_params_from_jax(jparams, tmod)
    # Heads at the trunk's scale, so the logits are not all near zero.
    w = tmod.get_weights()
    w["pi_w_out"] = w["pi_w_out"] * 100
    tmod.set_weights(w)
    jparams = dict(jparams, pi_w_out=w["pi_w_out"])
    obs = _frames(7)
    want_logits, want_value = jmod.apply(jparams, obs)
    with torch.no_grad():
        logits, value = tmod(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **CONV_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               **CONV_TOL)


def test_module_catalog_routes_by_shape():
    for shape, actions, model in (((4,), 2, "auto"), ((84, 84, 4), 6, "auto"),
                                  ((84, 84, 4), 6, "conv"),
                                  ((3, 5), 2, "mlp")):
        want = jrm.make_discrete_module(shape, actions, model=model)
        got = trm.make_discrete_module(shape, actions, model=model)
        assert type(got).__name__ == type(want).__name__
    with pytest.raises(ValueError, match="conv model needs"):
        trm.make_discrete_module((4,), 2, model="conv")


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_atari_frames_bit_for_bit(seed):
    """The same seed and actions give the same frames, rewards and
    terminations as the reference's env."""
    want_env = jenv.SyntheticAtariEnv(max_blocks=3, seed=seed)
    env = tenv.SyntheticAtariEnv(max_blocks=3, seed=seed)
    want, _ = want_env.reset(seed=seed)
    got, _ = env.reset(seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (84, 84, 4) and got.dtype == np.uint8
    actions = np.random.default_rng(seed).integers(0, 3, 200)
    steps = 0
    for a in actions:
        want_step = want_env.step(int(a))
        got_step = env.step(int(a))
        np.testing.assert_array_equal(got_step[0], want_step[0])
        assert got_step[1:] == want_step[1:]
        steps += 1
        if got_step[2]:
            break
    assert got_step[2] and steps > 3


def test_atari_wrappers_bit_for_bit():
    class RGBEnv:
        """Frames of a seeded random RGB screen."""

        def __init__(self):
            self.action_space = tenv._Discrete(2)
            self.observation_space = tenv._Box((100, 120, 3), np.uint8)
            self._rng = np.random.default_rng(0)

        def _frame(self):
            return self._rng.integers(0, 256, (100, 120, 3), np.uint8)

        def reset(self, **kw):
            self._rng = np.random.default_rng(0)
            return self._frame(), {}

        def step(self, action):
            return self._frame(), 3.0 * (action - 0.5), False, False, {}

        def close(self):
            pass

    want_env = jenv.wrap_atari(RGBEnv())
    env = tenv.wrap_atari(RGBEnv())
    np.testing.assert_array_equal(env.reset()[0], want_env.reset()[0])
    for a in (0, 1, 1):
        got, want = env.step(a), want_env.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert got[0].shape == (84, 84, 4)
