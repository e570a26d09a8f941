"""The port's ops (`ray_tpu_torch.ops`, `ray_tpu_torch.kernels`) against the
JAX package's on the same inputs.

Inputs come from numpy and go through both frameworks on the CPU. The port's
flash attention runs its kernel's plain version here (CPU tensors); it is
held against the real Pallas TPU kernel run in interpret mode. The CUDA
kernel itself is tested on the card by `tests/test_torch_gpu.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.transformer import _rmsnorm as jax_rmsnorm
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.ops.rotary import apply_rotary as jax_apply_rotary
from ray_tpu.ops.rotary import rotary_freqs as jax_rotary_freqs
from ray_tpu_torch.kernels import flash_attn
from ray_tpu_torch.models import TransformerConfig, forward, params_from_jax
from ray_tpu_torch.models.transformer import _rmsnorm
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs
from ray_tpu_torch.parallel import make_mesh, shard_pytree

import torch_parallel_ranks
from torch_dist import run_ranks

# The packages' `ops` re-export the `attention` function under the
# submodule's name, so the modules are imported by path.
jax_attention = importlib.import_module("ray_tpu.ops.attention")
torch_attention = importlib.import_module("ray_tpu_torch.ops.attention")

F32_TOL = 1e-5
# bf16 keeps 8 mantissa bits: probabilities and outputs round at 2^-8
# relative on both sides, at the same places (p cast to v's dtype).
BF16_TOL = 2e-2
# float16 keeps 11: a few of its ulps (2^-11 relative) of the largest logit.
F16_TOL = 2e-3


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("positions", [
    None,
    [0, 3, 5, 7, 9, 11],        # inside the table
    [14, 15, 16, 17, 40, 2],    # past max_len=16: clamped like JAX
])
def test_rotary_matches_jax(positions):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    cos, sin = rotary_freqs(8, 16)
    jcos, jsin = jax_rotary_freqs(8, 16)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=F32_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=F32_TOL)
    pos_t = None if positions is None else torch.tensor(positions)
    pos_j = None if positions is None else jnp.asarray(positions)
    got = apply_rotary(_t(x), cos, sin, pos_t)
    want = jax_apply_rotary(jnp.asarray(x), jcos, jsin, pos_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = _rmsnorm(_t(x, tdt), _t(scale)).float().numpy()
    want = jax_rmsnorm(jnp.asarray(x, getattr(jnp, dtype)),
                       jnp.asarray(scale))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,positions", [
    (True, None), (False, None), (True, [4, 5, 6, 7, 8, 9, 10, 11])])
def test_plain_attention_matches_jax(causal, positions):
    q, k, v = _qkv(2, (2, 8, 3, 16))
    pos_t = None if positions is None else torch.tensor(positions)
    pos_j = None if positions is None else jnp.asarray(positions)
    got = torch_attention.plain_attention(_t(q), _t(k), _t(v),
                                          causal=causal, positions=pos_t)
    want = jax_attention.plain_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        positions=pos_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 128, 2, 64), "float32"),
    ((1, 256, 2, 128), "float32"),
    ((1, 256, 2, 64), "bfloat16"),
    ((1, 128, 2, 128), "bfloat16"),
])
def test_flash_attention_matches_pallas_kernel(shape, dtype):
    """The port's flash function (its plain version, on the CPU) against
    the Pallas TPU kernel in interpret mode on the same inputs."""
    q, k, v = _qkv(3, shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.flash_attention_tpu(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    want = np.asarray(want.astype(jnp.float32))
    launches = flash_attn.launches
    got = torch_attention.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.dtype == tdt and got.shape == shape
    assert flash_attn.launches == launches   # the CPU runs no kernel
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


@pytest.mark.parametrize("shape", [(1, 256, 2, 128), (1, 384, 2, 64)])
def test_flash_attention_peaked_bf16_matches_pallas_kernel(shape):
    """q and k scaled by 4 (a peaked softmax: the running max moves from
    one 64-key tile to the next and p sits near 1 and 0), bf16, through the
    port's flash function (its plain version) and the Pallas TPU kernel in
    interpret mode. This pins where the port rounds p: to v's dtype after
    subtracting the running max up to its tile, as the kernel on the card
    does. The Pallas kernel takes the whole sequence as one block here, so
    its p is rounded against the row's final max; either way each rounded
    term is within 2^-8 of p, so the outputs differ by at most some 2^-8
    max |v| (BF16_TOL) plus one bf16 ulp of the output where the two
    float32 values straddle a rounding boundary (rtol 2^-7)."""
    q, k, v = _qkv(4, shape)
    q, k = 4 * q, 4 * k
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.flash_attention_tpu(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    got = torch_attention.flash_attention(
        *(_t(t, torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 256, 2, 128), "float32"),
    ((1, 256, 2, 128), "bfloat16"),
    ((1, 256, 2, 64), "float32"),
])
def test_flash_attention_grads_match_pallas_kernel(shape, dtype):
    """dq, dk, dv of the port's flash attention (its autograd function,
    whose backward runs K2's and K3's plain versions on the CPU) against
    the VJP of the Pallas TPU kernel in interpret mode. bf16: both sides
    round p and ds to bf16 before the products, but the forwards round p at
    different running maxima (JAX's one 256-key block, the port's 64-key
    tiles), which moves o, and through di the gradients, by an ulp or two
    (2^-7 relative each)."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_attention.flash_attention_tpu,
                         *(jnp.asarray(a, jdt) for a in (q, k, v)))
        want = vjp(jnp.asarray(do, jdt))
    ts = [_t(a, tdt).requires_grad_() for a in (q, k, v)]
    before = (flash_attn.dkv_launches, flash_attn.dq_launches)
    torch_attention.flash_attention(*ts).backward(_t(do, tdt))
    assert (flash_attn.dkv_launches, flash_attn.dq_launches) == before
    for name, t, w in zip("qkv", ts, want):
        assert t.grad.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(t.grad.numpy(), w, atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(t.grad.float().numpy(), w,
                                       atol=BF16_TOL, rtol=BF16_TOL,
                                       err_msg=name)


def test_flash_plain_logsumexp():
    q, k, v = _qkv(4, (2, 128, 2, 64))
    o, lse = flash_attn.flash_attn_fwd(_t(q), _t(k), _t(v), return_lse=True)
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    scores = np.where(np.tril(np.ones((128, 128), bool)), scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(scores - mx).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 2, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    o_plain, none = flash_attn.flash_attn_fwd(_t(q), _t(k), _t(v))
    assert none is None
    np.testing.assert_array_equal(o.numpy(), o_plain.numpy())


@pytest.mark.parametrize("s,d", [
    (128, 64), (128, 128), (256, 256), (384, 128), (128, 96), (100, 128),
    (64, 64), (128, 32), (512, 192)])
def test_flash_eligible_matches_jax_rule(s, d, monkeypatch):
    """The port's eligibility is the JAX rule on shapes (which also asks
    for a TPU backend, taken as present here), cut to the head dims the
    port's kernels take: at (256, 256) JAX admits its kernel and the port
    sends the shape to plain attention."""
    monkeypatch.setattr(jax_attention.jax, "default_backend",
                        lambda: "tpu")
    x = np.zeros((1, s, 2, d), np.float32)
    assert torch_attention._flash_eligible(torch.from_numpy(x)) == (
        jax_attention._flash_eligible(x) and d in flash_attn.HEAD_DIMS)


def _count_flash(monkeypatch):
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(a) or real(*a))
    return calls


def _offset_view(shape, dtype, offset):
    """A contiguous tensor of `shape` whose base lies `offset` elements
    into its storage."""
    n = int(np.prod(shape))
    return (torch.arange(n + offset, dtype=dtype) / n)[offset:].view(shape)


@pytest.mark.parametrize("case", [
    "float32", "bfloat16", "qkv views", "float16", "float64", "mixed",
    "strided views", "misaligned base"])
def test_kernel_operands_follow_check_inputs(case):
    """Beside the shape rule: the kernels take q, k, v as they are when
    `check_inputs` would, as fresh contiguous copies when only the layout
    rule fails, and not at all (None: plain attention) for a dtype other
    than float32 or bfloat16, or for mixed dtypes."""
    shape = (1, 128, 2, 64)
    q, k, v = (_t(a) for a in _qkv(9, shape))
    if case == "bfloat16":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    elif case == "qkv views":
        q, k, v = torch.zeros(1, 128, 3, 2, 64).unbind(2)
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "strided views":
        q, k, v = torch.zeros(1, 128, 2, 3, 66).unbind(3)
        q, k, v = q[..., :64], k[..., :64], v[..., :64]
    elif case == "misaligned base":
        q = _offset_view(shape, torch.float32, 1)
        assert q.is_contiguous() and q.data_ptr() % 16
    got = torch_attention._kernel_operands(q, k, v)
    if case in ("float16", "float64", "mixed"):
        assert got is None
        return
    flash_attn.check_inputs(*got)              # the kernels take them
    for t, g in zip((q, k, v), got):
        assert torch.equal(g, t)
        copied = case in ("strided views", "misaligned base") and (
            case == "strided views" or t is q)
        assert (g.data_ptr() != t.data_ptr()) == copied
        if copied:
            assert g.is_contiguous()


def test_float16_flash_shaped_model_matches_jax(monkeypatch):
    """A float16 model at a flash-eligible shape (head_dim 64, S 128): JAX
    off the TPU takes plain attention and returns float16 logits; so does
    the port (the kernels take float32 and bfloat16 only)."""
    widths = dict(vocab_size=64, d_model=128, n_layers=1, n_heads=2,
                  d_ff=64)
    jcfg = JaxConfig(dtype=jnp.float16, **widths)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    cfg = TransformerConfig(dtype=torch.float16, **widths)
    calls = _count_flash(monkeypatch)
    tokens = np.random.default_rng(0).integers(0, 64, (1, 128))
    got, _ = forward(params, tokens, cfg, device="cpu")
    want, _ = jax_forward(jparams, jnp.asarray(tokens), jcfg)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    assert calls == []
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=F16_TOL * np.abs(want).max())


def test_strided_views_take_the_kernel_as_copies(monkeypatch):
    """q, k, v as `[..., :64]` views of a float32 [1, 128, 2, 3, 66]
    tensor (rows 198 elements apart, not a multiple of 16 bytes): the port
    runs the kernel on contiguous copies and returns JAX's result, and
    the same values as on contiguous inputs."""
    x = np.random.default_rng(10).standard_normal(
        (1, 128, 2, 3, 66)).astype(np.float32)
    q, k, v = (torch.from_numpy(x)[:, :, :, i, :64] for i in range(3))
    calls = _count_flash(monkeypatch)
    got = torch_attention.attention(q, k, v)
    assert len(calls) == 1 and all(t.is_contiguous() for t in calls[0])
    want = jax_attention.attention(
        *(jnp.asarray(x[:, :, :, i, :64]) for i in range(3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    same = torch_attention.attention(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    assert torch.equal(got, same)


def test_attention_dispatch_routes_like_jax(monkeypatch):
    """JAX's routing: no mesh or a mesh whose axes are all 1 takes the
    flash kernels (causal, standard positions, an eligible shape), explicit
    positions, non-causal or an ineligible shape plain attention; a mesh
    with sp > 1 the ring, and `manual_sp` the ring body with positions
    from the rank; any other mesh plain attention. The mesh cases run on
    gloo ranks (2), the all-1 mesh in this process."""
    calls = []
    real = torch_attention.flash_attention
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (_t(a) for a in _qkv(5, (1, 128, 2, 64)))
    out = torch_attention.attention(q, k, v)
    assert calls == [1]
    ref = torch_attention.plain_attention(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL)
    # Explicit positions, non-causal or an ineligible shape: plain path.
    torch_attention.attention(q, k, v, positions=torch.arange(128))
    torch_attention.attention(q, k, v, causal=False)
    torch_attention.attention(q[:, :100], k[:, :100], v[:, :100])
    assert calls == [1]
    # A mesh whose axes are all 1 is unsharded: the kernels, for plain
    # tensors and for DTensors (unwrapped to their local blocks).
    try:
        mesh = make_mesh((1, 1, 1, 1), device="cpu")
        same = torch_attention.attention(q, k, v, mesh=mesh)
        dq, dk, dv = (shard_pytree({"x": t}, {"x": None}, mesh)["x"]
                      for t in (q, k, v))
        dout = torch_attention.attention(dq, dk, dv, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert calls == [1, 1, 1]
    assert torch.equal(same, out) and torch.equal(dout.full_tensor(), out)

    q, k, v = _qkv(6, (2, 32, 4, 8))
    got = run_ranks(torch_parallel_ranks.dispatch, 2, q, k, v)
    want = np.asarray(jax_attention.plain_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True))
    for r in got:
        assert r["sp_routes"] == ["ring_attention_manual"]
        assert r["manual_routes"] == ["ring_attention_manual"]
        assert r["dp_routes"] == ["plain_attention"]
        for key in ("sp", "manual", "dp"):
            np.testing.assert_allclose(r[key], want, atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=key)


def test_flash_wrapper_rejects_what_the_kernel_cannot_take():
    q, k, v = (_t(a) for a in _qkv(6, (1, 128, 2, 64)))
    with pytest.raises(ValueError, match="shape"):
        flash_attn.flash_attn_fwd(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attn.flash_attn_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 128, 2, 96)
        flash_attn.flash_attn_fwd(x, x, x)
    with pytest.raises(ValueError, match="multiple of 128"):
        x = torch.zeros(1, 192, 2, 64)
        flash_attn.flash_attn_fwd(x, x, x)
    with pytest.raises(ValueError, match="strides"):
        x = torch.zeros(1, 128, 64, 2).transpose(2, 3)
        flash_attn.flash_attn_fwd(x, x, x)
    # Views of a fused QKV projection are taken as they are.
    qkv = torch.zeros(1, 128, 3, 2, 64)
    o, _ = flash_attn.flash_attn_fwd(qkv[:, :, 0], qkv[:, :, 1],
                                     qkv[:, :, 2])
    assert o.shape == (1, 128, 2, 64) and o.is_contiguous()


def test_flash_bwd_wrappers_reject_what_the_kernels_cannot_take():
    q, k, v = (_t(a) for a in _qkv(8, (1, 128, 2, 64)))
    do = torch.ones_like(q)
    lse = torch.zeros(1, 2, 128)
    for fn in (flash_attn.flash_attn_bwd_dkv, flash_attn.flash_attn_bwd_dq):
        with pytest.raises(ValueError, match="head_dim"):
            x = torch.zeros(1, 128, 2, 256)
            fn(x, x, x, x, lse, lse)
        with pytest.raises(ValueError, match="dO"):
            fn(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2),
               lse, lse)
        with pytest.raises(ValueError, match="dO"):
            fn(q, k, v, do.double(), lse, lse)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, do, lse.transpose(1, 2), lse)
        with pytest.raises(ValueError, match="di"):
            fn(q, k, v, do, lse, lse.double())
    # q, k, v as views of a fused QKV projection are taken as they are.
    qkv = torch.randn(1, 128, 3, 2, 64)
    dk, dv = flash_attn.flash_attn_bwd_dkv(*qkv.unbind(2), do, lse, lse)
    dq = flash_attn.flash_attn_bwd_dq(*qkv.unbind(2), do, lse, lse)
    assert dq.is_contiguous() and dk.is_contiguous() and dv.is_contiguous()


@pytest.mark.parametrize("dtype,taken", [(torch.float32, True),
                                         (torch.bfloat16, False)])
def test_flash_wrappers_count_strides_in_bytes(dtype, taken):
    """Strides must be multiples of 16 bytes (the bf16 backward's TMA
    tensor maps read them as they are): a row stride of 68 elements is
    272 bytes in float32, 136 in bf16."""
    x = torch.zeros(1, 128, 2, 68, dtype=dtype)[..., :64]
    lse = torch.zeros(1, 2, 128)
    do = torch.zeros(1, 128, 2, 64, dtype=dtype)
    calls = [lambda: flash_attn.flash_attn_fwd(x, x, x),
             lambda: flash_attn.flash_attn_bwd_dkv(x, x, x, do, lse, lse),
             lambda: flash_attn.flash_attn_bwd_dq(x, x, x, do, lse, lse)]
    for call in calls:
        if taken:
            call()
        else:
            with pytest.raises(ValueError, match="multiples of 16 bytes"):
                call()


def _tf32(x):
    """cvt.rna.tf32.f32 in numpy: float32 rounded to TF32's 10 mantissa
    bits, to nearest with ties away from zero (add half of the 13 dropped
    bits' place to the magnitude, then drop them)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("d,factor", [(64, 1.0), (128, 1.0), (64, 4.0),
                                      (128, 4.0)])
def test_3xtf32_products_keep_float32_accuracy(d, factor):
    """The numerics of float32 products on the tensor cores as 3xTF32,
    which tools/tf32x3_products.py measures on the card: a b summed as
    lo_a hi_b + hi_a lo_b + hi_a hi_b in float32 (hi = tf32(x), lo =
    tf32(x - hi), each product exact in float32) comes within 4x of a
    sequential float32 FMA's error against float64, over sum |a b|, on
    200 dot products; one TF32 pass (hi_a hi_b) does not. Within 4x is
    not within the float32 backward's tolerance at a peaked softmax,
    which is why those kernels stay on the CUDA cores."""
    rng = np.random.default_rng(d + int(factor))
    a, b = (factor * rng.standard_normal((200, d))).astype(np.float32), \
        (factor * rng.standard_normal((200, d))).astype(np.float32)
    exact = (a.astype(np.float64) * b.astype(np.float64)).sum(1)
    mag = np.abs(a.astype(np.float64) * b.astype(np.float64)).sum(1)
    hi_a, hi_b = _tf32(a), _tf32(b)
    lo_a, lo_b = _tf32(a - hi_a), _tf32(b - hi_b)
    fma = np.zeros(200, np.float32)
    split = np.zeros(200, np.float32)
    single = np.zeros(200, np.float32)
    for i in range(d):
        # FMA: the exact product added to the float32 sum, rounded once.
        fma = (fma.astype(np.float64)
               + a[:, i].astype(np.float64) * b[:, i]).astype(np.float32)
        for term in (lo_a[:, i] * hi_b[:, i], hi_a[:, i] * lo_b[:, i],
                     hi_a[:, i] * hi_b[:, i]):
            split = split + term
        single = single + hi_a[:, i] * hi_b[:, i]

    def worst(x):
        return float((np.abs(x.astype(np.float64) - exact) / mag).max())

    assert worst(split) <= 4 * worst(fma), (worst(split), worst(fma))
    assert worst(single) > 4 * worst(fma), (worst(single), worst(fma))
