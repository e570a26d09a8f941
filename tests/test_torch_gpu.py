"""Tests of the port that need an NVIDIA card (marker `gpu`); without one
they skip. They import neither JAX nor `ray_tpu`, so they also run where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.kernels import flash_attn
from ray_tpu_torch.models import (TransformerConfig, forward, init_params,
                                  lm_loss)
from ray_tpu_torch.serve.engine import TransformerEngineModel

pytestmark = pytest.mark.gpu

# float32: the kernel and its plain version differ only in summation order.
# bf16: 8 mantissa bits, rounded at different magnitudes on the two sides.
F32_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 256, 3, 64), torch.float32, F32_TOL),
    ((1, 384, 2, 128), torch.float32, F32_TOL),
    ((2, 256, 3, 128), torch.bfloat16, BF16_TOL),
    ((1, 128, 4, 64), torch.bfloat16, BF16_TOL),
    ((2, 256, 3, 256), torch.float32, F32_TOL),
    ((2, 256, 3, 256), torch.bfloat16, BF16_TOL),
])
def test_flash_kernel_matches_plain(card, shape, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for _ in range(3))
    before = flash_attn.launches
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    assert o.dtype == dtype and o.is_contiguous()
    o_ref, lse_ref = flash_attn.flash_attn_fwd_plain(q, k, v,
                                                     return_lse=True)
    diff = (o.float() - o_ref.float()).abs()
    assert bool((diff <= tol + tol * o_ref.float().abs()).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_flash_kernel_reads_qkv_views_through_strides(card):
    gen = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((2, 256, 3, 2, 64), generator=gen, device=card)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, _ = flash_attn.flash_attn_fwd(q, k, v)
    o_ref, _ = flash_attn.flash_attn_fwd_plain(q, k, v)
    assert (o - o_ref).abs().max().item() <= F32_TOL


def test_flash_kernel_rejects_misaligned_views(card):
    x = torch.zeros((1, 128, 2, 66), device=card)[..., 1:65]
    with pytest.raises(ValueError, match="strides"):
        flash_attn.flash_attn_fwd(x, x, x)


def _fwd_inputs(card, shape, dtype, layout, qk_scale, seed):
    """q, k, v as views of one [B, S, 3, H, D] tensor (copied apart for
    layout "contiguous"), q and k times `qk_scale`."""
    gen = torch.Generator(device=card).manual_seed(seed)
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=card)
    qkv[:, :, :2] *= qk_scale
    q, k, v = qkv.to(dtype).unbind(2)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


@pytest.mark.parametrize("shape,layout,qk_scale", [
    ((2, 128, 3, 64), "contiguous", 1.0),
    ((1, 128, 2, 128), "qkv", 1.0),
    ((2, 384, 3, 128), "contiguous", 1.0),
    ((1, 384, 4, 64), "qkv", 1.0),
    ((1, 1024, 4, 128), "qkv", 1.0),
    ((1, 1024, 2, 64), "contiguous", 1.0),
    ((2, 1024, 4, 128), "qkv", 4.0),
    ((2, 384, 3, 256), "contiguous", 1.0),
    ((2, 1024, 3, 256), "qkv", 4.0),
])
def test_bf16_fwd_tensor_core_kernel_matches_plain(card, shape, layout,
                                                   qk_scale):
    """The bf16 K1 (wgmma on the tensor cores) against its plain version at
    S 128, 384 (three 128-row blocks) and 1024, D 64, 128 and 256,
    contiguous and as views of a fused QKV tensor, and with q and k scaled
    by 4 (a peaked softmax). Both sides round p to bf16 after subtracting
    the running max up to its 64-key tile and sum in float32, so they differ
    by float32 noise that can move an output by one bf16 ulp or flip the
    rounding of a p: o within 2e-2 of its largest element (about two ulps
    of it) and within 1e-2 relative L2; lse (float32 throughout) within
    1e-3."""
    q, k, v = _fwd_inputs(card, shape, torch.bfloat16, layout, qk_scale, 5)
    before = flash_attn.launches
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    assert o.dtype == torch.bfloat16 and o.is_contiguous()
    assert o.shape == shape and lse.shape == (shape[0], shape[2], shape[1])
    o_ref, lse_ref = flash_attn.flash_attn_fwd_plain(q, k, v,
                                                     return_lse=True)
    g, w = o.float(), o_ref.float()
    assert (g - w).abs().max().item() <= BF16_TOL * w.abs().max().item()
    assert ((g - w).norm() / w.norm()).item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("shape,layout", [
    ((1, 128, 4, 128), "contiguous"),
    ((1, 1024, 4, 128), "qkv"),
    ((2, 1024, 2, 64), "contiguous"),
    ((1, 1024, 3, 256), "qkv"),
])
def test_f32_fwd_kernel_matches_plain(card, shape, layout):
    """The float32 K1 (CUDA cores) at the engine's smallest and largest
    prefill lengths: the same function as its plain version in another
    summation order."""
    q, k, v = _fwd_inputs(card, shape, torch.float32, layout, 1.0, 6)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attn.flash_attn_fwd_plain(q, k, v,
                                                     return_lse=True)
    assert o.dtype == torch.float32 and o.is_contiguous()
    assert bool(((o - o_ref).abs() <= F32_TOL + F32_TOL * o_ref.abs()).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_kernel_is_deterministic(card, dtype):
    """Each block owns the rows it writes, so two launches on the same
    inputs give bitwise-equal o and lse."""
    q, k, v = _fwd_inputs(card, (2, 384, 3, 128), dtype, "qkv", 1.0, 7)
    first = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    second = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_forward_and_engine_prefill_on_card_match_cpu(card):
    """A small model on the card (flash path, S 256) against the same
    weights on the CPU (the kernel's plain version)."""
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2,
                            n_heads=1, d_ff=256, max_seq_len=256,
                            dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = {"embed": cpu["embed"].to(card), "ln_f": cpu["ln_f"].to(card),
           "layers": [{k: t.to(card) for k, t in lp.items()}
                      for lp in cpu["layers"]]}
    tokens = np.random.default_rng(0).integers(0, 64, (1, 256))
    before = flash_attn.launches
    got = forward(gpu, tokens, cfg)[0].cpu()
    assert flash_attn.launches == before + cfg.n_layers
    want = forward(cpu, tokens, cfg, device="cpu")[0]
    assert (got - want).abs().max().item() <= 1e-3
    prompt = tokens[0, :130].tolist()
    g_logits, g_kv = TransformerEngineModel(gpu, cfg).prefill(prompt)
    c_logits, c_kv = TransformerEngineModel(cpu, cfg,
                                            device="cpu").prefill(prompt)
    assert g_kv.device.type == "cuda"
    assert np.abs(g_logits - c_logits).max() <= 1e-3
    assert (g_kv.cpu() - c_kv).abs().max().item() <= 1e-3


@pytest.mark.parametrize("shape,dtype,layout,qk_scale,tol", [
    ((2, 256, 3, 64), torch.float32, "contiguous", 1.0, F32_TOL),
    ((1, 384, 2, 128), torch.float32, "qkv", 1.0, F32_TOL),
    ((2, 256, 3, 128), torch.bfloat16, "contiguous", 1.0, BF16_TOL),
    ((1, 256, 4, 64), torch.bfloat16, "qkv", 1.0, BF16_TOL),
    ((1, 256, 4, 64), torch.float32, "qkv", 1.0, F32_TOL),
    ((2, 384, 3, 128), torch.float32, "contiguous", 1.0, F32_TOL),
    ((1, 512, 2, 128), torch.float32, "qkv", 4.0, F32_TOL),
    ((2, 384, 3, 256), torch.bfloat16, "contiguous", 1.0, BF16_TOL),
    ((1, 512, 2, 256), torch.float32, "qkv", 1.0, F32_TOL),
])
def test_flash_bwd_kernels_match_plain(card, shape, dtype, layout, qk_scale,
                                       tol):
    """K2 and K3 against `flash_attn_bwd_plain` on the same inputs; layout
    "qkv" passes q, k, v as views of one [B, S, 3, H, D] tensor, and q and
    k are scaled by `qk_scale` (4: a peaked softmax). Tolerance relative
    to each output's largest element: float32 differs in summation order;
    bf16 also in a rare flipped rounding of p or ds."""
    gen = torch.Generator(device=card).manual_seed(2)
    if layout == "qkv":
        b, s, h, d = shape
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=card)
        qkv[:, :, :2] *= qk_scale
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn(shape, generator=gen, device=card)
                   for _ in range(3))
        q, k, v = ((q * qk_scale).to(dtype), (k * qk_scale).to(dtype),
                   v.to(dtype))
    do = torch.randn(shape, generator=gen, device=card).to(dtype)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    before = (flash_attn.dkv_launches, flash_attn.dq_launches)
    got = flash_attn.flash_attn_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert (flash_attn.dkv_launches, flash_attn.dq_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attn.flash_attn_bwd_plain(q, k, v, o, do, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.is_contiguous() and g.shape == shape
        w = w.float()
        err = (g.float() - w).abs().max().item()
        assert err <= tol * (1 + w.abs().max().item()), (name, err)


def _bwd_inputs(card, shape, layout, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=card).manual_seed(seed)
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=card)
    q, k, v = qkv.to(dtype).unbind(2)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = torch.randn(shape, generator=gen, device=card).to(dtype)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("shape,layout", [
    ((2, 128, 3, 64), "contiguous"),
    ((1, 128, 2, 128), "qkv"),
    ((2, 384, 3, 128), "contiguous"),
    ((1, 384, 4, 64), "qkv"),
    ((1, 1024, 4, 128), "qkv"),
    ((1, 1024, 2, 64), "contiguous"),
    ((1, 128, 2, 256), "qkv"),
    ((1, 1024, 3, 256), "contiguous"),
])
def test_bf16_bwd_tensor_core_kernels_match_plain(card, shape, layout):
    """The bf16 K2 and K3 (wgmma on the tensor cores) against their plain
    versions at S 128, 384 (three 128-row blocks) and 1024, D 64, 128 and
    256, contiguous and as views of a fused QKV tensor. Both sides round p and
    ds to bf16 where the TPU kernel does and sum in float32, so they differ
    by float32 noise that can move an output by one bf16 ulp or flip the
    rounding of a term: each output within 2e-2 of its largest element
    (about two ulps of it) and within 1e-2 relative L2 of the plain
    version's."""
    q, k, v, o, do, lse = _bwd_inputs(card, shape, layout, 3)
    got = flash_attn.flash_attn_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    want = flash_attn.flash_attn_bwd_plain(q, k, v, o, do, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        assert g.shape == shape
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        assert err <= BF16_TOL * w.abs().max().item(), (name, err)
        assert ((g - w).norm() / w.norm()).item() <= 1e-2, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernels_are_deterministic(card, dtype):
    """Each block owns the rows it writes (no atomics), so two launches
    on the same inputs give bitwise-equal dQ, dK and dV."""
    q, k, v, o, do, lse = _bwd_inputs(card, (2, 384, 3, 128), "qkv", 4,
                                      dtype)
    first = flash_attn.flash_attn_bwd(q, k, v, o, do, lse)
    second = flash_attn.flash_attn_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_kernels_reject_what_they_cannot_take(card):
    x = torch.zeros((1, 128, 2, 192), device=card)   # not in HEAD_DIMS
    lse = torch.zeros((1, 2, 128), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.flash_attn_bwd_dkv(x, x, x, x, lse, lse)
    y = torch.zeros((1, 128, 2, 66), device=card)[..., 1:65]
    do = torch.zeros((1, 128, 2, 64), device=card)
    with pytest.raises(ValueError, match="strides"):
        flash_attn.flash_attn_bwd_dq(y, y, y, do, lse, lse)
    q = torch.zeros((1, 128, 2, 64), device=card)
    with pytest.raises(ValueError, match="dO"):
        flash_attn.flash_attn_bwd_dq(q, q, q, do.transpose(1, 2)
                                     .contiguous().transpose(1, 2), lse, lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attn.flash_attn_bwd_dkv(q, q, q, do, lse.cpu(), lse)


def test_lm_loss_grads_on_card_match_cpu(card):
    """A small model's loss gradients through K1, K2 and K3 on the card
    (remat, save_attn_qkv) against the same weights on the CPU (the
    kernels' plain versions), in float32."""
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2,
                            n_heads=1, d_ff=256, max_seq_len=256,
                            dtype=torch.float32, remat=True,
                            remat_policy="save_attn_qkv")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = {"embed": cpu["embed"].to(card), "ln_f": cpu["ln_f"].to(card),
           "layers": [{k: t.to(card) for k, t in lp.items()}
                      for lp in cpu["layers"]]}
    batch = {"tokens": np.random.default_rng(1).integers(0, 64, (2, 257))}

    def grads(params, device):
        leaves = [params["embed"], params["ln_f"]] + [
            t for lp in params["layers"] for t in lp.values()]
        for t in leaves:
            t.requires_grad_(True)
        loss = lm_loss(params, batch, cfg, device=device)
        return loss, torch.autograd.grad(loss, leaves)

    counts = (flash_attn.launches, flash_attn.dkv_launches,
              flash_attn.dq_launches)
    g_loss, g_grads = grads(gpu, card)
    assert (flash_attn.launches, flash_attn.dkv_launches,
            flash_attn.dq_launches) == tuple(
                c + cfg.n_layers for c in counts)
    c_loss, c_grads = grads(cpu, "cpu")
    assert abs(g_loss.item() - c_loss.item()) <= 1e-4 * c_loss.item()
    for g, c in zip(g_grads, c_grads):
        assert (g.cpu() - c).abs().max().item() <= \
            1e-3 * c.abs().max().item()


def test_moe_forward_and_loss_on_card_match_cpu(card, monkeypatch):
    """A small MoE model (4 experts, top 2) on the card, through K1, K2 and
    K3, against the same weights on the CPU, in float32. The routing
    first: every layer's choices per token, recorded from `top_k_gating`,
    must agree, except where the router probabilities they turn on tie
    within 1e-5; a batch with such a tie is replaced by the next seed's,
    and ties on all three fail. Then logits and aux, and the `lm_loss`
    gradients (remat save_attn_qkv), with the dense model's card
    tolerances."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    moe = importlib.import_module("ray_tpu_torch.ops.moe")
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2,
                            n_heads=1, d_ff=256, max_seq_len=256,
                            dtype=torch.float32, num_experts=4,
                            remat=True, remat_policy="save_attn_qkv")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = {"embed": cpu["embed"].to(card), "ln_f": cpu["ln_f"].to(card),
           "layers": [{k: t.to(card) for k, t in lp.items()}
                      for lp in cpu["layers"]]}
    calls = []
    real = moe.top_k_gating
    monkeypatch.setattr(moe, "top_k_gating", lambda logits, k, c: calls.append(
        logits.detach().cpu()) or real(logits, k, c))

    ties = []
    for seed in (2, 3, 4):
        tokens = np.random.default_rng(seed).integers(0, 64, (2, 257))
        calls.clear()
        before = flash_attn.launches
        g_logits, g_aux = forward(gpu, tokens[:, :-1], cfg)
        assert flash_attn.launches == before + cfg.n_layers
        c_logits, c_aux = forward(cpu, tokens[:, :-1], cfg, device="cpu")
        assert len(calls) == 2 * cfg.n_layers
        tied = 0
        for g, c in zip(calls[:cfg.n_layers], calls[cfg.n_layers:]):
            g_choice, _ = smoke.route_choices(g, cfg.moe_top_k)
            c_choice, gap = smoke.route_choices(c, cfg.moe_top_k)
            differ = (g_choice != c_choice).any(-1)
            assert bool((gap[differ] <= 1e-5).all()), gap[differ]
            tied += int(differ.sum())
        ties.append(tied)
        if not tied:
            break
    assert not ties[-1], f"tied routing choices on every batch: {ties}"
    assert (g_logits.cpu() - c_logits).abs().max().item() <= 1e-3
    assert abs(g_aux.item() - c_aux.item()) <= 1e-5 * c_aux.item()

    def grads(params, device):
        leaves = [params["embed"], params["ln_f"]] + [
            t for lp in params["layers"] for t in lp.values()]
        for t in leaves:
            t.requires_grad_(True)
        loss = lm_loss(params, {"tokens": tokens}, cfg, device=device)
        return loss, torch.autograd.grad(loss, leaves)

    counts = (flash_attn.launches, flash_attn.dkv_launches,
              flash_attn.dq_launches)
    g_loss, g_grads = grads(gpu, card)
    assert (flash_attn.launches, flash_attn.dkv_launches,
            flash_attn.dq_launches) == tuple(
                c + cfg.n_layers for c in counts)
    c_loss, c_grads = grads(cpu, "cpu")
    assert abs(g_loss.item() - c_loss.item()) <= 1e-4 * c_loss.item()
    for g, c in zip(g_grads, c_grads):
        assert (g.cpu() - c).abs().max().item() <= \
            1e-3 * c.abs().max().item()


def test_prefix_ship_moves_flagship_blocks_bitwise(card):
    """Prefix shipping between two engines whose pools live on the card:
    two sealed float32 blocks at the flagship width (12 layers, 12 heads,
    head_dim 128: 2,359,296 bytes a block) go from one pool to host wire
    frames and into the other pool, bitwise."""
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from ray_tpu_torch.serve.fleet import encode_prefix_frames, ship_prefix

    cfg = TransformerConfig(vocab_size=32768, d_model=1536, n_layers=12,
                            n_heads=12, d_ff=6144, max_seq_len=1024,
                            dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         card)
    src, dst = (InferenceEngine(TransformerEngineModel(params, cfg, card),
                                EngineConfig(block_size=16, num_blocks=8))
                for _ in range(2))
    prompt = np.random.default_rng(3).integers(2, 32768, 40).tolist()
    stream = src.submit(prompt, 2)
    while src.step():
        pass
    assert len(list(stream)) == 2
    chunks, kvs = src.export_prefix(prompt)
    frames = encode_prefix_frames(chunks, kvs)
    assert [len(f) for f in frames[1:]] == [len(frames[1])] * 2
    assert len(frames[1]) > 16 * 12 * 2 * 12 * 128 * 4
    assert ship_prefix(src, dst, prompt) == 32
    pools = [eng.cache.with_pool(lambda pool: pool) for eng in (src, dst)]
    assert all(pool.is_cuda for pool in pools)
    pairs = zip(src.prefix_index.export_chain(prompt),
                dst.prefix_index.export_chain(prompt))
    n = 0
    for (chunk_s, block_s), (chunk_d, block_d) in pairs:
        assert chunk_s == chunk_d
        assert torch.equal(pools[0][block_s], pools[1][block_d])
        n += 1
    assert n == 2


class _CardLLM:
    """A Serve deployment hosting an engine over a small model on the
    card; `factory` builds the model."""

    def __init__(self, factory):
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        self.engine = InferenceEngine(factory(), EngineConfig(
            block_size=16, num_blocks=32, max_batch_size=4))
        self.engine.start()

    def generate(self, req):
        yield from self.engine.submit(req["prompt"], req["max_new_tokens"])

    def stop_engine(self):
        self.engine.stop()
        return True


_CARD_SERVE = {}


def _card_serve_model():
    return TransformerEngineModel(*_CARD_SERVE["model"])


def test_serve_llm_on_card_streams_the_engines_tokens(card):
    """`serve.run` of an engine on the card: the streamed tokens are plain
    ints and equal an engine of the same model driven directly; prefill
    runs K1 in the replica."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2,
                            n_heads=1, d_ff=256, max_seq_len=256,
                            dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         card)
    _CARD_SERVE["model"] = (params, cfg, card)
    prompt = np.random.default_rng(4).integers(2, 64, 130).tolist()
    direct = InferenceEngine(_card_serve_model(), EngineConfig(
        block_size=16, num_blocks=32, max_batch_size=4))
    stream = direct.submit(prompt, 6)
    while direct.step():
        pass
    want = stream.tokens_so_far()
    ray_tpu_torch.init(local_mode=True)
    try:
        handle = serve.run(serve.deployment(_CardLLM, version="v1").bind(
            _card_serve_model), route_prefix="/llm")
        before = flash_attn.launches
        got = list(handle.options(stream=True, method_name="generate")
                   .remote({"prompt": prompt, "max_new_tokens": 6}))
        launched = flash_attn.launches - before
        handle.options(method_name="stop_engine").remote().result(
            timeout_s=60)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert all(type(t) is int for t in got)
    assert got == want
    assert launched == cfg.n_layers


def _visible_card():
    """A task's view of the cards: its CUDA_VISIBLE_DEVICES and CUDA's
    device count."""
    import os

    return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count()


@pytest.mark.parametrize("num_gpus,want_visible,want_count", [
    (1, "0", 1), (0.5, "0", 1), (0, "", 0)])
def test_cluster_gpu_lease_shows_its_card(card, num_gpus, want_visible,
                                          want_count):
    """A cluster started on one real card detects it, and a task's GPU
    lease is what CUDA shows it: one card for a whole or half lease, none
    without one."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
        task = ray_tpu_torch.remote(num_gpus=num_gpus)(_visible_card)
        got = ray_tpu_torch.get(
            task.options(_metadata={"inline": False}).remote(), timeout=120)
    finally:
        ray_tpu_torch.shutdown()
    assert got == (want_visible, want_count)


_CARD_TRAIN = dict(vocab_size=64, d_model=128, n_layers=2, n_heads=1,
                   d_ff=256, max_seq_len=256)
_CARD_TRAIN_STEPS = 3


def _card_train_losses(config=None):
    """A narrow bf16 transformer's train steps on this process's card (K1,
    K2, K3 at head dim 128): the losses and each step's launches."""
    from ray_tpu_torch.parallel import adamw, make_train_step

    cfg = TransformerConfig(dtype=torch.bfloat16, remat=True,
                            remat_policy="save_attn_qkv", **_CARD_TRAIN)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    optimizer = adamw(1e-3)
    opt_state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), optimizer)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 129),
                                     generator=gen, device="cuda")}
    out = []
    for _ in range(_CARD_TRAIN_STEPS):
        before = (flash_attn.launches, flash_attn.dkv_launches,
                  flash_attn.dq_launches)
        params, opt_state, loss = step(params, opt_state, batch)
        after = (flash_attn.launches, flash_attn.dkv_launches,
                 flash_attn.dq_launches)
        out.append((loss.item(), [a - b for a, b in zip(after, before)]))
    return out


def _card_train_loop(config):
    from ray_tpu_torch import train

    for loss, launches in _card_train_losses():
        train.report({"loss": loss, "launches": launches,
                      "visible": __import__("os").environ.get(
                          "CUDA_VISIBLE_DEVICES")})


def test_torch_trainer_on_card_matches_in_process(card, tmp_path):
    """A 1-worker `TorchTrainer` gang leasing the card (NCCL, world 1)
    runs the narrow model's steps with the losses of the same steps run
    in this process, K1, K2 and K3 once per layer per step in the
    worker."""
    import ray_tpu_torch
    from ray_tpu_torch import train

    want = _card_train_losses()
    ray_tpu_torch.init(num_cpus=2)
    try:
        result = train.TorchTrainer(
            _card_train_loop,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True,
                                               gpus_per_worker=1),
            run_config=train.RunConfig(name="card",
                                       storage_path=str(tmp_path))).fit()
    finally:
        ray_tpu_torch.shutdown()
    got = [(m["loss"], m["launches"]) for m in result.metrics_history]
    assert got == [(loss, [2, 2, 2]) for loss, _ in want]
    assert {m["visible"] for m in result.metrics_history} == {"0"}


def test_bundle_gpu_lease_shows_its_card(card):
    """A placement group's bundle reserves the card; whole and half GPU
    leases inside it see that card, and the group's removal frees it."""
    import ray_tpu_torch
    from ray_tpu_torch.util import placement_group, remove_placement_group

    ray_tpu_torch.init(num_cpus=2)
    try:
        pg = placement_group([{"CPU": 1, "GPU": 1}])
        assert pg.wait(30)
        got = [ray_tpu_torch.get(
            ray_tpu_torch.remote(num_gpus=n)(_visible_card).options(
                placement_group=pg, placement_group_bundle_index=0,
                _metadata={"inline": False}).remote(), timeout=120)
            for n in (1, 0.5)]
        remove_placement_group(pg)
    finally:
        ray_tpu_torch.shutdown()
    assert got == [("0", 1), ("0", 1)]


def _nccl_sum_loop(config):
    import torch.distributed as dist

    from ray_tpu_torch import train

    x = torch.full((4,), float(train.get_world_rank() + 1), device="cuda")
    dist.all_reduce(x)
    train.report({"sum": x[0].item(), "backend": dist.get_backend()})


def test_nccl_gang_of_two_ranks(card, tmp_path):
    """Two workers, one card each, all-reduce over NCCL. NCCL takes one
    rank per card, so this needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA cards for 2 NCCL ranks (one rank per "
                    f"card); this machine has {torch.cuda.device_count()}")
    import ray_tpu_torch
    from ray_tpu_torch import train

    ray_tpu_torch.init(num_cpus=4)
    try:
        result = train.TorchTrainer(
            _nccl_sum_loop,
            scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True,
                                               gpus_per_worker=1),
            run_config=train.RunConfig(name="nccl",
                                       storage_path=str(tmp_path))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.metrics == {"sum": 3.0, "backend": "nccl"}


class _CardStage:
    """A stage of a compiled graph in a worker leasing half the card."""

    def make(self, seed):
        gen = torch.Generator(device="cuda").manual_seed(int(seed))
        return torch.randn((64, 1024), generator=gen, device="cuda")

    def arrived(self, x):
        """What came over the edge, and the tensor itself (which the
        output edge carries back to the driver's card)."""
        return (type(x).__name__, x.device.type, str(x.dtype)), x


def test_array_edge_between_gpu_leased_workers_lands_a_cuda_tensor(card):
    """`"array"` edge, worker to worker on one card: the tensor crosses as
    host bytes and lands on the reader's card bitwise; the output edge
    brings it to the driver's card; the lazy run (the object store)
    gives the same."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    ray_tpu_torch.init(num_cpus=2)
    try:
        stage = ray_tpu_torch.remote(num_gpus=0.5)(_CardStage)
        head, tail = stage.remote(), stage.remote()
        with InputNode() as inp:
            dag = tail.arrived.bind(head.make.bind(inp).with_channel("array"))
        lazy = [ray_tpu_torch.get(dag.execute(s), timeout=300)
                for s in (1, 2)]
        compiled = dag.experimental_compile(max_in_flight=2)
        try:
            got = [ray_tpu_torch.get(compiled.execute(s), timeout=300)
                   for s in (1, 2, 3)]
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
    for seed, (seen, out) in zip((1, 2, 3), got):
        want = _CardStage().make(seed)
        assert seen == ("Tensor", "cuda", "torch.float32")
        assert out.is_cuda and torch.equal(out, want)
    for seed, (seen, out) in zip((1, 2), lazy):
        assert seen == ("Tensor", "cuda", "torch.float32")
        assert out.is_cuda and torch.equal(out, _CardStage().make(seed))


class _CardEngine:
    """A model id's engine on the card; dropping it stops the engine's
    scheduler thread (which holds the engine), so its tensors go."""

    def __init__(self, seed: int, cfg):
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed))
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in _tensor_leaves(params))
        self.engine = InferenceEngine(
            TransformerEngineModel(params, cfg),
            EngineConfig(max_batch_size=4, block_size=16, num_blocks=64))
        self.engine.start()

    def __del__(self):
        self.engine.stop()


def _tensor_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for v in items for t in _tensor_leaves(v)]


def test_multiplex_eviction_frees_card_memory(card):
    """Multiplexed engines on the card behind an LRU of one: loading a
    second id evicts the first, whose bytes go at once when no request
    holds it; an evicted engine a request holds keeps its bytes until
    the request's loan ends, and its stream finishes."""
    import asyncio

    from ray_tpu_torch.serve import multiplex

    cfg = TransformerConfig(vocab_size=4096, d_model=512, n_layers=2,
                            n_heads=4, d_ff=2048, max_seq_len=256,
                            dtype=torch.float32)
    wrapper = multiplex._ModelMultiplexWrapper(
        lambda owner, mid: _CardEngine(int(mid[1:]), cfg), None, 1)

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    async def main():
        out = {"base": allocated()}
        eng = await wrapper.load("m1")
        out["param_bytes"] = eng.param_bytes
        assert len(list(eng.engine.submit([5, 6, 7], 4))) == 4
        del eng
        out["one"] = allocated()
        await wrapper.load("m2")               # evicts m1: nothing holds it
        out["swapped"] = allocated()
        assert wrapper.model_ids == ["m2"] and not wrapper._pending_evict
        scope = multiplex._begin_request_loans()
        held = await wrapper.load("m2")
        stream = held.engine.submit([1, 2, 3], 4)
        del held
        await wrapper.load("m3")               # evicts m2, which is loaned
        out["parked"] = allocated()
        assert set(wrapper._pending_evict) == {"m2"}
        out["tokens"] = list(stream)
        multiplex._end_request_loans(scope)
        out["released"] = allocated()
        return out

    out = asyncio.run(main())
    one_engine = out["one"] - out["base"]
    assert one_engine >= out["param_bytes"]
    # m2 came in and m1 went: m1's bytes were freed at the eviction.
    assert out["one"] + one_engine - out["swapped"] >= out["param_bytes"]
    # While parked, m2 and m3 both hold their bytes; m2's go at the
    # loan's end, after its stream finished.
    assert out["parked"] - out["swapped"] >= out["param_bytes"]
    assert out["parked"] - out["released"] >= out["param_bytes"]
    assert len(out["tokens"]) == 4


# RLlib learners: an update on the card against the same update on the
# CPU, from the same weights and batch (float32, TF32 off). Adam's first
# step is about +-lr an element, so an element whose gradient lies within
# the two devices' rounding of zero may step the other way: the update is
# held as a whole (relative L2 of after - before), the forward's
# statistics to summation order.
RL_UPDATE_REL_L2 = 1e-2
RL_STATS_RTOL = 1e-4


def _hold_rl_update(make_learner, config, batch):
    card_learner = make_learner(dict(config, device=None))
    assert card_learner.device == torch.device("cuda", 0)
    cpu_learner = make_learner(dict(config, device="cpu"))
    before = card_learner.get_weights()
    cpu_learner.set_weights(before)
    stats, cpu_stats = card_learner.update(batch), cpu_learner.update(batch)
    after, ref = card_learner.get_weights(), cpu_learner.get_weights()
    for k in before:
        want = ref[k].astype(np.float64) - before[k]
        got = after[k].astype(np.float64) - before[k]
        assert np.linalg.norm(got - want) <= RL_UPDATE_REL_L2 * max(
            np.linalg.norm(want), 1e-30), k
    for k in cpu_stats:
        assert abs(stats[k] - cpu_stats[k]) <= RL_STATS_RTOL * max(
            abs(cpu_stats[k]), 1e-6), (k, stats[k], cpu_stats[k])


def test_ppo_learner_update_on_card_matches_cpu(card):
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

    rng = np.random.default_rng(0)
    n = 256
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }
    _hold_rl_update(
        lambda config: PPOLearner(DiscreteMLPModule(4, 2, (64, 64)), config),
        {"lr": 3e-4, "num_epochs": 1, "minibatch_size": n, "seed": 0},
        batch)


def test_impala_learner_update_on_card_matches_cpu(card):
    """The Nature-CNN module at full width on 84x84x4 frames."""
    from ray_tpu_torch.rllib.core.impala_learner import ImpalaLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteConvModule

    rng = np.random.default_rng(1)
    T, B = 8, 4
    batch = {
        "obs": rng.integers(0, 256, (T, B, 84, 84, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, (T, B)).astype(np.int32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
        "logp_old": np.log(rng.uniform(0.2, 0.5, (T, B))).astype(np.float32),
        "final_obs": rng.integers(0, 256, (B, 84, 84, 4)).astype(np.float32),
    }
    for use_clip_loss in (False, True):
        _hold_rl_update(
            lambda config: ImpalaLearner(DiscreteConvModule((84, 84, 4), 3),
                                         config),
            {"lr": 5e-4, "seed": 0, "use_clip_loss": use_clip_loss}, batch)


def test_dqn_learner_update_on_card_matches_cpu(card):
    """A double-Q update on a prioritized batch (importance weights not all
    ones), from the same online and target weights. |td| is held per
    sample where the online net's argmax (double-Q's choice of a') agrees
    on the two devices."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

    rng = np.random.default_rng(2)
    n = 64
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "dones": (rng.random(n) < 0.2).astype(np.float32),
        "weights": rng.uniform(0.3, 1.0, n).astype(np.float32),
        "idx": np.arange(n),
    }
    config = {"lr": 5e-4, "seed": 0, "double_q": True}
    card_learner = DQNLearner(DiscreteMLPModule(4, 2, (64, 64)),
                              dict(config, device=None))
    assert card_learner.device == torch.device("cuda", 0)
    assert {p.device for p in card_learner.target.parameters()} == {card}
    cpu_learner = DQNLearner(DiscreteMLPModule(4, 2, (64, 64)),
                             dict(config, device="cpu"))
    before = card_learner.get_weights()
    target = {k: v * 0.9 for k, v in before.items()}
    card_learner.set_weights(before, target=target)
    cpu_learner.set_weights(before, target=target)
    with torch.no_grad():
        agree = (card_learner.module(torch.from_numpy(batch["next_obs"])
                                     .to(card))[0].argmax(1).cpu()
                 == cpu_learner.module(torch.from_numpy(batch["next_obs"])
                                       )[0].argmax(1)).numpy()
    stats, cpu_stats = card_learner.update(batch), cpu_learner.update(batch)
    after, ref = card_learner.get_weights(), cpu_learner.get_weights()
    for k in before:
        want = ref[k].astype(np.float64) - before[k]
        got = after[k].astype(np.float64) - before[k]
        assert np.linalg.norm(got - want) <= RL_UPDATE_REL_L2 * max(
            np.linalg.norm(want), 1e-30), k
    td, cpu_td = stats.pop("td_abs"), cpu_stats.pop("td_abs")
    assert agree.sum() >= n - 2
    np.testing.assert_allclose(td[agree], cpu_td[agree], rtol=RL_STATS_RTOL,
                               atol=RL_STATS_RTOL * 1e-2)
    for k in cpu_stats:
        assert abs(stats[k] - cpu_stats[k]) <= RL_STATS_RTOL * max(
            abs(cpu_stats[k]), 1e-6), (k, stats[k], cpu_stats[k])


def test_multi_agent_ppo_policy_update_on_card_matches_cpu(card):
    """One policy's update on a batch from the multi-agent runner (the
    reference test's env, two independent policies)."""
    import functools
    import os
    import sys

    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
    from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnvRunner

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_rllib_helpers as helpers

    policy = functools.partial(DiscreteMLPModule, obs_dim=4, num_actions=4,
                               hiddens=(32,))
    runner = MultiAgentEnvRunner(helpers.TargetMatch,
                                 {"p0": policy, "p1": policy},
                                 helpers.by_agent, {}, seed=3)
    runner.set_weights({pid: policy().get_weights() for pid in ("p0", "p1")})
    batch = runner.sample(64)["batches"]["p0"]
    assert len(batch["obs"]) == 64
    _hold_rl_update(
        lambda config: PPOLearner(policy(), config),
        {"lr": 3e-4, "num_epochs": 4, "minibatch_size": 128, "seed": 0},
        batch)
