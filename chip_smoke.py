#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every kernel of the port compiled from `ray_tpu_torch/kernels/csrc`
   (one nvcc per source, all at once), with the build seconds;
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, with the error against the stated
   tolerance, the kernel's time (CUDA events), the plain version's time, one
   PyTorch library call's time as a yardstick, and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate for the
   type, whichever is larger);
4. forward: `models.forward` at the flagship width (bf16, 1 x 1024 tokens)
   through the flash kernel, against the same forward on plain attention;
5. engine: the serving engine (`InferenceEngine` over
   `TransformerEngineModel`, paged decode, float32 flagship weights) answers
   8 requests, 4 of them sharing a 256-token prefix, after a warm-up pass of
   the same requests on an engine of its own; the flash kernel must be
   launched by the prefills, and each request's prefill logits, first token
   and greedy continuation are held against a no-cache float32 forward.

Then it prints a `{"kernels": [...]}` line and, last, the result line
`{"ok": true, "device": {...}}`. It imports nothing of JAX or of `ray_tpu`.
Without a CUDA card, or run away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
FULL_POWER_W = 700.0

# Flagship configuration (bench.py's model): V32768 D1536 L12 H12 F6144.
FLAGSHIP = dict(vocab_size=32768, d_model=1536, n_layers=12, n_heads=12,
                d_ff=6144, max_seq_len=1024)

# Tolerances (atol, rtol). float32: the kernel and its plain version
# differ only in summation order. bf16: the plain version rounds p where
# the kernel does, so the two differ by float32 noise, which can move the
# bf16 output by one ulp (at most 2^-7 of it), plus a p-rounding term (see
# p_flip_bound).
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2.0 ** -7)}
# bf16 forward: both attention paths round at 8 mantissa bits, at different
# places, and the difference grows through 12 bf16 layers (flash vs plain
# logits differ by some 1.6e-2 relative L2 on the H100). So each path is
# held against a float32 forward, and the flash path must be about as close
# to it as the plain path is.
FORWARD_ERR_RATIO = 1.25
# float32 engine vs no-cache float32 forward: absolute logit error (logits
# are O(1) at this init); padding, buckets and summation order differ.
ENGINE_LOGIT_ATOL = 1e-3
# Greedy continuation, teacher-forced on the engine's own tokens: a token
# may differ only where the reference's top two logits tie within the
# logit tolerance; below this share of agreeing tokens the run fails.
MIN_TOKEN_AGREEMENT = 0.98

# (shape [B, S, H, D], dtype, layout); the engine prefills f32. Layout
# "qkv" passes q, k, v as views of one [B, S, 3, H, D] tensor, the fused
# QKV projection's layout the engine hands the kernel (its v is such a
# view), so rows are 3 H D elements apart.
KERNEL_SHAPES = [
    ((1, 128, 12, 128), "float32", "contiguous"),
    ((1, 256, 12, 128), "float32", "contiguous"),
    ((1, 512, 12, 128), "float32", "contiguous"),
    ((1, 1024, 12, 128), "float32", "contiguous"),
    ((1, 1024, 12, 128), "float32", "qkv"),
    ((1, 1024, 12, 128), "bfloat16", "contiguous"),
    ((4, 1024, 12, 128), "bfloat16", "contiguous"),
    ((1, 256, 12, 64), "bfloat16", "contiguous"),
]
# The engine's largest bucket.
MAIN_SHAPE = ((1, 1024, 12, 128), "float32", "contiguous")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype: str, power_w: float):
    """(bound_ms at the published peaks, bound_ms derated to the power
    limit, what sets it) for causal attention: 2 B H S (S+1) D operations
    (the lower triangle of Q K^T and of P V) and q, k, v read once, o
    written once."""
    b, s, h, d = shape
    flops = 2.0 * b * h * s * (s + 1) * d
    nbytes = 4.0 * b * s * h * d * (4 if dtype == "float32" else 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    derate = max(1.0, FULL_POWER_W / power_w) if power_w > 0 else 1.0
    return bound, bound * derate, ("operations" if t_ops >= t_bytes
                                   else "bytes")


def p_flip_bound(q, k, v, lse):
    """[B, S, H, D] bound on what a flipped bf16 rounding of p can do to
    o: where the two sides' float32 p straddle a rounding boundary, the
    casts differ by one ulp, at most 2^-7 of p, which moves o[row, :] by at
    most 2^-7 * max_j prob[row, j] * |v[j, :]| over keys j <= row."""
    import torch

    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    row_max = scores.masked_fill(~mask, float("-inf")).amax(-1)
    p_max = torch.exp(row_max - lse).transpose(1, 2)[..., None]
    v_max = torch.cummax(v.float().abs(), dim=1).values
    return 2.0 ** -7 * p_max * v_max


def phase_kernels(card: str, power_w: float):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels import flash_attn

    rows = {}
    for shape, dtype, layout in KERNEL_SHAPES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(len(rows))
        if layout == "qkv":
            b, s, h, d = shape
            q, k, v = torch.randn((b, s, 3, h, d), generator=gen,
                                  device="cuda").to(dt).unbind(2)
        else:
            q, k, v = (torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
                       for _ in range(3))
        out, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attn.flash_attn_fwd_plain(q, k, v,
                                                       return_lse=True)
        diff = (out.float() - ref.float()).abs()
        atol, rtol = KERNEL_TOL[dtype]
        tol = atol + rtol * ref.float().abs()
        note = ""
        if dtype == "bfloat16":
            note = (f" + p_flip_bound; without it: worst diff/tol "
                    f"{(diff / tol).max().item():.3f}, "
                    f"{int((diff > tol).sum())} of {diff.numel()} "
                    f"elements over")
            tol = tol + p_flip_bound(q, k, v, ref_lse)
            note += f"; median tol {tol.median().item():.3e}"
        err = diff.max().item()
        worst = (diff / tol).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = cuda_ms(lambda: flash_attn.flash_attn_fwd(q, k, v), 20)
        plain_ms = cuda_ms(
            lambda: flash_attn.flash_attn_fwd_plain(q, k, v), 5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        bound, derated, bound_by = attention_bound(shape, dtype, power_w)
        rows[(shape, dtype, layout)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_ms_at_power_limit=derated, bound_by=bound_by,
            library_ms=library_ms)
        print(f"kernel flash_attn_fwd {dtype} {list(shape)} {layout}: "
              f"max_abs_err {err:.3e} (tol {atol:g} + {rtol:g}|ref|"
              f"{note}; worst diff/tol {worst:.3f}) "
              f"lse_err {lse_err:.3e} kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
              f"bound_us {bound * 1e3:.2f} ({bound_by}; "
              f"{derated * 1e3:.2f} at the power limit) [{card}]",
              flush=True)
        check(worst <= 1 and lse_err <= 1e-3,
              f"flash_attn_fwd {dtype} {list(shape)} {layout} disagrees "
              f"with its plain version: max_abs_err {err:.3e}, "
              f"lse_err {lse_err:.3e}")
    return rows


def phase_forward(params, cfg, card: str):
    from dataclasses import replace

    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import forward

    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    flash_attn.launches = 0
    logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = flash_attn.launches
    plain = forward(params, tokens, cfg, positions=torch.arange(1024))
    check(flash_attn.launches == launches,
          "the plain-attention forward launched the kernel")
    check(tuple(logits.shape) == (1, 1024, cfg.vocab_size),
          f"forward logits have shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    exact = forward(params, tokens, replace(cfg, dtype=torch.float32),
                    positions=torch.arange(1024))

    def rel_l2(x, y):
        return ((x.float() - y).norm() / y.norm()).item()

    a, b = logits.float(), plain.float()
    rel = rel_l2(a, b)
    err_flash, err_plain = rel_l2(a, exact), rel_l2(b, exact)
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    ms = cuda_ms(lambda: forward(params, tokens, cfg), 5, warmup=1)
    plain_ms = cuda_ms(lambda: forward(params, tokens, cfg,
                                       positions=torch.arange(1024)),
                       5, warmup=1)
    print(f"forward flagship bf16 [1, 1024]: kernel launches {launches} "
          f"(layers {cfg.n_layers}); rel_l2 to a float32 forward: flash "
          f"{err_flash:.3e}, plain {err_plain:.3e} (flash <= "
          f"{FORWARD_ERR_RATIO:g} x plain); flash vs plain rel_l2 "
          f"{rel:.3e} max_abs {(a - b).abs().max().item():.3e} "
          f"top1_agreement {top1:.4f} forward_ms {ms:.3f} "
          f"plain_attention_forward_ms {plain_ms:.3f} [{card}]", flush=True)
    check(launches == cfg.n_layers,
          f"forward launched the kernel {launches} times, expected "
          f"{cfg.n_layers}")
    check(err_flash <= FORWARD_ERR_RATIO * err_plain,
          f"the flash forward is further from float32 ({err_flash:.3e}) "
          f"than the plain one ({err_plain:.3e}) allows")


def phase_engine(params, cfg, card: str):
    import numpy as np
    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import forward
    from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                            TransformerEngineModel)

    class Recording(TransformerEngineModel):
        """Keeps each prompt's first prefill logits and counts the
        prefills that start from no cached prefix."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first_logits = {}
            self.full_prefills = 0

        def prefill(self, tokens, prefix_kv=None):
            logits, kv = super().prefill(tokens, prefix_kv)
            self.full_prefills += prefix_kv is None
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

        def prefill_paged(self, tokens, *a, **k):
            logits, kv = super().prefill_paged(tokens, *a, **k)
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

    def serve(engine):
        engine.start()
        try:
            t0 = time.perf_counter()
            streams = [engine.submit(p, max_new) for p in prompts]
            outs = [list(s) for s in streams]   # raises a request's error
            wall = time.perf_counter() - t0
        finally:
            engine.stop()
        return streams, outs, wall

    model = Recording(params, cfg)
    config = EngineConfig(paged_decode=True, block_size=16, num_blocks=256,
                          max_batch_size=8)
    rng = np.random.default_rng(5)
    shared = rng.integers(2, cfg.vocab_size, 256).tolist()
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in (128, 200, 384, 520)]
    prompts += [shared + rng.integers(2, cfg.vocab_size, n - 256).tolist()
                for n in (320, 448, 576, 640)]
    max_new = 32
    # Warm-up pass on an engine of its own: cuBLAS picks its GEMMs and the
    # allocator grows on first use, which a single cold pass would time.
    serve(InferenceEngine(model, config))
    model.first_logits.clear()
    model.full_prefills = 0
    engine = InferenceEngine(model, config)
    flash_attn.launches = 0
    streams, outs, wall = serve(engine)
    launches = flash_attn.launches
    st = engine.stats()
    n_tokens = sum(len(o) for o in outs)
    check(all(s.finished for s in streams), "a request did not finish")
    check(launches > 0 and launches == cfg.n_layers * model.full_prefills,
          f"prefill launched the kernel {launches} times for "
          f"{model.full_prefills} no-prefix prefills of {cfg.n_layers} "
          f"layers")
    check(st["prefix_hit_tokens"] > 0, "no prefix was shared")

    agree = total = first_ok = 0
    worst = 0.0
    for prompt, gen in zip(prompts, outs):
        seq = prompt + gen[:-1]
        ref = forward(params, [seq], cfg, positions=torch.arange(len(seq)))
        ref = ref[0].float().cpu().numpy()
        n = len(prompt)
        got = model.first_logits[tuple(prompt)]
        worst = max(worst, float(np.abs(got - ref[n - 1]).max()))
        tie = ref[n - 1].max() - ref[n - 1][gen[0]] <= ENGINE_LOGIT_ATOL
        first_ok += gen[0] == int(ref[n - 1].argmax()) or tie
        picks = ref[n - 1:n - 1 + len(gen)].argmax(-1)
        agree += int((picks == np.asarray(gen)).sum())
        total += len(gen)
    share = agree / total
    print(f"engine flagship f32 paged: {len(prompts)} requests, "
          f"{n_tokens} tokens in {wall:.3f} s, tokens_per_s "
          f"{n_tokens / wall:.2f}, ttft_p50_ms {st['ttft_p50_ms']}, "
          f"prefills {st['prefills']} (no-prefix {model.full_prefills}), "
          f"prefix_hit_tokens {st['prefix_hit_tokens']}, kernel launches "
          f"{launches}, preemptions {st['preemptions']}, "
          f"prefill_s {st['prefill_s']} decode_s {st['decode_s']} "
          f"(kv_gather_s {st['kv_gather_s']} model_step_s "
          f"{st['model_step_s']}, {st['steps']} steps) [{card}]",
          flush=True)
    print(f"engine vs no-cache forward: prefill logits max_abs_err "
          f"{worst:.3e} (tol {ENGINE_LOGIT_ATOL:g}), first tokens "
          f"{first_ok}/{len(prompts)}, token agreement {agree}/{total} "
          f"= {share:.4f} [{card}]", flush=True)
    check(worst <= ENGINE_LOGIT_ATOL,
          f"engine prefill logits differ from forward by {worst:.3e}")
    check(first_ok == len(prompts), "a first token differs from forward")
    check(share >= MIN_TOKEN_AGREEMENT,
          f"greedy token agreement {share:.4f} < {MIN_TOKEN_AGREEMENT}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import ray_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(here):
        print("chip_smoke: ray_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 1
    from dataclasses import replace

    from ray_tpu_torch.kernels import build
    from ray_tpu_torch.models import TransformerConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        name = torch.cuda.get_device_name(0)
        card = smi()
        print(f"device {name} count {torch.cuda.device_count()}",
              flush=True)
        print(card, flush=True)
        try:
            power_w = float(card.split(",")[1].strip().split()[0])
        except (IndexError, ValueError):
            power_w = 0.0

        t0 = time.perf_counter()
        build.build()
        print(f"build {sorted(build.KERNELS)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for kname, info in build.build_log.items():
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {kname}: {line.strip()}")

        rows = phase_kernels(card, power_w)

        cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen)
        phase_forward(params, cfg, card)
        launches = phase_engine(params, replace(cfg, dtype=torch.float32),
                                card)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    main_row = rows[MAIN_SHAPE]
    print(json.dumps({"kernels": [dict(
        name="flash_attn_fwd", route="cuda",
        source="ray_tpu_torch/kernels/csrc/flash_attn_fwd.cu",
        replaces="ray_tpu/ops/attention.py:28", launches=launches,
        shape=list(MAIN_SHAPE[0]), dtype=MAIN_SHAPE[1],
        layout=MAIN_SHAPE[2], **main_row)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
