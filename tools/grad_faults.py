#!/usr/bin/env python3
"""How well `chip_smoke.py`'s gradient gate tells a wrong attention
backward from bf16 noise, on one CUDA card.

    python3 tools/grad_faults.py        # from the repository root

Runs the gradient phase's measurement (flagship width, bf16, remat
"save_attn_qkv", 2 x 1024 tokens; each leaf's relative L2 distance to a
float32 plain-attention reference, through the kernels and through plain
attention) once as built and once with each fault planted in the flash
backward for this process only: dV, dK or dQ scaled by a constant factor,
or di = sum(o * dO) rounded to bf16 before K2 and K3 read it. Prints, for
each, the worst per-leaf kernel/plain ratio (whole leaves, and with wqkv
split into its q, k and v parts), the ratios of the worst leaves' and of
the mean distances, and whether the gate (every leaf within
GRAD_ERR_RATIO of plain) would pass. Then the kernel phase's check of K2
and K3 against their plain versions at the train step's shape, with each
scaling fault applied to the kernels' outputs. Nothing is written to
disk.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import importlib  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.kernels import flash_attn  # noqa: E402
from ray_tpu_torch.models import TransformerConfig, init_params  # noqa: E402

attention = importlib.import_module("ray_tpu_torch.ops.attention")

REAL = attention.flash_attn_bwd


def scaled(index: int, factor: float):
    def bwd(*args):
        grads = list(REAL(*args))
        grads[index] = grads[index] * factor
        return tuple(grads)
    return bwd


def di_bf16(q, k, v, o, do, lse):
    di = flash_attn.attention_di(o, do).to(q.dtype).float()
    dk, dv = flash_attn.flash_attn_bwd_dkv(q, k, v, do, lse, di)
    return flash_attn.flash_attn_bwd_dq(q, k, v, do, lse, di), dk, dv


FAULTS = [("none", REAL), ("dV x 1.02", scaled(2, 1.02)),
          ("dV x 1.005", scaled(2, 1.005)), ("dK x 1.02", scaled(1, 1.02)),
          ("dQ x 1.02", scaled(0, 1.02)), ("di in bf16", di_bf16)]


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    print(card, flush=True)
    cfg = TransformerConfig(dtype=torch.bfloat16, remat=True,
                            remat_policy="save_attn_qkv", **cs.FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    try:
        for label, bwd in FAULTS:
            attention.flash_attn_bwd = bwd
            r = cs.grad_errors(params, cfg)
            names = r["names"]
            worst, ratio, mean_k, mean_p, ok = cs.grad_summary(
                r["err_k"], r["err_p"], names)
            pworst, pratio, _, _, pok = cs.grad_summary(
                r["part_k"], r["part_p"], r["part_names"])
            print(f"fault {label}: worst per-leaf ratio {ratio:.4f} "
                  f"({names[worst]}), max ratio "
                  f"{max(r['err_k']) / max(r['err_p']):.4f}, mean ratio "
                  f"{mean_k / mean_p:.4f} (kernels mean {mean_k:.4e}, "
                  f"plain mean {mean_p:.4e}); gate "
                  f"{'passes' if ok else 'fails'}; wqkv split into q, k, "
                  f"v: worst ratio {pratio:.4f} "
                  f"({r['part_names'][pworst]}), per-part gate "
                  f"{'passes' if pok else 'fails'} [{card}]", flush=True)
    finally:
        attention.flash_attn_bwd = REAL
    kernel_phase(card)
    return 0


def kernel_phase(card: str) -> None:
    """The kernel phase's check (K2, K3 against their plain versions) at
    the train step's shape, with each scaling fault applied to the
    kernels' outputs: its worst diff/tol, which must stay <= 1."""
    shape, dtype, _ = cs.MAIN_BWD_SHAPE
    b, s, h, d = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(100)
    q, k, v = torch.randn((b, s, 3, h, d), generator=gen,
                          device="cuda").to(dt).unbind(2)
    do = torch.randn(shape, generator=gen, device="cuda").to(dt)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
    di = flash_attn.attention_di(o, do)
    for label, bwd in FAULTS:
        if label == "di in bf16":
            continue  # both sides of that check are given the same di
        dq, dk, dv = bwd(q, k, v, o, do, lse)
        errs = cs.bwd_errors(q, k, v, do, lse, di, dq, dk, dv)
        print(f"kernel phase {dtype} {list(shape)} qkv, fault {label}: "
              + ", ".join(f"{n} worst diff/tol {errs[n][1]:.3f}"
                          for n in ("dq", "dk", "dv"))
              + f" (fails above 1) [{card}]", flush=True)
        del dq, dk, dv, errs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
