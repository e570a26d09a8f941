#!/usr/bin/env python3
"""How well `chip_smoke.py`'s gradient gate tells a wrong attention
backward from bf16 noise, on one CUDA card.

    python3 tools/grad_faults.py [--peak F ...] [--depth L ...] [--seed S ...]

Runs the gradient phase's measurement (flagship width, bf16, remat
"save_attn_qkv", 2 x 1024 tokens; each leaf's relative L2 distance to a
float32 plain-attention reference, through the kernels and through plain
attention) once as built and once with each fault planted in the flash
backward for this process only: dV, dK or dQ scaled by a constant factor,
or di = sum(o * dO) rounded to bf16 before K2 and K3 read it. Prints, for
each, the worst per-leaf kernel/plain ratio (whole leaves, and with wqkv
split into its q, k and v parts), the ratios of the worst leaves' and of
the mean distances, and whether the gate (every leaf within
GRAD_ERR_RATIO of plain) would pass. With `--peak`, the measurement runs
on weights whose q and k parts are scaled by each factor
(`peaked`: the logits grow by its square), once per factor;
1 is the random init as made. With `--depth`, on the first L layers
(the flagship's depth, 12, by default), and with `--seed`, from each
init seed. Then the kernel phase's check of K2
and K3 against their plain versions at the train step's shape, with each
scaling fault applied to the kernels' outputs. Nothing is written to
disk.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
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


def peaked(params, factor: float):
    """`params` with each layer's q and k parts of wqkv scaled by
    `factor` (new tensors; the rest shared): the logits grow by factor
    squared, so attention leaves the near-uniform softmax of a random
    init."""
    layers = []
    for lp in params["layers"]:
        w = lp["wqkv"].clone()
        w[:, :2] *= factor
        layers.append(dict(lp, wqkv=w))
    return dict(params, layers=layers)


def di_bf16(q, k, v, o, do, lse):
    di = flash_attn.attention_di(o, do).to(q.dtype).float()
    dk, dv = flash_attn.flash_attn_bwd_dkv(q, k, v, do, lse, di)
    return flash_attn.flash_attn_bwd_dq(q, k, v, do, lse, di), dk, dv


FAULTS = [("none", REAL), ("dV x 1.02", scaled(2, 1.02)),
          ("dV x 1.005", scaled(2, 1.005)), ("dK x 1.02", scaled(1, 1.02)),
          ("dQ x 1.02", scaled(0, 1.02)), ("di in bf16", di_bf16)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--peak", type=float, nargs="+", default=[1.0],
                        help="factors for the q and k parts of wqkv")
    parser.add_argument("--depth", type=int, nargs="+",
                        default=[cs.FLAGSHIP["n_layers"]],
                        help="layers of the model (its first L)")
    parser.add_argument("--seed", type=int, nargs="+", default=[0],
                        help="init seeds")
    parser.add_argument("--faults", nargs="+", default=None,
                        help="labels of the faults to plant (default all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("grad_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    print(card, flush=True)
    full = TransformerConfig(dtype=torch.bfloat16, remat=True,
                             remat_policy="save_attn_qkv", **cs.FLAGSHIP)
    faults = [f for f in FAULTS if args.faults is None
              or f[0] in args.faults]
    try:
        for seed, depth, peak in [(s, d, p) for s in args.seed
                                  for d in args.depth for p in args.peak]:
            cfg = dataclasses.replace(full, n_layers=depth)
            base = init_params(full,
                               torch.Generator(device="cuda").manual_seed(
                                   seed))
            base = dict(base, layers=base["layers"][:depth])
            params = base if peak == 1.0 else peaked(base, peak)
            for label, bwd in faults:
                attention.flash_attn_bwd = bwd
                r = cs.grad_errors(params, cfg)
                report(f"{label} (seed {seed}, depth {depth}, q, k x "
                       f"{peak:g})", r, card)
            del base, params
            torch.cuda.empty_cache()
    finally:
        attention.flash_attn_bwd = REAL
    kernel_phase(card)
    return 0


def report(label: str, r: dict, card: str) -> None:
    """One measurement: what the gradient gate reads."""
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
          f"{'passes' if pok else 'fails'}; worst q part "
          f"{part_ratio(r, '.q'):.4f}, k part "
          f"{part_ratio(r, '.k'):.4f}, v part "
          f"{part_ratio(r, '.v'):.4f}; plain path's mean rel L2 to "
          f"float32 on q parts {part_mean(r, '.q'):.4e}, k parts "
          f"{part_mean(r, '.k'):.4e} [{card}]", flush=True)


def part_ratio(r, suffix: str) -> float:
    """The worst kernel/plain ratio over the wqkv parts named `suffix`."""
    return max(k / p for n, k, p in zip(r["part_names"], r["part_k"],
                                        r["part_p"]) if n.endswith(suffix))


def part_mean(r, suffix: str) -> float:
    """The plain path's mean relative L2 to float32 over the wqkv parts
    named `suffix`: the bf16 noise a fault must stand out of."""
    vals = [p for n, p in zip(r["part_names"], r["part_p"])
            if n.endswith(suffix)]
    return sum(vals) / len(vals)


def kernel_phase(card: str) -> None:
    """The kernel phase's check (K2, K3 against their plain versions) at
    the train step's shape, with each scaling fault applied to the
    kernels' outputs: its worst diff/tol, which must stay <= 1."""
    shape, dtype, _, _ = cs.MAIN_BWD_SHAPE
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
