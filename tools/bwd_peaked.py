#!/usr/bin/env python3
"""How close the bf16 attention backward kernels (K2: dK, dV; K3: dQ) come
to their plain versions when the softmax is peaked, on one CUDA card.

    python3 tools/bwd_peaked.py [--seeds 1 2 3] [--scale 4]
                                [--dims 128 64 256]
                                              # from the repository root

For each head dim and seed: q, k, v as views of one [4, 1024, 3, 12, 128]
(and [4, 1024, 3, 12, 64], [4, 1024, 3, 6, 256]) bf16 tensor with q and k
scaled by `--scale`, as `chip_smoke.py`'s peaked rows make them. It
prints the worst diff/tol of dQ, dK and dV under `chip_smoke.py`'s gate
(BWD_TOL plus the flip bound; above 1 fails), and each side's relative
L2 distance to a float64 evaluation that rounds p and ds to bf16 at the
same points. At the worst dQ element it prints the kernel's, the plain
version's and the float64 value, and that row's largest p and dp - di:
in a row whose p is near 1 at one key, dp - di cancels, so ds and dQ
there are float32 noise on both sides. Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.kernels import flash_attn  # noqa: E402


def float64_grads(q, k, v, do, lse, di):
    """(dQ, dK, dV) in float64 with p and ds rounded to q's dtype where
    the kernels round them."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(scores - lse.double()[..., None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    ds = p * (dp - di.double()[..., None]) * scale
    p, ds = p.to(q.dtype).double(), ds.to(q.dtype).double()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.double()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.double()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.double()))


def rel_l2(x, ref):
    return ((x.double() - ref).norm() / ref.norm()).item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[112, 1, 2, 3, 4, 7])
    parser.add_argument("--scale", type=float, default=4.0)
    parser.add_argument("--dims", type=int, nargs="+", default=[128, 64, 256],
                        choices=[64, 128, 256])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bwd_peaked: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    for d in args.dims:
        shape = (4, 1024, 6 if d == 256 else 12, d)
        for seed in args.seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            qkv = torch.randn((*shape[:2], 3, *shape[2:]), generator=gen,
                              device="cuda")
            qkv[:, :, :2] *= args.scale
            q, k, v = qkv.to(torch.bfloat16).unbind(2)
            do = torch.randn(shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
            o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
            di = flash_attn.attention_di(o, do)
            dk, dv = flash_attn.flash_attn_bwd_dkv(q, k, v, do, lse, di)
            dq = flash_attn.flash_attn_bwd_dq(q, k, v, do, lse, di)
            torch.cuda.synchronize()
            errs = cs.bwd_errors(q, k, v, do, lse, di, dq, dk, dv)
            ref_dk, ref_dv = flash_attn.flash_attn_bwd_dkv_plain(
                q, k, v, do, lse, di)
            ref_dq = flash_attn.flash_attn_bwd_dq_plain(q, k, v, do, lse,
                                                        di)
            exact = float64_grads(q, k, v, do, lse, di)
            dists = "; ".join(
                f"{n} kernel {rel_l2(g, e):.4e} plain {rel_l2(r, e):.4e}"
                for n, g, r, e in (("dq", dq, ref_dq, exact[0]),
                                   ("dk", dk, ref_dk, exact[1]),
                                   ("dv", dv, ref_dv, exact[2])))
            print(f"{list(shape)} q,k x{args.scale:g} seed {seed}: worst "
                  f"diff/tol " + ", ".join(f"{n} {e[1]:.3f}"
                                           for n, e in errs.items())
                  + f"; rel_l2 to float64: {dists}", flush=True)
            flip = cs.bwd_flip_bound(q, k, v, do, lse, di)[0]
            atol, rtol = cs.BWD_TOL["bfloat16"]
            tol = (atol + rtol * ref_dq.float().abs()
                   + cs.BWD_FLIPS_PER_ROW * flip)
            ratio = (dq.float() - ref_dq.float()).abs() / tol
            b, s, h, c = (int(i) for i in torch.unravel_index(
                ratio.flatten().argmax(), ratio.shape))
            scores = (q[b, s, h].float() @ k[b, :s + 1, h].float().T
                      ) * d ** -0.5
            top = torch.exp(scores - lse[b, h, s]).topk(min(2, s + 1))
            gap = [(do[b, s, h].float() @ v[b, j, h].float()
                    - di[b, h, s]).item() for j in top.indices.tolist()]
            print(f"   worst dQ element [{b}, {s}, {h}, {c}]: kernel "
                  f"{dq[b, s, h, c].item():.4e}, plain "
                  f"{ref_dq[b, s, h, c].item():.4e}, float64 "
                  f"{exact[0][b, s, h, c].item():.4e}, tol "
                  f"{tol[b, s, h, c].item():.3e}; its row's largest p "
                  f"{[round(x, 6) for x in top.values.tolist()]}, dp - di "
                  f"there {[f'{x:.3e}' for x in gap]}", flush=True)
            del q, k, v, do, o, lse, di, dk, dv, dq, ref_dk, ref_dv
            del ref_dq, exact, qkv, flip, tol, ratio
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
