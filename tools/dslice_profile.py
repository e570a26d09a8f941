#!/usr/bin/env python3
"""Where the D-slice K1 kernels' time goes, on one CUDA card: an
instrumented copy of the tree's `flash_attn_fwd.cu` in which thread 0 of
every block adds up the clock64 cycles it spends in each mbarrier wait
and in a few spans of the bf16 kernel (its S products, the hand-off of
the partial sums, the softmax, the staging of p), and writes them with
its rank, its key-tile count and its span (globaltimer) to a device
buffer. For each of chip_smoke's D-384 and D-512 K1 rows it prints the
instrumented and plain kernels' times, every rank's cycles an iteration
of its loop (nk + n iterations) and the largest shares of its time.

    python3 tools/dslice_profile.py          # from the repository root

The copy's outputs are checked bitwise against the tree's. The counters
cost a few percent (both times are printed).
"""

from __future__ import annotations

import ctypes
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SRC = os.path.join(ROOT, "ray_tpu_torch", "kernels", "csrc",
                   "flash_attn_fwd.cu")
NF = 48          # counters a block
FIRST_SPAN = 36  # counters FIRST_SPAN.. hold the spans
# Spans of the bf16 kernel: (name, regex of its first lines, regex of its
# last line); whitespace is matched loosely.
SPANS = [
    ("S products", r"wgmma_fence\(\);\s*gemm_abt<C>\(s_,", r"reg_fence\(s_\);"),
    ("partial sums out", r"#pragma unroll\s*for \(int a = 0; a < 8; \+\+a\)"
     r"\s*st_async16\(dst", r"s_\[4 \* a \+ 3\]\)\);"),
    ("softmax", r"tile_softmax\(s_, 64 \* ts == qw0", r"pa\);"),
    ("p staged, copies issued", r"#pragma unroll\s*for \(int a = 0; a < 4; "
     r"\+\+a\)\s*reinterpret_cast<uint4\*>\(mine\)", r"dstr\)\);"),
    ("partial sums in", r"const float4\* src = reinterpret_cast<const float4\*>"
     r"\(\s*sm \+ lay\.part \+ \(2", r"rk\.r - 1\)\);"),
    ("p in", r"const uint8_t\* src = sm \+ lay\.p \+ \(2 \* slot \+ wg\)",
     r"p_empty \+ 2 \* slot \+ wg, rk\.last\)\);"),
    ("P V", r"scale_rows<C>\(acc, alpha\);\s*wgmma_fence\(\);\s*gemm_ax_wide",
     r"reg_fence\(acc\[a\]\);"),
    ("K refill", r"if \(tid == 0\) \{   // this tile's last two K stages",
     r"issue_k\(w \+ 2\);\s*\}\s*\}\s*\}"),
    ("V refill", r"if \(tid == 0 && tp \+ 2 < nk\) \{",
     r"issue_v\(tp \+ 2\);\s*\}"),
]


def instrument(src: str):
    """The source with the counters, and the wait sites' texts."""
    i = src.index("// Head dims above 256 (any multiple")
    j = src.index("SmemLimit& tc_dslice_limit()")
    body, sites = src[i:j], []

    def wrap(m):
        sites.append(" ".join(m.group(1).split()))
        k = len(sites) - 1
        return (f"{{ const long long t_ = clock64(); {m.group(1)}; "
                f"prof_[{6 + k}] += clock64() - t_; }}")

    body = re.sub(r"(mbar_wait(?:_cluster)?\([^;]*\));", wrap, body)
    assert 6 + len(sites) <= FIRST_SPAN, "too many wait sites"
    for k, (_, a, b) in enumerate(SPANS):
        found = list(re.finditer(a, body))
        if len(found) != 1:
            continue
        ia = found[0].start()
        ib = re.compile(b).search(body, ia).end()
        body = (body[:ia] + f"const long long s{k}_ = clock64();\n"
                + body[ia:ib] + f"\nprof_[{FIRST_SPAN + k}] += "
                f"clock64() - s{k}_;\n" + body[ib:])
    body = body.replace(
        "  const L lay(geo.m);\n",
        "  const L lay(geo.m);\n"
        f"  long long prof_[{NF}] = {{0}};\n"
        "  const long long t0_ = clock64();\n"
        "  long long g0_;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0_));\n")
    body = body.replace(
        "  cluster_sync();   // no block leaves",
        "  if (threadIdx.x == 0) {\n"
        "    long long g1_;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1_));\n"
        "    const long long blk_ = blockIdx.x + (long long)gridDim.x *\n"
        "        (blockIdx.y + (long long)gridDim.y * blockIdx.z);\n"
        "    prof_[0] = rk.r; prof_[1] = nk; prof_[2] = clock64() - t0_;\n"
        "    prof_[3] = g0_; prof_[4] = g1_; prof_[5] = geo.n;\n"
        f"    for (int i_ = 0; i_ < {NF}; ++i_) g_prof[blk_ * {NF} + i_] ="
        " prof_[i_];\n"
        "  }\n"
        "  cluster_sync();   // no block leaves")
    out = (src[:i] + f"__device__ long long g_prof[16384 * {NF}];\n" + body
           + src[j:] + "\nextern \"C\" int prof_fetch(long long* host, int "
           f"n) {{\n  return (int)cudaMemcpyFromSymbol(host, g_prof, n * "
           f"{NF} * 8);\n}}\n")
    return out, sites


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import fwd_ab
    from ray_tpu_torch.kernels import build, flash_attn

    if not torch.cuda.is_available():
        print("dslice_profile: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    text, sites = instrument(open(SRC).read())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "dslice_profile.cu"
    path.write_text(text)
    prof = fwd_ab.load_base(str(path))
    prof.prof_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for shape, dtype, layout, qk in cs.WIDE_SHAPES:
        b, s, h, d = shape
        if d > 512 or qk != 1.0:
            continue
        q, k, v = cs.kernel_inputs(shape, dtype, layout, qk, 3)
        o = torch.empty((b, s, h, d), dtype=q.dtype, device="cuda")
        lse = torch.empty((b, h, s), device="cuda")
        ref, ref_lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        fwd_ab.launch(prof, q, k, v, o, lse)
        torch.cuda.synchronize()
        same = torch.equal(o, ref) and torch.equal(lse, ref_lse)
        ms = cs.cuda_ms(lambda: flash_attn.flash_attn_fwd(q, k, v), 20)
        ms_prof = cs.cuda_ms(lambda: fwd_ab.launch(prof, q, k, v, o, lse),
                             20)
        fwd_ab.launch(prof, q, k, v, o, lse)
        torch.cuda.synchronize()
        rows = 128 if dtype == "bfloat16" else 64
        nblk = b * h * (s // rows) * (d // 128)
        buf = (ctypes.c_longlong * (nblk * NF))()
        if prof.prof_fetch(buf, nblk) != 0:
            raise RuntimeError("prof_fetch failed")
        a = np.frombuffer(buf, dtype=np.int64).reshape(nblk, NF)
        n = int(a[0, 5])
        span = (a[:, 4].max() - a[:, 3].min()) / 1e3
        print(f"{dtype} {list(shape)} {layout}: kernel_ms {ms:.4f} "
              f"instrumented {ms_prof:.4f} (bitwise the kernel's: {same}); "
              f"span {span:.1f} us, {nblk} blocks in clusters of {n}",
              flush=True)
        names = {6 + k: f"wait {t}" for k, t in enumerate(sites)}
        names.update({FIRST_SPAN + k: nm for k, (nm, _, _) in
                      enumerate(SPANS)})
        for r in range(n):
            sel = a[a[:, 0] == r]
            tot = sel[:, 2].mean()
            it = (sel[:, 2] / (sel[:, 1] + n)).mean()
            shares = sorted(((sel[:, c].mean() / tot, nm)
                             for c, nm in names.items()), reverse=True)
            print(f"  rank {r}: {it:.0f} cycles an iteration; "
                  + "; ".join(f"{nm} {sh * 100:.1f}%"
                              for sh, nm in shares[:9] if sh > 0.004)
                  + f"; unaccounted {(1 - sum(sh for sh, _ in shares)) * 100:.1f}%",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
