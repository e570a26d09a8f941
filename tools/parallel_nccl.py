#!/usr/bin/env python3
"""The parallel layer across cards: each mesh path of `ray_tpu_torch` on N
ranks, one card a rank over NCCL, held against the same computation
unsharded on each rank's own card.

    python3 tools/parallel_nccl.py [--ranks 4] [--device cuda|cpu]

`--device cpu` runs the same cases on N gloo processes on the CPU (the
rehearsal of a call on the cards). Every case is float32 with TF32 off,
weights and tokens from fixed seeds, and compares its result with the
unsharded model's (plain attention, explicit positions) on the rank:

- ring: `ring_attention` on a (1, 1, N, 1) mesh, [2, 1024, 12, 128],
  forward and the gradients of the output's sum, against plain
  attention; tolerances those of the JAX package's ring test (2e-5,
  2e-4, relative to the reference's largest element);
- sharded: `lm_loss(mesh=)` on (2, 1, 1, N/2) (FSDP over dp, Megatron
  over tp) and (1, 1, 2, N/2) (the ring over sp, tp), dense, and on
  (2, 1, 1, N/2) with 4 experts over dp: the loss and every gradient leaf
  within 1e-5 rel L2;
- pipelined: `lm_loss_pipelined` on (1, 2, 1, N/2) with 2 microbatches
  and (1, N, 1, 1) with N microbatches against the unpipelined loss: the
  loss and every gradient leaf within 1e-5 rel L2;
- train: one AdamW step (`make_train_step`) on (2, 1, 1, N/2): its
  gradients against the unsharded step's within 1e-5 rel L2 per leaf,
  and its update against plain AdamW on the unsharded params fed the
  same (gathered) gradients within 1e-6 rel L2 per leaf (the same
  elementwise arithmetic; comparing with the unsharded step's update
  instead would read float32 noise: Adam divides each gradient by its
  own size, so an element whose gradient is within noise of zero takes
  its sign from the noise and moves by up to the learning rate).

One line a case, the worst error beside its tolerance, and the card's name
and power limit; exits non-zero if a case misses its tolerance or a rank
fails or does not finish within the deadline (every rank is killed then).
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import queue
import socket
import subprocess
import sys
import time
import traceback

# The checkout's package, whichever directory the script runs from.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DEADLINE_S = 600
PG_TIMEOUT_S = 180
WIDTHS = dict(vocab_size=1024, d_model=256, n_layers=4, n_heads=4,
              d_ff=512, max_seq_len=256)
BATCH, SEQ = 4, 256
GRAD_REL_L2 = 1e-5
UPDATE_REL_L2 = 1e-6
RING_SHAPE = (2, 1024, 12, 128)
RING_TOL, RING_GRAD_TOL = 2e-5, 2e-4


def _leaves(params):
    """[(name, tensor)] of a params tree, per-layer list or stacked layer
    leaves ([n_stages, L/n, ...] -> one tensor a layer), DTensors whole."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    out = [("embed", whole(params["embed"])),
           ("ln_f", whole(params["ln_f"]))]
    layers = params["layers"]
    if isinstance(layers, dict):
        for key, t in layers.items():
            t = whole(t).flatten(0, 1)
            out += [(f"layers.{i}.{key}", t[i]) for i in range(t.shape[0])]
    else:
        out += [(f"layers.{i}.{key}", whole(t))
                for i, lp in enumerate(layers) for key, t in lp.items()]
    return sorted(out, key=lambda kv: kv[0])


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _plain_loss(params, tokens, cfg):
    """The unsharded loss through plain attention (explicit positions)."""
    import torch

    from ray_tpu_torch.models.transformer import _token_nll, backbone

    positions = torch.arange(tokens.shape[1] - 1, device=tokens.device)
    x, aux = backbone(params, tokens[:, :-1], cfg, positions)
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype))
    return _token_nll(logits, tokens[:, 1:]) + cfg.aux_loss_weight * aux


def _grads(params, loss_fn):
    """(loss, [(name, grad)]) of loss_fn(params), by `backward()` (every
    rank runs every collective)."""
    from ray_tpu_torch.parallel.spmd import _leaves as raw_leaves

    for t in raw_leaves(params):
        t.requires_grad_(True)
        t.grad = None
    loss = loss_fn(params)
    loss.backward()
    grads = {"embed": params["embed"].grad, "ln_f": params["ln_f"].grad}
    layers = params["layers"]
    grads["layers"] = ({k: t.grad for k, t in layers.items()}
                       if isinstance(layers, dict)
                       else [{k: t.grad for k, t in lp.items()}
                             for lp in layers])
    value = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    return value.item(), _leaves(grads)


def _init(cfg, dev):
    import torch

    from ray_tpu_torch.models import init_params

    return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)


def _tokens(cfg, dev):
    import torch

    return torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)


def case_ring(n, dev):
    import torch

    from ray_tpu_torch.ops import plain_attention, ring_attention
    from ray_tpu_torch.parallel import P, make_mesh, shard_pytree

    mesh = make_mesh((1, 1, n, 1), device=dev.type)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = plain_attention(*ref)
    want.sum().backward()
    spec = {"x": P("dp", "sp", "tp", None)}
    sharded = [shard_pytree({"x": t}, spec, mesh)["x"].requires_grad_(True)
               for t in (q, k, v)]
    got = ring_attention(*sharded, mesh=mesh)
    got.sum().backward()
    fwd = ((got.full_tensor() - want).abs().max()
           / want.abs().max()).item()
    grad = max(((s.grad.full_tensor() - r.grad).abs().max()
                / r.grad.abs().max()).item()
               for s, r in zip(sharded, ref))
    return [(f"ring (1,1,{n},1) {list(RING_SHAPE)} forward", fwd, RING_TOL),
            (f"ring (1,1,{n},1) gradients", grad, RING_GRAD_TOL)]


def case_sharded(n, dev):
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import TransformerConfig, lm_loss, param_specs
    from ray_tpu_torch.parallel import make_mesh, shard_pytree

    out = []
    base = TransformerConfig(dtype=torch.float32, **WIDTHS)
    for shape, cfg in (((2, 1, 1, n // 2), base),
                       ((1, 1, 2, n // 2), base),
                       ((2, 1, 1, n // 2), replace(base, num_experts=4))):
        mesh = make_mesh(shape, device=dev.type)
        tokens = _tokens(cfg, dev)
        want, want_g = _grads(_init(cfg, dev),
                              lambda p: _plain_loss(p, tokens, cfg))
        params = shard_pytree(_init(cfg, dev), param_specs(cfg), mesh)
        got, got_g = _grads(params, lambda p: lm_loss(
            p, {"tokens": tokens}, cfg, mesh=mesh))
        kind = "moe" if cfg.is_moe else "dense"
        out.append((f"sharded {kind} {shape} loss {got:.6f} vs "
                    f"{want:.6f}", abs(got - want) / abs(want), GRAD_REL_L2))
        worst = max(((_rel(g, w), name) for (name, g), (_, w)
                     in zip(got_g, want_g)))
        out.append((f"sharded {kind} {shape} gradients (worst "
                    f"{worst[1]})", worst[0], GRAD_REL_L2))
    return out


def case_pipelined(n, dev):
    import torch

    from ray_tpu_torch.models import (TransformerConfig, lm_loss_pipelined,
                                      pipelined_param_specs, to_pipelined)
    from ray_tpu_torch.parallel import make_mesh, shard_pytree

    cfg = TransformerConfig(dtype=torch.float32, **WIDTHS)
    tokens = _tokens(cfg, dev)
    want, want_g = _grads(_init(cfg, dev),
                          lambda p: _plain_loss(p, tokens, cfg))
    out = []
    for shape, micro in (((1, 2, 1, n // 2), 2), ((1, n, 1, 1), n)):
        mesh = make_mesh(shape, device=dev.type)
        params = shard_pytree(to_pipelined(_init(cfg, dev), shape[1]),
                              pipelined_param_specs(cfg), mesh)
        got, got_g = _grads(params, lambda p: lm_loss_pipelined(
            p, {"tokens": tokens}, cfg, mesh, num_microbatches=micro))
        out.append((f"pipelined {shape} {micro} micro loss {got:.6f} vs "
                    f"{want:.6f}", abs(got - want) / abs(want), GRAD_REL_L2))
        worst = max(((_rel(g, w), name) for (name, g), (_, w)
                     in zip(got_g, want_g)))
        out.append((f"pipelined {shape} gradients (worst {worst[1]})",
                    worst[0], GRAD_REL_L2))
    return out


def case_train(n, dev):
    import torch

    from ray_tpu_torch.models import TransformerConfig, lm_loss, param_specs
    from ray_tpu_torch.parallel import (adamw, batch_sharding, make_mesh,
                                        make_train_step, shard_pytree)
    from torch.distributed.tensor import DTensor

    cfg = TransformerConfig(dtype=torch.float32, **WIDTHS)
    shape = (2, 1, 1, n // 2)
    mesh = make_mesh(shape, device=dev.type)
    tokens = _tokens(cfg, dev)
    want, want_g = _grads(_init(cfg, dev), lambda p: lm_loss(
        p, {"tokens": tokens}, cfg, device=dev))
    params = shard_pytree(_init(cfg, dev), param_specs(cfg), mesh)
    batch = {"tokens": DTensor.from_local(
        tokens.chunk(2)[mesh.get_local_rank("dp")], mesh,
        batch_sharding(mesh))}
    before = [t.detach().clone() for _, t in _leaves(params)]
    optimizer = adamw(1e-3)
    state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, mesh=mesh),
                           optimizer)
    params, state, _ = step(params, state, batch)
    # The step leaves its gradients in place until the next one.
    grads = {"embed": params["embed"].grad, "ln_f": params["ln_f"].grad,
             "layers": [{k: t.grad for k, t in lp.items()}
                        for lp in params["layers"]]}
    got_g = _leaves(grads)
    got = [t.detach() - b for (_, t), b in zip(_leaves(params), before)]
    grad_worst = max((_rel(g, w), name) for (name, g), (_, w)
                     in zip(got_g, want_g))

    # Plain AdamW on the unsharded params, fed the sharded step's
    # gradients.
    plain = _init(cfg, dev)
    names = [name for name, _ in _leaves(plain)]
    start = [t.detach().clone() for _, t in _leaves(plain)]
    plain_opt = adamw(1e-3)
    plain_state = plain_opt.init(plain)
    for (_, t), (_, g) in zip(_leaves(plain), got_g):
        t.grad = g.clone()
    plain_opt.update(plain_state)
    ref = [t.detach() - b for (_, t), b in zip(_leaves(plain), start)]
    update_worst = max((_rel(a, b), name)
                       for name, a, b in zip(names, got, ref))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
    return [(f"train {shape} one AdamW step, gradients (worst "
             f"{grad_worst[1]})", grad_worst[0], GRAD_REL_L2),
            (f"train {shape} AdamW on DTensor params vs plain AdamW on the "
             f"same gradients (worst {update_worst[1]}; bitwise equal "
             f"{bitwise})", update_worst[0], UPDATE_REL_L2)]


def _rank(rank, n, device, port, results):
    try:
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if device == "cuda":
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        lines = []
        try:
            for case in (case_ring, case_sharded, case_pipelined,
                         case_train):
                t0 = time.perf_counter()
                rows = case(n, dev)
                lines += [(what, err, tol, time.perf_counter() - t0)
                          for what, err, tol in rows]
                if device == "cuda":
                    torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, lines))
    except BaseException:  # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    n = args.ranks
    if n < 2 or n % 2:
        parser.error("--ranks must be even and at least 2")
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < n:
            print(f"parallel_nccl: {n} ranks need {n} cards, have "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
    card = _card() if args.device == "cuda" else "cpu (gloo)"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    procs = [ctx.Process(target=_rank, args=(r, n, args.device, port,
                                             results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    got, errors = {}, []
    end = time.monotonic() + DEADLINE_S
    try:
        while len(got) + len(errors) < n and time.monotonic() < end:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if ok:
                got[rank] = val
            else:
                errors.append((rank, val))
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join(5)
    if errors:
        rank, tb = errors[0]
        print(f"parallel_nccl: rank {rank} failed:\n{tb}", file=sys.stderr)
        return 1
    if len(got) < n:
        print(f"parallel_nccl: {n - len(got)} of {n} ranks gave no result "
              f"within {DEADLINE_S} s", file=sys.stderr)
        return 1
    failed = False
    for i, (what, err, tol, secs) in enumerate(got[0]):
        worst = max(got[r][i][1] for r in range(n))
        ok = worst <= tol
        failed |= not ok
        print(f"{'ok  ' if ok else 'FAIL'} {what}: {worst:.3e} (limit "
              f"{tol:g}; worst of {n} ranks; case {secs:.1f} s on rank 0) "
              f"[{card}]", flush=True)
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
