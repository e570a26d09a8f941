"""Rank bodies of the port's parallel tests: each runs on every gloo rank
of a `torch_dist.run_ranks` world and returns numpy results (the tests hold
them against the JAX package in the parent process). This module imports
no JAX, since each rank imports it.
"""

from __future__ import annotations

import importlib
import logging
import warnings

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.parallel import (P, adamw, auto_mesh, batch_sharding,
                                    init_sharded, make_hybrid_mesh,
                                    make_mesh, make_train_step, shard_pytree)

# `ray_tpu_torch.ops.attention` the module (the package exports the
# function of that name).
A = importlib.import_module("ray_tpu_torch.ops.attention")

# DTensor logs each multi-axis reduction it splits into steps.
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
warnings.filterwarnings("ignore", category=FutureWarning)


def config(**widths) -> T.TransformerConfig:
    return T.TransformerConfig(dtype=torch.float32, **widths)


def _np(t) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _paths(params):
    """{path: leaf} in the JAX package's names: "layers/wqkv/1" is layer
    1's leaf of a per-layer list, "layers/wqkv" a stacked leaf."""
    out = {"embed": params["embed"], "ln_f": params["ln_f"]}
    layers = params["layers"]
    if isinstance(layers, dict):
        out.update({f"layers/{k}": t for k, t in layers.items()})
    else:
        for i, lp in enumerate(layers):
            out.update({f"layers/{k}/{i}": t for k, t in lp.items()})
    return out


def shares(params) -> dict:
    """Each leaf's (global shape, this rank's local shape)."""
    return {path: (tuple(t.shape), tuple(t.to_local().shape))
            for path, t in _paths(params).items()}


def ring(q, k, v):
    """Ring attention on a (2, 1, 2, 2) mesh, q/k/v sharded
    P(dp, sp, tp, None): causal and full forward, causal gradients of the
    output's sum; then the ring body inside a manual region
    (`attention(manual_sp=True)`) on each rank's blocks, positions from
    the rank; the mesh's rank layout, `auto_mesh(dp=2, tp=4)`'s, and the
    hybrid mesh of CPU ranks."""
    mesh = make_mesh((2, 1, 2, 2), device="cpu")
    spec = {"q": P("dp", "sp", "tp", None)}
    qs, ks, vs = (shard_pytree({"q": torch.from_numpy(a)}, spec, mesh)["q"]
                  for a in (q, k, v))
    out = {"causal": _np(A.ring_attention(qs, ks, vs, mesh=mesh)),
           "full": _np(A.ring_attention(qs, ks, vs, mesh=mesh,
                                        causal=False))}
    for t in (qs, ks, vs):
        t.requires_grad_(True)
    A.ring_attention(qs, ks, vs, mesh=mesh).sum().backward()
    out["grads"] = [_np(t.grad) for t in (qs, ks, vs)]
    with torch.no_grad():
        ql, kl, vl = (t.to_local() for t in (qs, ks, vs))
        o = A.attention(ql, kl, vl, mesh=mesh, manual_sp=True)
        out["manual"] = _np(DTensor.from_local(o, mesh, qs.placements))
    out["layout"] = mesh.mesh.tolist()
    out["auto"] = auto_mesh(dp=2, tp=4, device="cpu").mesh.tolist()
    out["hybrid"] = hybrid()
    return out


def sharded_forward(np_params, np_moe, tokens, cfg_kw, moe_kw):
    """The sharded forward on a (2, 1, 2, 2) mesh, dense and MoE, and each
    rank's share of every leaf; then `init_sharded` against the unsharded
    init and one sharded AdamW step against the unsharded step."""
    mesh = make_mesh((2, 1, 2, 2), device="cpu")
    out = {}
    for name, tree, kw in (("dense", np_params, cfg_kw),
                           ("moe", np_moe, moe_kw)):
        cfg = config(**kw)
        params = shard_pytree(T.params_from_jax(tree, device="cpu"),
                              T.param_specs(cfg), mesh)
        logits, aux = T.forward(params, torch.from_numpy(tokens), cfg,
                                mesh=mesh)
        out[name] = (_np(logits), float(aux.full_tensor()))
        out[f"{name}_shares"] = shares(params)
        if name == "dense":
            x, _ = T.backbone(params, torch.from_numpy(tokens), cfg,
                              mesh=mesh)
            out["backbone"] = _np(x)

    cfg = config(**cfg_kw)

    def init():
        return T.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")

    sharded = init_sharded(init, T.param_specs(cfg), mesh)
    out["init_equal"] = all(
        torch.equal(a, b.full_tensor())
        for a, b in zip(_paths(init()).values(), _paths(sharded).values()))
    batch = {"tokens": torch.from_numpy(np.concatenate(
        [tokens, tokens[:, :1]], axis=1))}
    deltas = []
    for params, kw in ((init(), {}), (sharded, {"mesh": mesh})):
        before = {p: _np(t).copy() for p, t in _paths(params).items()}
        opt = adamw(1e-3)
        step = make_train_step(
            lambda p, b, kw=kw: T.lm_loss(p, b, cfg, device="cpu", **kw),
            opt)
        params, _, loss = step(params, opt.init(params), batch)
        deltas.append((float(loss.full_tensor() if isinstance(
            loss, DTensor) else loss),
            {p: _np(t) - before[p] for p, t in _paths(params).items()}))
    out["step"] = deltas
    return out


def pipelined(mesh, np_params, tokens, cfg_kw, n_micros):
    """forward_pipelined for each microbatch count: (logits, aux) full."""
    cfg = config(**cfg_kw)
    pp = mesh.size(1)
    params = shard_pytree(
        T.to_pipelined(T.params_from_jax(np_params, device="cpu"), pp),
        T.pipelined_param_specs(cfg), mesh)
    out = {}
    for m in n_micros:
        logits, aux = T.forward_pipelined(params, torch.from_numpy(tokens),
                                          cfg, mesh, num_microbatches=m)
        out[m] = (_np(logits), float(aux.full_tensor()))
    out["shares"] = shares(params)
    return out


def train(mesh, np_params, tokens, cfg_kw, lr, steps, n_micro):
    """`steps` AdamW steps of `__graft_entry__._dryrun_one`'s sharded train
    step: `lm_loss_pipelined` when pp > 1, else `lm_loss(mesh=)`; the batch
    placed by `batch_sharding`. Returns the losses, the first step's deltas
    (full) and each leaf's share."""
    cfg = config(**cfg_kw)
    pp = mesh.size(1)
    params = T.params_from_jax(np_params, device="cpu")
    if pp > 1:
        params = shard_pytree(T.to_pipelined(params, pp),
                              T.pipelined_param_specs(cfg), mesh)

        def loss_fn(p, b):
            return T.lm_loss_pipelined(p, b, cfg, mesh,
                                       num_microbatches=n_micro)
    else:
        params = shard_pytree(params, T.param_specs(cfg), mesh)

        def loss_fn(p, b):
            return T.lm_loss(p, b, cfg, mesh=mesh)

    place = batch_sharding(mesh)
    full = torch.from_numpy(tokens)
    batch = {"tokens": DTensor.from_local(
        to_local_block(full, mesh, place), mesh, place, run_check=False,
        shape=full.shape, stride=full.stride())}
    before = {p: _np(t).copy() for p, t in _paths(params).items()}
    opt = adamw(lr)
    state = opt.init(params)
    step = make_train_step(loss_fn, opt)
    losses, delta = [], None
    for i in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
        if i == 0:
            delta = {p: _np(t) - before[p] for p, t in _paths(params).items()}
    return losses, delta, shares(params)


def cases(shape, runs):
    """Each (name, body, args) of `runs` on one `shape` mesh: {name:
    body(mesh, *args)}."""
    mesh = make_mesh(shape, device="cpu")
    bodies = {"pipelined": pipelined, "train": train}
    return {name: bodies[body](mesh, *args) for name, body, args in runs}


def to_local_block(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's block of a batch every rank holds whole: what a data
    loader on each rank would produce."""
    from ray_tpu_torch.parallel.spmd import local_block

    return local_block(full, mesh, place).clone()


def hybrid():
    """make_hybrid_mesh on CPU ranks, each its own slice: the default shape
    puts every rank on dp; a model axis wider than a slice raises."""
    mesh = make_hybrid_mesh(device="cpu")
    out = {"shape": tuple(mesh.shape), "layout": mesh.mesh.tolist()}
    try:
        make_hybrid_mesh((4, 1, 1, 2), device="cpu")
    except ValueError as e:
        out["error"] = str(e)
    return out


def dispatch(q, k, v):
    """The attention dispatch on 2 ranks: which path each call takes (the
    ring, its body, plain, flash) and its output, on a mesh with sp 2
    (DTensors, then the body on local blocks with positions from the rank)
    and a mesh with dp 2 (plain attention on each rank's rows)."""
    routes = []
    for name in ("ring_attention_manual", "plain_attention",
                 "flash_attention"):
        real = getattr(A, name)

        def spy(*args, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(*args, **kw)

        setattr(A, name, spy)
    out = {}
    sp_mesh = make_mesh((1, 1, 2, 1), device="cpu")
    spec = {"q": P(None, "sp", None, None)}
    qs, ks, vs = (shard_pytree({"q": torch.from_numpy(a)}, spec,
                               sp_mesh)["q"] for a in (q, k, v))
    out["sp"] = _np(A.attention(qs, ks, vs, mesh=sp_mesh))
    out["sp_routes"] = list(routes)
    routes.clear()
    o = A.attention(qs.to_local(), ks.to_local(), vs.to_local(),
                    mesh=sp_mesh, manual_sp=True)
    out["manual"] = _np(DTensor.from_local(o, sp_mesh, qs.placements))
    out["manual_routes"] = list(routes)
    routes.clear()
    dp_mesh = make_mesh((2, 1, 1, 1), device="cpu")
    spec = {"q": P("dp", None, None, None)}
    qd, kd, vd = (shard_pytree({"q": torch.from_numpy(a)}, spec,
                               dp_mesh)["q"] for a in (q, k, v))
    out["dp"] = _np(A.attention(qd, kd, vd, mesh=dp_mesh))
    out["dp_routes"] = list(routes)
    return out
