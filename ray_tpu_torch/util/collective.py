"""Eager (out-of-graph) collective communication between actors/tasks, the
port of `ray_tpu/util/collective.py`.

Reference equivalent: `python/ray/util/collective/collective.py` (API
:40,120,258) — `init_collective_group` / `allreduce` / `broadcast` / ...
executed eagerly from Python, outside any compiled graph. Two backends:

- ``gloo``: CPU tensors over TCP — rendezvous through the GCS KV (the
  reference rendezvouses through a named store actor), then a
  ProcessGroupGloo ring. This is the control-plane backend: weight
  broadcast to rollout workers, metric reductions, barriers.
- ``nccl``: CUDA tensors over NCCL, one member per leased card (its
  `cuda:0`), through the same KV rendezvous — the port's counterpart of
  the reference's ``ici`` backend, which `backend="ici"` names in its
  refusal. Every member calls each op in lockstep; an op returns once its
  result is on the card (the stream is synchronized), so its wall time is
  the collective's.

An op returns what it was given: a numpy array for a numpy array, a tensor
(on its device) for a tensor. Each op's wall time lands in the active
training step's `collective` telemetry (`air/session.py
_record_collective`).

In-graph collectives for SPMD training live in `ray_tpu_torch.parallel`;
this module is for code that needs a collective NOW, between independently
running processes.
"""

from __future__ import annotations

import datetime
import pickle
import socket
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "init_collective_group", "destroy_collective_group",
    "create_collective_group", "get_rank", "get_collective_group_size",
    "allreduce", "allgather", "reducescatter", "broadcast", "reduce",
    "barrier", "send", "recv", "local_ranks", "ReduceOp",
]


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


def _kv():
    from ray_tpu_torch.core.worker import current_runtime

    return current_runtime()


def _kv_key(group_name: str) -> bytes:
    return f"collective:{group_name}".encode()


@dataclass
class _Group:
    name: str
    world_size: int
    rank: int
    backend: str
    pg: Any = None          # gloo or NCCL process group
    store: Any = None       # keepalive: TCPStore master must outlive pg
    device: Any = None      # nccl: this member's card


_GROUPS: Dict[str, _Group] = {}


# ---------------------------------------------------------------------------
# group lifecycle
# ---------------------------------------------------------------------------
def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default",
                          timeout_s: float = 60.0) -> None:
    """Collectively create a named group: every member calls this with its
    rank (reference: collective.py:120 `init_collective_group`)."""
    if group_name in _GROUPS:
        raise RuntimeError(f"collective group {group_name!r} already "
                           "initialized in this process")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world size "
                         f"{world_size}")
    if backend == "ici":
        raise ValueError(
            "the 'ici' backend is the TPU's interconnect; on CUDA cards use "
            "backend='nccl' (or 'gloo' for CPU arrays)")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown collective backend {backend!r} "
                         "(expected 'gloo' or 'nccl')")
    _GROUPS[group_name] = _init_group(world_size, rank, group_name,
                                      backend, timeout_s)


def _init_group(world_size: int, rank: int, group_name: str, backend: str,
                timeout_s: float) -> _Group:
    import torch
    import torch.distributed as dist

    device = None
    if backend == "nccl":
        if not torch.cuda.is_available() or not hasattr(
                dist, "ProcessGroupNCCL"):
            raise RuntimeError(
                "the 'nccl' collective backend needs a CUDA card and a "
                "PyTorch built with NCCL (none here); use backend='gloo'")
        device = torch.device("cuda", torch.cuda.current_device())

    rt = _kv()
    key = _kv_key(group_name)
    store = None
    if rank == 0:
        host = socket.gethostbyname(socket.gethostname())
        s = socket.socket()
        s.bind((host, 0))
        port = s.getsockname()[1]
        s.close()
        # wait_for_workers=False: the master must NOT block before the
        # rendezvous address is published, or no client can ever join.
        store = dist.TCPStore(host, port, world_size, True,
                              timeout=datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=False)
        rt.kv_put(key, pickle.dumps((host, port, world_size)))
    else:
        deadline = time.monotonic() + timeout_s
        blob = None
        while time.monotonic() < deadline:
            blob = rt.kv_get(key)
            if blob is not None:
                break
            time.sleep(0.05)
        if blob is None:
            raise TimeoutError(
                f"collective group {group_name!r}: rank 0 never published "
                "a rendezvous address")
        host, port, declared = pickle.loads(blob)
        if declared != world_size:
            raise ValueError(
                f"group {group_name!r} declared world_size={declared}, "
                f"this rank expected {world_size}")
        store = dist.TCPStore(host, port, world_size, False,
                              timeout=datetime.timedelta(seconds=timeout_s))
    prefixed = dist.PrefixStore(group_name, store)
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "gloo":
        pg = dist.ProcessGroupGloo(prefixed, rank, world_size, timeout)
    else:
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(prefixed, rank, world_size, opts)
    return _Group(group_name, world_size, rank, backend, pg=pg, store=store,
                  device=device)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = "gloo",
                            group_name: str = "default") -> None:
    """Driver-side declaration: pushes `init_collective_group` into every
    actor (reference: collective.py:40 `create_collective_group` /
    declare_collective_group)."""
    import ray_tpu_torch

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must align")
    refs = [a.__ray_call__.remote(_remote_init, world_size, r, backend,
                                  group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs, timeout=120)


def _remote_init(self_obj, world_size, rank, backend, group_name):
    init_collective_group(world_size, rank, backend, group_name)
    return True


def destroy_collective_group(group_name: str = "default") -> None:
    group = _GROUPS.pop(group_name, None)
    if group is None:
        return
    if group.rank == 0:
        try:
            _kv().kv_del(_kv_key(group_name))
        except Exception:
            pass
    group.pg = None
    group.store = None


def get_rank(group_name: str = "default") -> int:
    return _require(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _require(group_name).world_size


def _require(group_name: str) -> _Group:
    group = _GROUPS.get(group_name)
    if group is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group first")
    return group


# ---------------------------------------------------------------------------
# tensor conversion — keep the caller's array type
# ---------------------------------------------------------------------------
def _to_torch(array, group: _Group):
    """A contiguous tensor on the group's device that the op may write: a
    copy of the caller's array or tensor, never the caller's memory."""
    import torch

    if isinstance(array, torch.Tensor):
        t = array.detach().clone().contiguous()
    else:
        t = torch.from_numpy(np.array(np.asarray(array), order="C"))
    if group.device is not None:
        t = t.to(group.device)
    elif t.device.type != "cpu":
        t = t.cpu()
    return t


def _from_torch(tensor, like, group: _Group):
    import torch

    if group.device is not None:
        torch.cuda.current_stream(group.device).synchronize()
    if isinstance(like, torch.Tensor):
        return tensor.to(like.device)
    return tensor.cpu().numpy()


def _torch_op(op: str):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}[op]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _timed_collective(fn):
    """Attribute each eager collective's wall time to the active
    training step (air/session step telemetry: the `collective` split).
    No-op outside a train loop; the in-graph collectives of
    `ray_tpu_torch.parallel` (DTensor redistributions) are not seen
    here."""
    import functools
    import time as _time

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = _time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            try:
                from ray_tpu_torch.air.session import _record_collective

                _record_collective(_time.perf_counter() - t0)
            except Exception:
                pass

    return wrapped


@_timed_collective
def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM):
    """All-reduce; returns the reduced array (same array type as input).
    Reference: collective.py:258."""
    group = _require(group_name)
    t = _to_torch(tensor, group)
    _allreduce(t, group, op)
    return _from_torch(t, tensor, group)


def _allreduce(t, group: _Group, op: str) -> None:
    import torch.distributed as dist

    opts = dist.AllreduceOptions()
    opts.reduceOp = _torch_op(op)
    group.pg.allreduce([t], opts).wait()


@_timed_collective
def allgather(tensor, group_name: str = "default") -> List[Any]:
    """Gathers every rank's tensor; returns a list of arrays in rank
    order."""
    group = _require(group_name)
    t = _to_torch(tensor, group)
    import torch

    outs = [[torch.zeros_like(t) for _ in range(group.world_size)]]
    group.pg.allgather(outs, [t]).wait()
    return [_from_torch(o, tensor, group) for o in outs[0]]


@_timed_collective
def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM):
    """Reduce-scatter along axis 0: rank i receives slice i of the
    reduction. NCCL reduce-scatters natively; on gloo, all-reduce and
    slice, as the reference's pygloo fallback does."""
    group = _require(group_name)
    t = _to_torch(tensor, group)
    n = group.world_size
    if t.shape[0] % n:
        raise ValueError(f"reducescatter: axis-0 size {t.shape[0]} not "
                         f"divisible by world size {n}")
    chunk = t.shape[0] // n
    if group.device is None:
        _allreduce(t, group, op)
        out = t[group.rank * chunk:(group.rank + 1) * chunk]
    else:
        import torch
        import torch.distributed as dist

        out = torch.empty((chunk,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _torch_op(op)
        group.pg._reduce_scatter_base(out, t, opts).wait()
    return _from_torch(out, tensor, group)


@_timed_collective
def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    group = _require(group_name)
    import torch.distributed as dist

    t = _to_torch(tensor, group)
    opts = dist.BroadcastOptions()
    opts.rootRank = src_rank
    opts.rootTensor = 0
    group.pg.broadcast([t], opts).wait()
    return _from_torch(t, tensor, group)


@_timed_collective
def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM):
    group = _require(group_name)
    import torch.distributed as dist

    t = _to_torch(tensor, group)
    opts = dist.ReduceOptions()
    opts.reduceOp = _torch_op(op)
    opts.rootRank = dst_rank
    group.pg.reduce([t], opts).wait()
    return _from_torch(t, tensor, group)


@_timed_collective
def barrier(group_name: str = "default") -> None:
    group = _require(group_name)
    if group.device is not None:
        # NCCL's own barrier picks a card by rank, and a member sees only
        # its lease's card: an all-reduce of one element on it instead.
        import torch

        group.pg.allreduce([torch.zeros(1, device=group.device)]).wait()
        torch.cuda.current_stream(group.device).synchronize()
        return
    group.pg.barrier().wait()


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0, timeout: Optional[float] = None) -> None:
    """P2P send to `dst_rank` (reference: collective.py send/recv pairs).
    Messages with one `tag` between one pair of ranks match in send
    order. `timeout` (seconds) bounds the wait: a dead receiver otherwise
    parks this thread in the backend for good. A compiled graph's
    `"device"` edge sends its payload here (`cgraph/channel.py
    DeviceChannel.write`), one tag per edge."""
    group = _require(group_name)
    t = _to_torch(tensor, group)
    _wait(group.pg.send([t], dst_rank, tag), timeout)
    if group.device is not None:
        import torch

        torch.cuda.current_stream(group.device).synchronize()


def recv(tensor, src_rank: int, group_name: str = "default",
         tag: int = 0, timeout: Optional[float] = None):
    """Receives into a tensor of the given shape/dtype; returns it.
    `timeout` bounds the wait (see send). The reading end of a `"device"`
    edge (`DeviceChannel._decode`), into a buffer on the group's card
    for NCCL."""
    group = _require(group_name)
    t = _to_torch(tensor, group)
    _wait(group.pg.recv([t], src_rank, tag), timeout)
    return _from_torch(t, tensor, group)


def _wait(work, timeout: Optional[float]) -> None:
    if timeout is None:
        work.wait()
    else:
        work.wait(datetime.timedelta(seconds=timeout))


def local_ranks() -> Dict[str, int]:
    """{group_name: rank} for every group this process has initialized.
    A worker answers the `collective_ranks` RPC with it
    (`core/cluster_runtime.py`), which a `"device"` edge's writer asks to
    find a group that it shares with its reader."""
    return {name: g.rank for name, g in _GROUPS.items()}
