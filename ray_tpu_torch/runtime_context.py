"""Runtime context: what task/actor/node/job am I?

Reference equivalent: `python/ray/runtime_context.py` (`get_runtime_context()`).
Uses contextvars so the context is correct both on executor threads (sync
tasks/actor methods) and inside asyncio tasks (async actor methods), where
thread-locals would leak across interleaved coroutines.
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional

_ctx: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "ray_tpu_task_context", default={})


class RuntimeContext:
    @property
    def job_id(self):
        from ray_tpu_torch.core.worker import current_runtime
        return current_runtime().job_id

    def get_job_id(self) -> str:
        return self.job_id.hex()

    @property
    def node_id(self):
        from ray_tpu_torch.core.worker import current_runtime
        rt = current_runtime()
        return getattr(rt, "node_id", None)

    def get_node_id(self) -> Optional[str]:
        nid = self.node_id
        return nid.hex() if nid is not None else "local"

    def get_actor_id(self) -> Optional[str]:
        aid = _ctx.get().get("actor_id")
        return aid.hex() if aid is not None else None

    def get_task_id(self) -> Optional[str]:
        tid = _ctx.get().get("task_id")
        return tid.hex() if tid is not None else None

    def get_worker_id(self) -> Optional[str]:
        from ray_tpu_torch.core.worker import current_runtime
        wid = getattr(current_runtime(), "worker_id", None)
        return wid.hex() if wid is not None else None

    @property
    def current_actor(self):
        handle = _ctx.get().get("actor_handle")
        if handle is None:
            raise RuntimeError("Not running inside an actor")
        return handle

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return _ctx.get().get("actor_restart_count", 0) > 0

    def get_assigned_resources(self) -> dict:
        return _ctx.get().get("assigned_resources", {})

    def get_placement_group_id(self) -> Optional[str]:
        pg = _ctx.get().get("placement_group_id")
        return pg.hex() if pg is not None else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def _set_task_context(task_id=None, actor_id=None, actor_handle=None,
                      assigned_resources=None, placement_group_id=None,
                      actor_restart_count=0) -> contextvars.Token:
    return _ctx.set({
        "task_id": task_id,
        "actor_id": actor_id,
        "actor_handle": actor_handle,
        "assigned_resources": assigned_resources or {},
        "placement_group_id": placement_group_id,
        "actor_restart_count": actor_restart_count,
    })


def _reset_task_context(token: contextvars.Token) -> None:
    _ctx.reset(token)
