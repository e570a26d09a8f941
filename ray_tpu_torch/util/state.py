"""State API: programmatic cluster introspection, the port of
`ray_tpu/util/state.py`. It reads what both of the port's runtimes
already keep: `nodes()`, the task-event store, the GCS's actor table
(the cluster runtime; local mode keeps none) and each raylet's
`node_stats`.

Reference equivalent: `python/ray/util/state/` (`list_tasks`,
`list_actors`, `list_objects`, `list_nodes`, `list_placement_groups`,
`summarize_tasks`) backed by the GCS tables and task-event store.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _runtime():
    from ray_tpu_torch.core.worker import current_runtime

    return current_runtime()


def list_nodes() -> List[Dict[str, Any]]:
    return _runtime().nodes()


def list_actors() -> List[Dict[str, Any]]:
    rt = _runtime()
    if hasattr(rt, "_gcs"):
        return rt._loop.run(rt._gcs.list_actors(), timeout=30)
    return rt.list_actors() if hasattr(rt, "list_actors") else []


def list_tasks(job_id: Optional[str] = None,
               detail: bool = False) -> List[Dict[str, Any]]:
    """Latest lifecycle state per task, newest first (reference:
    util/state/api.py list_tasks)."""
    rt = _runtime()
    events = _task_events(rt, job_id)
    latest: Dict[str, Dict[str, Any]] = {}
    for e in sorted(events, key=lambda x: x["ts"]):
        cur = latest.setdefault(e["task_id"], {
            "task_id": e["task_id"], "name": e["name"],
            "state": e["event"], "job_id": e.get("job_id"),
            "start_ts": None, "end_ts": None,
        })
        cur["state"] = e["event"]
        if e["event"] == "RUNNING":
            cur["start_ts"] = e["ts"]
            cur["node_id"] = e.get("node_id")
            cur["worker_id"] = e.get("worker_id")
        elif e["event"] in ("FINISHED", "FAILED"):
            cur["end_ts"] = e["ts"]
        if detail:
            cur.setdefault("events", []).append(e)
    return sorted(latest.values(),
                  key=lambda t: t.get("start_ts") or 0, reverse=True)


def summarize_tasks(job_id: Optional[str] = None) -> Dict[str, Any]:
    """Counts per (name, state) — `ray summary tasks`."""
    out: Dict[str, Dict[str, int]] = {}
    for t in list_tasks(job_id):
        per = out.setdefault(t["name"], {})
        per[t["state"]] = per.get(t["state"], 0) + 1
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Objects resident in every node's plasma store (reference:
    `ray memory` / list_objects)."""
    rt = _runtime()
    if not hasattr(rt, "object_store_stats"):
        return []
    return rt.object_store_stats()


def node_stats(address: str) -> Dict[str, Any]:
    """One raylet's live stats (workers, leases, store, object-manager
    flow control). Reference: `ray.util.state` node detail backed by
    NodeManagerService.GetNodeStats."""
    rt = _runtime()

    async def _fetch():
        client = await rt._raylet_client(address)
        return await client.call("node_stats", timeout=30.0)

    return rt._loop.run(_fetch(), timeout=30)


def list_placement_groups() -> List[Dict[str, Any]]:
    from ray_tpu_torch.util.placement_group import placement_group_table

    table = placement_group_table()
    return list(table.values()) if isinstance(table, dict) else table


def _task_events(rt, job_id: Optional[str]) -> List[Dict[str, Any]]:
    # Both runtimes expose the same flush-and-fetch entry (cluster: GCS
    # store; local mode: the in-process buffer).
    return rt.task_events(job_id)
