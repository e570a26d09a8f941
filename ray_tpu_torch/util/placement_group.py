"""Placement groups: atomic gang reservation of resources across nodes,
the port of `ray_tpu/util/placement_group.py`.

Reference equivalent: `python/ray/util/placement_group.py:41,146`
(PlacementGroup handle + factory) over the GCS/raylet 2PC
(`gcs_placement_group_scheduler.h`). Where the reference gang-reserves
one bundle per host of a TPU slice (one ICI domain),
`gpu_gang_placement_group` gang-reserves a bundle per worker on ONE node,
whose cards NVLink joins: an NCCL gang is refused, not scattered.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core import worker as _worker


class PlacementGroup:
    """Handle to a placement group (reference: placement_group.py:41)."""

    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str = "PACK"):
        self.id = pg_id
        self._bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b) for b in self._bundles]

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self):
        """ObjectRef that resolves when the group is placed — `get(pg.
        ready())` mirrors the reference's await-style readiness check.
        Returns immediately; raises now only if the group is already in a
        terminal failed state."""
        import ray_tpu_torch

        info = placement_group_table(self) or {}
        if info.get("state") in ("REMOVED", "INFEASIBLE"):
            raise ValueError(
                f"placement group {self.id} is {info.get('state')}: "
                f"{info.get('detail', '')}")

        # Scheduling the probe task inside bundle 0 proves the reservation
        # is live end-to-end (lease from the bundle, not just table state);
        # the submission path itself waits for CREATED. The probe is a
        # module-level function: the port exports code by reference.
        return ray_tpu_torch.remote(num_cpus=0)(_pg_ready).options(
            placement_group=self.id,
            placement_group_bundle_index=0).remote()

    def wait(self, timeout_seconds: Optional[float] = 30.0) -> bool:
        return _worker.current_runtime().placement_group_wait(
            self.id, timeout=timeout_seconds)

    def __repr__(self) -> str:
        return (f"PlacementGroup(id={self.id[:12]}..., "
                f"strategy={self.strategy}, bundles={self._bundles})")


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK", name: str = "",
                    lifetime: Optional[str] = None,
                    _target_node_ids: Optional[List[str]] = None
                    ) -> PlacementGroup:
    """Reserve `bundles` across the cluster (reference:
    placement_group.py:146). Returns immediately; scheduling is async —
    use `pg.wait()` / `get(pg.ready())` before relying on it."""
    rt = _worker.current_runtime()
    pg_id = rt.create_placement_group(bundles, strategy=strategy, name=name,
                                      target_node_ids=_target_node_ids)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: "PlacementGroup | str") -> None:
    pg_id = pg.id if isinstance(pg, PlacementGroup) else pg
    _worker.current_runtime().remove_placement_group(pg_id)


def placement_group_table(pg: "PlacementGroup | str | None" = None):
    pg_id = pg.id if isinstance(pg, PlacementGroup) else pg
    return _worker.current_runtime().placement_group_table(pg_id)


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The PG capturing the current task/actor, if any (reference:
    placement_group.py get_current_placement_group). Capture of child
    tasks is not propagated yet, so this is None outside explicit use."""
    return None


def _pg_ready() -> bool:
    return True


# ---------------------------------------------------------------------
# GPU gang scheduling: the counterpart of the reference's
# tpu_slice_placement_group
# ---------------------------------------------------------------------
def gpu_gang_placement_group(num_workers: int, gpus_per_worker: float = 1.0,
                             cpus_per_worker: float = 1.0
                             ) -> PlacementGroup:
    """Gang-reserve one bundle of `gpus_per_worker` GPUs per worker, all
    on a SINGLE node (STRICT_PACK, pinned to it): NCCL collectives then
    ride that node's NVLink, as the reference's slice gangs ride one ICI
    domain. The node is the live one with the most free GPUs. Raises
    ValueError immediately — fail fast — when no live node has
    `num_workers * gpus_per_worker` free GPUs; it never scatters a gang
    across nodes."""
    import ray_tpu_torch

    need = num_workers * gpus_per_worker
    seen = {}
    for node in ray_tpu_torch.nodes():
        if not node.get("Alive"):
            continue
        # Judge by AVAILABLE GPUs: leased cards must not count.
        avail = node.get("Available") or node.get("Resources", {})
        seen[node["NodeID"]] = avail.get("GPU", 0.0)
    fits = sorted(((free, nid) for nid, free in seen.items()
                   if free + 1e-9 >= need), reverse=True)
    if not fits:
        by_node = {nid[:8]: free for nid, free in seen.items()}
        raise ValueError(
            f"No single node has {num_workers} worker(s) x "
            f"{gpus_per_worker} GPU(s) = {need} free GPU(s) (free GPUs "
            f"by node: {by_node or 'no live node'}); a gang cannot span "
            "nodes.")
    node_id = fits[0][1]
    bundle = {"CPU": cpus_per_worker, "GPU": float(gpus_per_worker)}
    return placement_group(
        [dict(bundle) for _ in range(num_workers)],
        strategy="STRICT_PACK", name=f"gpu-gang-{node_id[:8]}",
        _target_node_ids=[node_id] * num_workers)
