"""Placement-group bundle→node selection policies + GCS-led rescheduling,
the port of `ray_tpu/core/pg_scheduler.py` (GPUs where the reference
counts TPU chips).

Reference equivalent: `src/ray/raylet/scheduling/policy/
bundle_scheduling_policy.h` (+ `scorer.h`) — STRICT_PACK / PACK / SPREAD /
STRICT_SPREAD over a cluster resource view. Initial placement runs
owner-side (the creating worker drives the 2PC) against the GCS node
table; staleness is handled by the caller retrying on prepare failure.

`reschedule_placement_group` is: the GCS-led recovery pass
(reference: GcsPlacementGroupScheduler rescheduling on node death) that
re-places only a CREATED group's LOST bundles onto survivors — surviving
bundles keep their reservations — through the same prepare/commit 2PC,
with every state transition written through so a crash mid-reschedule is
resumable and cannot leak capacity (the raylet-side reconciler returns
commits the final location table did not keep).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def validate_pg_args(bundles, strategy: str) -> None:
    """Shared by every runtime that creates placement groups."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid placement strategy {strategy!r}; "
                         f"valid: {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("placement group requires non-empty bundles")


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _take(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


def select_pg_nodes(bundles: List[Dict[str, float]],
                    nodes: List[Dict[str, Any]], strategy: str,
                    target_node_ids: Optional[List[str]] = None
                    ) -> Optional[List[Dict[str, Any]]]:
    """Pick one node per bundle, or None if infeasible against this view.

    `target_node_ids` pins bundle i to the node with that id."""
    avail = {n["node_id"]: dict(n.get("resources_available", {}))
             for n in nodes}
    by_id = {n["node_id"]: n for n in nodes}

    if target_node_ids is not None:
        if len(target_node_ids) != len(bundles):
            return None
        out = []
        for demand, nid in zip(bundles, target_node_ids):
            if nid not in avail or not _fits(avail[nid], demand):
                return None
            _take(avail[nid], demand)
            out.append(by_id[nid])
        return out

    # Most-available-first ordering (scorer.h tie-break: spread load).
    # Nodes whose resource view is STALE — recovered from persisted GCS
    # state after a restart, not yet re-confirmed by a heartbeat — sort
    # behind every fresh node: their recorded availability may describe
    # a pre-crash world, and a prepare against it fails and burns a 2PC
    # round trip.
    def capacity(nid: str) -> float:
        a = avail[nid]
        return a.get("CPU", 0.0) + a.get("GPU", 0.0)

    def freshness_then_capacity(nid: str):
        return (0 if by_id[nid].get("stale_view") else 1, capacity(nid))

    ordered = sorted(avail, key=freshness_then_capacity, reverse=True)

    if strategy == "STRICT_PACK":
        total: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        for nid in ordered:
            if _fits(avail[nid], total):
                return [by_id[nid]] * len(bundles)
        return None

    if strategy == "STRICT_SPREAD":
        out, used = [], set()
        for demand in bundles:
            nid = next((n for n in ordered
                        if n not in used and _fits(avail[n], demand)), None)
            if nid is None:
                return None
            used.add(nid)
            _take(avail[nid], demand)
            out.append(by_id[nid])
        return out

    if strategy == "PACK":
        out: List[Dict[str, Any]] = []
        used_order: List[str] = []
        for demand in bundles:
            # Prefer nodes already holding a bundle of this group.
            nid = next((n for n in used_order if _fits(avail[n], demand)),
                       None)
            if nid is None:
                nid = next((n for n in ordered if _fits(avail[n], demand)),
                           None)
            if nid is None:
                return None
            if nid not in used_order:
                used_order.append(nid)
            _take(avail[nid], demand)
            out.append(by_id[nid])
        return out

    if strategy == "SPREAD":
        out = []
        last: Optional[str] = None
        for demand in bundles:
            # Best-effort spread: most-available feasible node that isn't
            # the one we just used, falling back to any feasible node.
            candidates = sorted((n for n in avail if _fits(avail[n], demand)),
                                key=freshness_then_capacity, reverse=True)
            if not candidates:
                return None
            nid = next((n for n in candidates if n != last), candidates[0])
            last = nid
            _take(avail[nid], demand)
            out.append(by_id[nid])
        return out

    raise ValueError(f"unknown placement strategy {strategy!r}; "
                     f"valid: {VALID_STRATEGIES}")


async def reschedule_placement_group(gcs, raylet_client_for, pg_id: str,
                                     *, attempts: int = 8) -> str:
    """Re-place the LOST bundles of a RESCHEDULING group onto surviving
    nodes; bundles whose node is still alive keep their reservations
    untouched. Driven BY THE GCS when `_mark_node_dead` finds a CREATED
    group on the dead node (the owner may itself be gone — recovery
    cannot be owner-led).

    Protocol per attempt: read the group (only the RESCHEDULING state
    proceeds — a user remove wins any race via the CAS), compute lost
    indices against the live node table, select placement for just
    those bundles (STRICT_SPREAD excludes nodes already holding a
    surviving bundle; STRICT_PACK's loss is all-or-nothing by
    construction), 2PC prepare+commit on the chosen nodes, then CAS
    RESCHEDULING -> CREATED with the merged location table
    (write-through — the terminal transition must survive a kill -9).
    Failure rolls back this attempt's reservations and retries; a crash
    between commit and the CAS is healed by the raylet reconciler's
    location check once a later pass lands CREATED elsewhere.

    Returns the state the group was left in: "CREATED" on success,
    "RESCHEDULING" when every attempt failed (the GCS health loop
    re-kicks when the cluster changes), or the foreign terminal state
    observed ("REMOVED"/"INFEASIBLE")."""
    from ray_tpu_torch.core import flight

    for attempt in range(attempts):
        try:
            info = await gcs.get_placement_group(pg_id)
            state = (info or {}).get("state")
            if state != "RESCHEDULING":
                return state or "UNKNOWN"
            bundles = info["bundles"]
            locs = list(info.get("bundle_locations") or [])
            nodes = [n for n in await gcs.get_nodes() if n.get("alive")]
            alive_ids = {n["node_id"] for n in nodes}
            lost = [i for i, loc in enumerate(locs)
                    if loc.get("node_id") not in alive_ids]
            if len(locs) != len(bundles):
                # Defensive: a malformed record can't be re-placed.
                lost = list(range(len(bundles)))
                locs = [{"node_id": None, "address": None}
                        for _ in bundles]
            if not lost:
                # Every location is alive again (e.g. the reschedule
                # raced a transient death verdict): just restore CREATED.
                ok = await gcs.update_placement_group(
                    pg_id, {"state": "CREATED"},
                    expect_state="RESCHEDULING")
                if ok:
                    return "CREATED"
                continue
            surviving_nodes = {locs[i]["node_id"]
                               for i in range(len(locs)) if i not in lost}
            strategy = info["strategy"]
            eligible = (
                [n for n in nodes if n["node_id"] not in surviving_nodes]
                if strategy == "STRICT_SPREAD" else nodes)
            placement = select_pg_nodes([bundles[i] for i in lost],
                                        eligible, strategy)
            if placement is None:
                await asyncio.sleep(0.25 * (attempt + 1))
                continue
            prepared: List[tuple] = []
            failure = None
            try:
                for slot, idx in enumerate(lost):
                    node = placement[slot]
                    client = await raylet_client_for(node["address"])
                    r = await client.call(
                        "prepare_bundle", pg_id=pg_id, bundle_index=idx,
                        resources=bundles[idx], timeout=10.0)
                    if not r.get("ok"):
                        failure = r.get("reason", "prepare rejected")
                        break
                    prepared.append((idx, node))
                if failure is None:
                    for idx, node in prepared:
                        client = await raylet_client_for(node["address"])
                        ok = await client.call("commit_bundle",
                                               pg_id=pg_id,
                                               bundle_index=idx,
                                               timeout=10.0)
                        if not ok:
                            # Reservation vanished between prepare and
                            # commit (raylet restart, concurrent
                            # return): landing it in the location
                            # table would create a CREATED group
                            # nothing can lease against.
                            failure = (f"commit rejected for bundle "
                                       f"{idx} on {node['node_id']}")
                            break
                if failure is None:
                    new_locs = list(locs)
                    for idx, node in prepared:
                        new_locs[idx] = {"node_id": node["node_id"],
                                         "address": node["address"]}
                    ok = await gcs.update_placement_group(pg_id, {
                        "state": "CREATED",
                        "bundle_locations": new_locs,
                    }, expect_state="RESCHEDULING")
                    if ok:
                        if flight.enabled:
                            flight.instant(
                                "pg", "pg.reschedule",
                                arg=f"{pg_id[:8]} n={len(prepared)}")
                        logger.info(
                            "placement group %s rescheduled: %d bundle(s) "
                            "re-placed", pg_id[:8], len(prepared))
                        return "CREATED"
                    failure = "cas rejected"
            except Exception as e:  # noqa: BLE001
                failure = str(e)
            # Only the GCS rescheduler writes CREATED from RESCHEDULING:
            # a CREATED re-read after a CAS miss/error means OUR update
            # applied with a lost ack — keep it. Any other state means
            # roll back this attempt's new reservations and honor it.
            try:
                cur = await gcs.get_placement_group(pg_id)
                if (cur or {}).get("state") == "CREATED":
                    return "CREATED"
            except Exception:
                pass
            logger.warning("pg %s reschedule attempt failed: %s",
                           pg_id[:8], failure)
            if flight.enabled:
                flight.instant("pg", "pg.rollback",
                               arg=f"{pg_id[:8]} resched n={len(prepared)}")
            for idx, node in prepared:
                try:
                    client = await raylet_client_for(node["address"])
                    await client.call("return_bundle", pg_id=pg_id,
                                      bundle_index=idx, timeout=10.0)
                except Exception:
                    pass
            await asyncio.sleep(0.25 * (attempt + 1))
        except Exception as e:  # noqa: BLE001
            logger.warning("pg %s reschedule pass error: %s", pg_id[:8], e)
            await asyncio.sleep(0.25 * (attempt + 1))
    return "RESCHEDULING"
