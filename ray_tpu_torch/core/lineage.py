"""Owner-side lineage bookkeeping + the reconstruction decision.

Reference equivalent: `src/ray/core_worker/task_manager.h` (lineage
pinning, `RetryTaskIfPossible`) + `object_recovery_manager.h` — the
owner of an object retains the wire-encoded spec of the task that
produced it (and pins that task's argument objects) for as long as any
return ref lives, so a lost copy can be recovered by re-executing the
task instead of failing the borrower's `get()`.

This module holds the POLICY half — retention gating, the bounded
per-object re-execution budget, inflight dedup, live-ref accounting —
factored out of `ClusterRuntime` so `core/simcluster.py` drives the
IDENTICAL state machine at 100 simulated nodes under seeded fault
schedules. The IO half (resetting owner entries to pending, resubmitting
through the dispatch tiers) stays with each consumer: the runtime
resubmits real wire specs, the sim re-runs simulated producer tasks.

The `spec` a record carries is opaque to the table: the production
runtime stores the lazily wire-encoded TaskSpec dict, the sim harness a
producer descriptor.

The port's copy of `ray_tpu/core/lineage.py`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import ray_config

logger = logging.getLogger(__name__)

# begin_reexec verdicts
STARTED = "started"          # budget charged; caller must re-execute
INFLIGHT = "inflight"        # a re-execution is already running
EXHAUSTED = "exhausted"      # budget spent: degrade to ObjectLostError
UNRETAINED = "unretained"    # no lineage (flag off, or ref released)


class LineageTable:
    """Return-oid -> shared producing-task record. One record per task,
    indexed under every return oid; released when the last return ref
    is freed (the caller then unpins the record's argument objects)."""

    def __init__(self):
        self._records: Dict[str, dict] = {}
        # Recovery throughput counters (surfaced by stats()).
        self.reexecs = 0
        self.exhausted = 0

    def __len__(self) -> int:
        # Distinct records, not index entries (multi-return tasks index
        # one record N times).
        return len({id(r) for r in self._records.values()})

    @staticmethod
    def enabled() -> bool:
        return bool(ray_config().lineage_reconstruction)

    def retain(self, ref_oids: List[str], spec: Any, pinned: List[Any],
               budget: int) -> Optional[dict]:
        """Retain `spec` for the task whose returns are `ref_oids`.
        Returns the record, or None when lineage reconstruction is
        disabled (the caller then releases its arg pins normally).
        `budget` is the per-object re-execution allowance — bounded by
        `lineage_reconstruction_budget` so a max_retries=-1 style
        request can never re-execute unboundedly."""
        if not self.enabled():
            return None
        cap = max(0, int(ray_config().lineage_reconstruction_budget))
        if budget < 0:
            budget = cap
        rec = {
            "spec": spec,
            "ref_oids": list(ref_oids),
            "pinned": pinned,
            "left": min(max(int(budget), 0), cap),
            "live": len(ref_oids),
            "inflight": False,
        }
        for oid in ref_oids:
            self._records[oid] = rec
        return rec

    def get(self, oid: str) -> Optional[dict]:
        return self._records.get(oid)

    def release(self, oid: str) -> Optional[List[Any]]:
        """One return ref was freed. Returns the record's pinned arg
        list when this was the LAST live ref (the caller unpins), else
        None."""
        rec = self._records.pop(oid, None)
        if rec is None:
            return None
        rec["live"] -= 1
        if rec["live"] <= 0:
            pinned, rec["pinned"] = rec["pinned"], []
            return pinned
        return None

    def drop_record(self, rec: dict) -> List[Any]:
        """Drop a whole record early (every result landed inline: the
        owner future holds the values, nothing is ever losable).
        Returns the pinned arg list for the caller to unpin."""
        for oid in rec["ref_oids"]:
            if self._records.get(oid) is rec:
                del self._records[oid]
        rec["live"] = 0
        pinned, rec["pinned"] = rec["pinned"], []
        return pinned

    def begin_reexec(self, oid: str) -> Tuple[str, Optional[dict]]:
        """The reconstruction decision for one lost object: STARTED
        charges the budget and flags the record inflight (the caller
        MUST call end_reexec when the re-execution settles); INFLIGHT
        means keep waiting; EXHAUSTED/UNRETAINED mean the loss is
        final and the typed error stands."""
        rec = self._records.get(oid)
        if rec is None:
            return (UNRETAINED, None)
        if rec["inflight"]:
            return (INFLIGHT, rec)
        if rec["left"] <= 0:
            self.exhausted += 1
            return (EXHAUSTED, rec)
        rec["inflight"] = True
        rec["left"] -= 1
        self.reexecs += 1
        from ray_tpu_torch.core import flight

        if flight.enabled:
            name = (rec["spec"].get("name")
                    if isinstance(rec["spec"], dict) else str(rec["spec"]))
            flight.instant("lineage", "lineage.reexec",
                           arg=f"{name} left={rec['left']}")
        return (STARTED, rec)

    def end_reexec(self, rec: dict) -> None:
        rec["inflight"] = False

    def stats(self) -> Dict[str, int]:
        return {"retained": len(self), "reexecs": self.reexecs,
                "exhausted": self.exhausted}
