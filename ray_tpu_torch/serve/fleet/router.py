"""KV-cache-aware fleet routing policy (a copy of
`ray_tpu/serve/fleet/router.py`).

Reference lineage: Ray Serve's PowerOfTwoChoicesReplicaScheduler for
the load half; the SGLang/vLLM cache-aware routing idea for the KV
half. The policy, in priority order:

1. **Sticky sessions** — a multi-turn conversation lands where its
   blocks live: a session pinned to a live replica stays there unless
   that replica is clearly overloaded relative to the least-loaded
   alternative (`inflight > 2*min_alt + 4`, the same slack rule the
   serve router uses for model affinity).
2. **Longest cached prefix** — route to the replica whose published
   digest matches the most prompt blocks, with the same overload
   escape: a hot holder saturating while idle replicas sit by routes
   to the idle one instead (that miss-with-remote-hit is exactly what
   triggers prefix shipping upstream in the fleet).
3. **Least-loaded fallback** — no replica has a hit: lowest
   inflight count wins (ties broken by registration order, which keeps
   tests deterministic).

The router also owns the fleet's conversation bookkeeping: per-replica
inflight counts (begin/complete), session pins, and `drop_replica` —
the failover path that must leave NO leaked inflight entries behind a
death (the fleet tests pin this).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.serve.fleet.digest import prompt_chain_hashes

__all__ = ["FleetRouter", "NoReplicasError", "RouteDecision"]

# Overload escape slack shared by the sticky/prefix preferences: prefer
# the affine replica until its inflight exceeds 2x the least-loaded
# alternative plus this many requests.
_SLACK = 4


class NoReplicasError(RuntimeError):
    """Every replica is dead (or excluded) — nothing to route to."""


@dataclass
class RouteDecision:
    rid: str                   # where the request goes
    match_tokens: int          # cached-prefix coverage there (digest)
    best_rid: Optional[str]    # fleet-wide longest holder (may == rid)
    best_match_tokens: int
    sticky: bool               # decided by session affinity
    prefix_hit: bool           # decided by longest-cached-prefix


class FleetRouter:
    def __init__(self, block_size: int, kv_routing: bool = True):
        self.block_size = int(block_size)
        # kv_routing=False degrades to pure least-loaded placement (no
        # digest matching) — the honest cold-per-replica baseline the
        # fleet bench compares KV-aware routing against.
        self.kv_routing = kv_routing
        self._replicas: Dict[str, object] = {}   # rid -> FleetReplica
        self._order: List[str] = []              # registration order
        self._inflight: Dict[str, int] = {}
        self._sessions: Dict[str, str] = {}
        self._lock = threading.Lock()
        self.route_prefix_hits = 0
        self.route_sticky_hits = 0
        self.route_fallbacks = 0

    # -- membership ----------------------------------------------------
    def register(self, rid: str, replica) -> None:
        with self._lock:
            if rid not in self._replicas:
                self._order.append(rid)
            self._replicas[rid] = replica
            self._inflight.setdefault(rid, 0)

    def drop_replica(self, rid: str) -> None:
        """Remove a dead replica from every routing structure. Its
        inflight entry vanishes (the conversations it owned re-begin on
        their survivors) and its session pins clear so the next turn of
        each session re-routes by prefix instead of chasing a corpse."""
        with self._lock:
            self._replicas.pop(rid, None)
            if rid in self._order:
                self._order.remove(rid)
            self._inflight.pop(rid, None)
            for sid in [s for s, r in self._sessions.items() if r == rid]:
                del self._sessions[sid]

    def live_replicas(self) -> List[str]:
        with self._lock:
            return [r for r in self._order
                    if getattr(self._replicas[r], "alive", True)]

    # -- bookkeeping ---------------------------------------------------
    def begin(self, rid: str) -> None:
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1

    def complete(self, rid: str) -> None:
        """Tolerates an already-dropped replica: a conversation that
        finishes after its owner died must not resurrect the entry."""
        with self._lock:
            if rid in self._inflight:
                self._inflight[rid] = max(0, self._inflight[rid] - 1)

    def inflight_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    # -- the decision --------------------------------------------------
    def route(self, prompt_tokens: Sequence[int],
              session_id: Optional[str] = None,
              exclude: Sequence[str] = ()) -> RouteDecision:
        hashes = prompt_chain_hashes(prompt_tokens, self.block_size)
        with self._lock:
            cands = [r for r in self._order
                     if r not in exclude
                     and getattr(self._replicas[r], "alive", True)]
            if not cands:
                raise NoReplicasError("no live fleet replicas")
            replicas = {r: self._replicas[r] for r in cands}
            loads = {r: self._inflight.get(r, 0) for r in cands}
            pinned = (self._sessions.get(session_id)
                      if session_id else None)

        # Digest matches OUTSIDE the lock: digest() may refresh from the
        # engine (the scrape analogue) and must not serialize routing.
        match: Dict[str, int] = {r: 0 for r in cands}
        if self.kv_routing:
            for r, rep in replicas.items():
                try:
                    match[r] = rep.digest().match_blocks(hashes) \
                        * self.block_size
                except Exception:
                    match[r] = 0
        best_rid = max(
            cands, key=lambda r: (match[r], -loads[r],
                                  -cands.index(r)))
        best = match[best_rid]
        min_load = min(loads.values())

        def overloaded(r: str) -> bool:
            return loads[r] > 2 * min_load + _SLACK

        chosen: Optional[str] = None
        sticky = prefix_hit = False
        if pinned is not None and pinned in replicas \
                and not overloaded(pinned):
            chosen, sticky = pinned, True
        elif best > 0 and not overloaded(best_rid):
            chosen, prefix_hit = best_rid, True
        else:
            chosen = min(cands, key=lambda r: (loads[r],
                                               cands.index(r)))
        with self._lock:
            if session_id:
                self._sessions[session_id] = chosen
            if sticky:
                self.route_sticky_hits += 1
            elif prefix_hit:
                self.route_prefix_hits += 1
            else:
                self.route_fallbacks += 1
        return RouteDecision(
            rid=chosen, match_tokens=match[chosen],
            best_rid=best_rid if best > 0 else None,
            best_match_tokens=best, sticky=sticky,
            prefix_hit=prefix_hit)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "replicas": len(self._order),
                "sessions": len(self._sessions),
                "route_prefix_hits": self.route_prefix_hits,
                "route_sticky_hits": self.route_sticky_hits,
                "route_fallbacks": self.route_fallbacks,
                "inflight": dict(self._inflight),
            }
