"""Seeded deterministic fault injection, a copy of `ray_tpu/core/faults.py`.

Every decision is a pure function of (seed, rule, edge, per-edge message
index), so a failure found under a schedule is a *failing seed*, not an
anecdote. Re-running the same seed against the same workload replays the
identical fault schedule.

The port has no RPC layer yet. The serving fleet (`serve/fleet/fleet.py`)
routes its logical edges (submit, per-token stream credit, prefix ship)
through `FaultPlan.apply()` with explicit (src, dst) identities, and the
module-level `install`/`get_plan` hooks are kept for the runtime slice.
`FaultInjected` subclasses this module's own `ConnectionLost`, the
transport-loss signal every retry path handles.

Rule semantics (all matching is (src, dst, method) with "*" wildcards,
applied in registration order; several rules can fire on one message):

- drop      — the message never arrives; the caller sees ConnectionLost.
- delay     — delivery is postponed `delay_s` seconds.
- duplicate — the server dispatches the message twice (at-least-once
              delivery; flushes out non-idempotent handlers).
- partition — a one-way cut: every src->dst message drops until healed.
- crash     — when dst has received its nth matching message, a crash
              callback fires and the message is lost.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ConnectionLost", "FaultPlan", "FaultAction", "FaultInjected",
           "enabled", "install", "uninstall", "get_plan"]

# Module-level switch for a transport's call path. Off by default;
# install() flips it. A plain bool, so the hot path pays one attribute
# load.
enabled = False
_plan: Optional["FaultPlan"] = None


@dataclass
class FaultAction:
    """One applied (or scheduled) fault, for the replay log."""
    kind: str
    src: str
    dst: str
    method: str
    n: int            # per-edge message index the decision keyed on
    arg: Any = None

    def key(self) -> Tuple:
        return (self.kind, self.src, self.dst, self.method, self.n)


@dataclass
class _Rule:
    kind: str                      # drop | delay | duplicate | partition | crash
    src: str = "*"
    dst: str = "*"
    method: str = "*"
    p: float = 1.0
    delay_s: float = 0.0
    after_n: int = 0               # crash: fire on the nth matching message
    start: int = 0                 # active for edge msg index >= start
    end: Optional[int] = None      # ... and < end
    active: bool = True            # partitions can be healed
    on_crash: Optional[Callable[[str], Any]] = None
    idx: int = 0                   # registration order, part of the seed
    # crash rules count matching messages per dst
    _crash_counts: Dict[str, int] = field(default_factory=dict)
    fired: bool = False

    def matches(self, src: str, dst: str, method: str, n: int) -> bool:
        if not self.active:
            return False
        if self.src != "*" and self.src != src:
            return False
        if self.dst != "*" and self.dst != dst:
            return False
        if self.method != "*" and self.method != method:
            return False
        if n < self.start or (self.end is not None and n >= self.end):
            return False
        return True


class ConnectionLost(Exception):
    """The transport lost a message or its peer (the port's stand-in for
    `ray_tpu.core.rpc.ConnectionLost`)."""


class FaultInjected(ConnectionLost):
    """Raised where a dropped message surfaces to the caller. Subclasses
    ConnectionLost so every transport-loss retry path treats it exactly
    like a dead socket."""


class FaultPlan:
    """A seeded, replayable schedule of RPC faults.

    Decisions are PURE: `decide(src, dst, method, n)` derives each
    rule's verdict from `random.Random(f"{seed}:{rule.idx}:{edge}:{n}")`
    — no RNG state is consumed across calls, so the schedule is
    identical regardless of async interleaving, retries, or wall time.
    `apply()` additionally tracks per-edge message counters and records
    what actually fired into `self.log`.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rules: List[_Rule] = []
        self.log: List[FaultAction] = []
        self._edge_counts: Dict[Tuple[str, str], int] = {}

    # -- rule builders --------------------------------------------------
    def _add(self, rule: _Rule) -> _Rule:
        rule.idx = len(self.rules)
        self.rules.append(rule)
        return rule

    def drop(self, src: str = "*", dst: str = "*", method: str = "*",
             p: float = 0.01, start: int = 0,
             end: Optional[int] = None) -> _Rule:
        return self._add(_Rule("drop", src, dst, method, p=p,
                               start=start, end=end))

    def delay(self, src: str = "*", dst: str = "*", method: str = "*",
              p: float = 1.0, delay_s: float = 0.01, start: int = 0,
              end: Optional[int] = None) -> _Rule:
        return self._add(_Rule("delay", src, dst, method, p=p,
                               delay_s=delay_s, start=start, end=end))

    def duplicate(self, src: str = "*", dst: str = "*", method: str = "*",
                  p: float = 0.05, start: int = 0,
                  end: Optional[int] = None) -> _Rule:
        return self._add(_Rule("duplicate", src, dst, method, p=p,
                               start=start, end=end))

    def partition(self, src: str = "*", dst: str = "*") -> _Rule:
        """One-way cut src->dst (the reverse direction still flows);
        heal with `plan.heal(rule)`."""
        return self._add(_Rule("partition", src, dst, "*", p=1.0))

    def isolate(self, node: str,
                peers: Optional[List[str]] = None) -> List[_Rule]:
        """Two-way cut: `node` can neither reach nor be reached by each
        of `peers` (default: everyone). The building block for HA GCS
        partition scenarios — a minority-partitioned replica must stop
        winning elections, not just stop hearing the leader. Heal each
        returned rule to reconnect."""
        out: List[_Rule] = []
        for p in (list(peers) if peers else ["*"]):
            out.append(self.partition(node, p))
            out.append(self.partition(p, node))
        return out

    def heal(self, rule: _Rule) -> None:
        rule.active = False

    def crash_after(self, dst: str, n_messages: int, method: str = "*",
                    on_crash: Optional[Callable[[str], Any]] = None
                    ) -> _Rule:
        """Crash `dst` when it has received its `n_messages`th matching
        message. The callback receives dst (the fleet wires it to
        `kill_replica`); the triggering message is lost either way."""
        return self._add(_Rule("crash", "*", dst, method,
                               after_n=int(n_messages), on_crash=on_crash))

    # -- pure decision function ----------------------------------------
    def _roll(self, rule: _Rule, src: str, dst: str, n: int) -> float:
        # str seeds hash via sha512: stable across processes and runs
        # (unlike hash(), which is salted per interpreter).
        return random.Random(
            f"{self.seed}:{rule.idx}:{src}>{dst}:{n}").random()

    def decide(self, src: str, dst: str, method: str,
               n: int) -> List[FaultAction]:
        """The fault schedule for message `n` on edge src->dst — pure,
        no state consumed (crash rules excepted: they key on the dst's
        receive count, tracked by apply())."""
        out: List[FaultAction] = []
        for rule in self.rules:
            if rule.kind == "crash" or not rule.matches(src, dst, method, n):
                continue
            if rule.p < 1.0 and self._roll(rule, src, dst, n) >= rule.p:
                continue
            arg = rule.delay_s if rule.kind == "delay" else None
            out.append(FaultAction(rule.kind, src, dst, method, n, arg))
        return out

    def preview(self, src: str, dst: str, method: str,
                n_messages: int) -> List[FaultAction]:
        """The full deterministic schedule for one edge's first
        `n_messages` messages — what the determinism test compares
        across plans built from the same seed."""
        out: List[FaultAction] = []
        for n in range(n_messages):
            out.extend(self.decide(src, dst, method, n))
        return out

    # -- application ----------------------------------------------------
    def next_index(self, src: str, dst: str) -> int:
        edge = (src, dst)
        n = self._edge_counts.get(edge, 0)
        self._edge_counts[edge] = n + 1
        return n

    async def apply(self, src: str, dst: str, method: str) -> bool:
        """Consume one message on edge src->dst. Sleeps for delays,
        raises FaultInjected for drops/partitions/crash-triggering
        messages, returns True when the message should be DUPLICATED at
        the receiver. Called before delivery."""
        import asyncio

        n = self.next_index(src, dst)
        duplicate = False
        for act in self.decide(src, dst, method, n):
            self.log.append(act)
            if act.kind == "delay":
                await asyncio.sleep(act.arg)
            elif act.kind in ("drop", "partition"):
                raise FaultInjected(
                    f"fault[{act.kind}] {src}->{dst} {method} #{n}")
            elif act.kind == "duplicate":
                duplicate = True
        # Crash rules: keyed on the dst's matching-receive count, not the
        # pure per-edge index (a crash is a property of the target).
        for rule in self.rules:
            if rule.kind != "crash" or rule.fired:
                continue
            if not rule.matches(src, dst, method, n):
                continue
            count = rule._crash_counts.get(dst, 0) + 1
            rule._crash_counts[dst] = count
            if count >= rule.after_n:
                rule.fired = True
                act = FaultAction("crash", src, dst, method, n)
                self.log.append(act)
                if rule.on_crash is not None:
                    res = rule.on_crash(dst)
                    if asyncio.iscoroutine(res):
                        await res
                raise FaultInjected(
                    f"fault[crash] {dst} on msg #{count} ({method})")
        return duplicate

    def log_keys(self) -> List[Tuple]:
        return [a.key() for a in self.log]


# -- module-level hooks for a transport ------------------------------------
def install(plan: FaultPlan) -> None:
    """Make `plan` the process-wide plan a transport consults
    (`get_plan`). Process-local."""
    global enabled, _plan
    _plan = plan
    enabled = True


def uninstall() -> None:
    global enabled, _plan
    enabled = False
    _plan = None


def get_plan() -> Optional[FaultPlan]:
    return _plan
