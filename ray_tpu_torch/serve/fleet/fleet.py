"""Multi-replica serving fleet: KV-aware routing, prefix shipping,
conversation recovery (the port of `ray_tpu/serve/fleet/fleet.py`).

`ServeFleet` owns N `InferenceEngine` replicas (the same in-process
hosting shape as `perf.run_llm_serve_bench`) plus a `FleetRouter`, and
stitches the three pieces together on the request path:

- **route**: the router matches the prompt's chain hashes against each
  replica's published digest and picks sticky-session > longest-cached-
  prefix > least-loaded (`router.FleetRouter`).
- **ship**: when the chosen replica's cached match is shorter than the
  fleet-wide best by at least one sealed block (miss-with-remote-hit),
  the holder's chain is exported, blob-framed, and adopted on the
  chosen replica BEFORE the request is submitted — so the prefill that
  follows hits locally (`shipping.ship_prefix`).
- **recover**: a replica killed mid-decode fails its pumps with
  `EngineStoppedError` (or a seeded `FaultInjected` on the token edge);
  the fleet requeues every conversation it owned on a survivor,
  resubmitting `prompt + delivered tail` so the survivor re-prefills
  through its radix index and continues the generation. TinyLM is
  deterministic (next token is a pure function of the full history), so
  its recovered stream is token-for-token identical to a no-fault run;
  a transformer's survivor re-prefills the delivered tail where the dead
  replica had decoded it, so its logits agree to rounding, and a token
  can differ only where two logits tie within it.

Fault injection rides `core/faults.py` on three logical edges —
`("router", rid, "submit")`, `("router", rid, "token")` (the router's
per-token stream credit: dropping it loses that token on the wire;
`crash_after(rid, n, "token")` kills the replica mid-decode on its nth
token), and `(src_rid, dst_rid, "ship_prefix")` — so kill schedules are
seeded and replayable. With no plan (`fault_plan=None`) the hook costs
one attribute test.

Deadlock note: `kill_replica` may be invoked from INSIDE a pump thread
(a `crash_after` rule's `on_crash` fires inside `plan.apply` on that
pump's token edge). Migration therefore never runs synchronously in
`kill_replica`: it marks the replica dead, stops the engine, and hands
the owned conversations to a daemon migration thread that first waits
for each conversation's pump to unwind (`_pump_done`) — the dying pump
sets its event and exits before the migration touches the conversation.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from ray_tpu_torch.core.faults import FaultInjected, FaultPlan
from ray_tpu_torch.serve.engine.scheduler import (EngineConfig,
                                            EngineOverloadedError,
                                            EngineStoppedError,
                                            InferenceEngine, TokenStream)
from ray_tpu_torch.serve.fleet.digest import ReplicaDigest
from ray_tpu_torch.serve.fleet.router import FleetRouter, NoReplicasError
from ray_tpu_torch.serve.fleet.shipping import ship_prefix

__all__ = ["FleetConfig", "FleetReplica", "Conversation", "ServeFleet"]


@dataclass
class FleetConfig:
    model_factory: Callable[[], Any] = None  # one model per replica
    num_replicas: int = 3
    engine_config: EngineConfig = field(default_factory=EngineConfig)
    shipping: bool = True            # cross-replica prefix shipping
    kv_routing: bool = True          # False: pure least-loaded (bench)
    digest_max_age_s: float = 0.2    # scrape-path staleness bound
    fault_plan: Optional[FaultPlan] = None


class FleetReplica:
    """One engine plus its router-facing surface: liveness and a
    digest cache refreshed at most every `digest_max_age_s` (standing in
    for the metrics-scrape cadence a remote router would see)."""

    def __init__(self, rid: str, engine: InferenceEngine,
                 digest_max_age_s: float):
        self.rid = rid
        self.engine = engine
        self.alive = True
        self._max_age = digest_max_age_s
        self._digest: Optional[ReplicaDigest] = None
        self._dlock = threading.Lock()

    def digest(self) -> ReplicaDigest:
        with self._dlock:
            if (self._digest is None
                    or self._digest.age_s() > self._max_age):
                self._digest = ReplicaDigest.from_engine(self.engine)
            return self._digest

    def invalidate_digest(self) -> None:
        """Force the next route to see fresh state (called after this
        replica adopts a shipped chain — the whole point of the ship is
        that the NEXT request can route here warm)."""
        with self._dlock:
            self._digest = None


class Conversation:
    """One logical generation stream, surviving replica death. The
    fleet-level `stream` only ever sees delivered tokens; a token the
    fault plan eats on the wire is re-generated by the survivor (the
    deterministic model makes the regenerated token identical)."""

    __slots__ = ("conv_id", "session_id", "prompt", "max_new",
                 "delivered", "owner", "done", "error", "stream",
                 "shipped", "recoveries", "submitted_at",
                 "first_token_at", "recovered_token_at", "_pump_done")

    def __init__(self, conv_id: str, prompt: List[int], max_new: int,
                 session_id: Optional[str]):
        self.conv_id = conv_id
        self.session_id = session_id
        self.prompt = prompt
        self.max_new = max_new
        self.delivered: List[int] = []
        self.owner: Optional[str] = None
        self.done = False
        self.error: Optional[BaseException] = None
        self.stream = TokenStream(conv_id)
        self.shipped = False            # a prefix ship preceded dispatch
        self.recoveries = 0
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.recovered_token_at: Optional[float] = None  # first post-death
        # Set whenever no pump thread is running for this conversation;
        # migration waits on it before touching the conversation.
        self._pump_done = threading.Event()
        self._pump_done.set()


class ServeFleet:
    def __init__(self, config: FleetConfig):
        if config.model_factory is None:
            raise ValueError("FleetConfig.model_factory is required")
        self.config = config
        self.router = FleetRouter(config.engine_config.block_size,
                                  kv_routing=config.kv_routing)
        self._replicas: Dict[str, FleetReplica] = {}
        for i in range(config.num_replicas):
            rid = f"replica-{i}"
            eng = InferenceEngine(
                config.model_factory(),
                replace(config.engine_config, replica_tag=rid))
            rep = FleetReplica(rid, eng, config.digest_max_age_s)
            self._replicas[rid] = rep
            self.router.register(rid, rep)
        self._lock = threading.Lock()
        self._dead: Set[str] = set()
        self._conversations: Dict[str, Conversation] = {}
        self._ids = 0
        self._migrators: List[threading.Thread] = []
        self.prefix_ships = 0
        self.prefix_ship_tokens = 0
        self.recoveries = 0
        self.lost_conversations = 0
        self._push_alive_gauge()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        for rep in self._replicas.values():
            if rep.alive:
                rep.engine.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        for t in list(self._migrators):
            t.join(timeout=timeout_s)
        for rep in self._replicas.values():
            rep.engine.stop(timeout_s)

    def replica(self, rid: str) -> FleetReplica:
        return self._replicas[rid]

    def live_replicas(self) -> List[str]:
        with self._lock:
            return [r for r, rep in self._replicas.items() if rep.alive]

    # -- fault hook ------------------------------------------------------
    def _fault(self, src: str, dst: str, method: str) -> None:
        plan = self.config.fault_plan
        if plan is None:
            return
        import asyncio

        asyncio.run(plan.apply(src, dst, method))

    # -- submission ------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               session_id: Optional[str] = None) -> Conversation:
        """Route, (maybe) ship, submit, pump. Returns the Conversation;
        consume `conv.stream` for tokens — it survives replica death."""
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError("empty prompt")
        max_new = (self.config.engine_config.max_new_tokens_default
                   if max_new_tokens is None else int(max_new_tokens))
        with self._lock:
            conv_id = f"conv-{self._ids}"
            self._ids += 1
            conv = Conversation(conv_id, prompt, max_new, session_id)
            self._conversations[conv_id] = conv
        self._dispatch(conv, exclude=tuple(self._dead))
        return conv

    def _dispatch(self, conv: Conversation,
                  exclude: Sequence[str] = ()) -> None:
        """Place a conversation (fresh or recovered) on a live replica.
        A replica that dies or faults during placement is excluded and
        the route re-runs; overloaded replicas are tried in turn and the
        overload only propagates when EVERY live replica sheds."""
        excluded = set(exclude)
        overload: Optional[EngineOverloadedError] = None
        while True:
            try:
                decision = self.router.route(conv.prompt,
                                             conv.session_id,
                                             exclude=tuple(excluded))
            except NoReplicasError:
                if overload is not None:
                    raise overload
                self._lose(conv, NoReplicasError(
                    "no live fleet replicas"))
                return
            rid = decision.rid
            rep = self._replicas[rid]
            try:
                self._maybe_ship(conv, decision)
                self._fault("router", rid, "submit")
                tokens = conv.prompt + conv.delivered
                remaining = conv.max_new - len(conv.delivered)
                stream = rep.engine.submit(tokens, remaining)
            except EngineOverloadedError as e:
                overload = e
                excluded.add(rid)
                continue
            except (FaultInjected, EngineStoppedError):
                self._handle_death(rid)
                excluded.add(rid)
                continue
            with self._lock:
                conv.owner = rid
                conv._pump_done = threading.Event()
            self.router.begin(rid)
            t = threading.Thread(
                target=self._pump, args=(conv, rid, stream),
                daemon=True, name=f"fleet-pump-{conv.conv_id}")
            t.start()
            return

    def _maybe_ship(self, conv: Conversation, decision) -> None:
        """Miss-with-remote-hit: the chosen replica's cached match is at
        least one sealed block behind the best holder's — move the
        blocks to the request instead of the request to the blocks."""
        if not self.config.shipping:
            return
        bs = self.config.engine_config.block_size
        if (decision.best_rid is None
                or decision.best_rid == decision.rid
                or decision.best_match_tokens
                - decision.match_tokens < bs):
            return
        src = self._replicas.get(decision.best_rid)
        dst = self._replicas[decision.rid]
        if src is None or not src.alive:
            return
        try:
            self._fault(decision.best_rid, decision.rid, "ship_prefix")
            shipped = ship_prefix(src.engine, dst.engine, conv.prompt)
        except (FaultInjected, EngineStoppedError):
            return   # best-effort: the request just prefills cold
        if shipped > 0:
            conv.shipped = True
            dst.invalidate_digest()
            with self._lock:
                self.prefix_ships += 1
                self.prefix_ship_tokens += shipped
            self._bump_fleet_counter("ships", 1)
            self._bump_fleet_counter("ship_tokens", shipped)

    # -- the pump --------------------------------------------------------
    def _pump(self, conv: Conversation, rid: str,
              stream: TokenStream) -> None:
        try:
            for tok in stream:
                # Per-token stream credit INTO the replica: the edge
                # crash_after rules target to kill a replica on its nth
                # decoded token. A drop here loses the token before
                # delivery — the survivor regenerates it.
                self._fault("router", rid, "token")
                with self._lock:
                    conv.delivered.append(int(tok))
                if conv.first_token_at is None:
                    conv.first_token_at = time.perf_counter()
                if (conv.recoveries and
                        conv.recovered_token_at is None):
                    conv.recovered_token_at = time.perf_counter()
                conv.stream._push(int(tok))
            self._finish(conv)
        except (FaultInjected, EngineStoppedError):
            # The owner died under us (seeded token-edge fault or the
            # engine's stop sweep). Unwind FIRST — the migration thread
            # waits on _pump_done — then make sure the death is being
            # handled (idempotent when the fault's on_crash already did).
            conv._pump_done.set()
            self._handle_death(rid)
        except Exception as e:  # noqa: BLE001 — fail the one stream
            self._lose(conv, e)
        finally:
            conv._pump_done.set()

    def _finish(self, conv: Conversation) -> None:
        with self._lock:
            if conv.done:
                return
            conv.done = True
            owner = conv.owner
        if owner is not None:
            self.router.complete(owner)
        conv.stream._finish()

    def _lose(self, conv: Conversation, error: BaseException) -> None:
        with self._lock:
            if conv.done:
                return
            conv.done = True
            conv.error = error
            self.lost_conversations += 1
            owner = conv.owner
        if owner is not None:
            self.router.complete(owner)
        conv.stream._finish(error)

    # -- death and recovery ----------------------------------------------
    def kill_replica(self, rid: str) -> None:
        """Simulated SIGKILL (also the `on_crash` callback for seeded
        crash rules): the engine stops mid-decode, in-flight streams
        fail, and the fleet migrates every conversation the replica
        owned. Never migrates synchronously — see the module docstring."""
        self._handle_death(rid)

    def _handle_death(self, rid: str) -> None:
        with self._lock:
            if rid in self._dead or rid not in self._replicas:
                return
            self._dead.add(rid)
            rep = self._replicas[rid]
            rep.alive = False
            owned = [c for c in self._conversations.values()
                     if c.owner == rid and not c.done]
        rep.engine.stop(1.0)
        self.router.drop_replica(rid)
        self._push_alive_gauge()
        t = threading.Thread(target=self._migrate_owned,
                             args=(rid, owned), daemon=True,
                             name=f"fleet-migrate-{rid}")
        with self._lock:
            self._migrators.append(t)
        t.start()

    def _migrate_owned(self, rid: str,
                       owned: List[Conversation]) -> None:
        eos = None
        for rep in self._replicas.values():
            eos = getattr(rep.engine.model, "eos_token", None)
            break
        for conv in owned:
            with self._lock:
                ev = conv._pump_done
            ev.wait(timeout=10.0)
            with self._lock:
                if conv.done:
                    continue   # finished during its own migration
                remaining = conv.max_new - len(conv.delivered)
                hit_eos = (eos is not None and conv.delivered
                           and conv.delivered[-1] == eos)
            if remaining <= 0 or hit_eos:
                # Nothing left to generate: the death raced the final
                # token's retirement — close the stream, no re-dispatch.
                self._finish(conv)
                continue
            with self._lock:
                conv.recoveries += 1
                self.recoveries += 1
                dead = tuple(self._dead)
            self._bump_fleet_counter("recoveries", 1)
            try:
                self._dispatch(conv, exclude=dead)
            except EngineOverloadedError as e:
                self._lose(conv, e)

    # -- observability ---------------------------------------------------
    def _bump_fleet_counter(self, key: str, n: float) -> None:
        try:
            from ray_tpu_torch.serve._private.metrics import fleet_metrics

            fleet_metrics()[key].inc(n)
        except Exception:
            pass  # metrics must never fail the data path

    def _push_alive_gauge(self) -> None:
        try:
            from ray_tpu_torch.serve._private.metrics import fleet_metrics

            fleet_metrics()["replicas_alive"].set(
                float(len(self.live_replicas())))
        except Exception:
            pass

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every conversation is done (tests / benches)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if all(c.done for c in self._conversations.values()):
                    return True
            time.sleep(0.005)
        return False

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            convs = list(self._conversations.values())
            out = {
                "replicas": {
                    rid: {"alive": rep.alive}
                    for rid, rep in self._replicas.items()
                },
                "conversations": len(convs),
                "done": sum(1 for c in convs if c.done),
                "recoveries": self.recoveries,
                "lost_conversations": self.lost_conversations,
                "prefix_ships": self.prefix_ships,
                "prefix_ship_tokens": self.prefix_ship_tokens,
            }
        for rid, rep in self._replicas.items():
            out["replicas"][rid]["engine"] = rep.engine.stats()
        out["router"] = self.router.stats()
        return out
