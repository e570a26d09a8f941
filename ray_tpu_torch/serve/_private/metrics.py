"""Serve data-plane instruments, one lazy singleton set per process: the
proxy's, router's and replica's (`serve_num_requests`, `serve_router_*`,
`serve_deployment_*`, `serve_replica_*`), the engine's (`serve_engine_*`,
`serve_prefix_*`) and the fleet's (`serve_fleet_*`) of
`ray_tpu/serve/_private/metrics.py`, with the reference's names and tags.

Instruments are created on first use so registration happens inside the
process that records them. A second construction of the same instrument
in one process would shadow the first in the registry, hence the cache.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

_LATENCY_BOUNDARIES = [0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0, 60.0]


def _component(name: str, build) -> Dict[str, Any]:
    """One dict of instruments per component per process, built once —
    these sit on the request hot path, so no per-call allocation."""
    from ray_tpu_torch.util.metrics import get_instruments

    return get_instruments(f"serve.{name}", build)


def proxy_metrics() -> Dict[str, Any]:
    """Ingress-edge instruments (the HTTP proxy)."""
    def build():
        from ray_tpu_torch.util.metrics import Counter, Histogram

        return {
            "requests": Counter(
                "serve_num_requests",
                "Requests received at a Serve ingress",
                tag_keys=("ingress", "route", "status")),
            "latency": Histogram(
                "serve_request_latency_seconds",
                "End-to-end request latency at the ingress",
                boundaries=_LATENCY_BOUNDARIES,
                tag_keys=("ingress", "route")),
        }

    return _component("proxy", build)


def router_metrics() -> Dict[str, Any]:
    """Routing-layer instruments (live in the handle owner's process)."""
    def build():
        from ray_tpu_torch.util.metrics import Counter, Gauge

        return {
            "assignments": Counter(
                "serve_router_requests",
                "Requests routed to a replica",
                tag_keys=("deployment",)),
            "queued": Gauge(
                "serve_deployment_queued_queries",
                "Requests waiting in the router for a replica",
                tag_keys=("deployment",)),
        }

    return _component("router", build)


_queued_lock = threading.Lock()
_queued_counts: Dict[str, int] = {}


def queued_delta(deployment: str, delta: int) -> None:
    """Process-wide queued-request accounting. The gauge is last-write-
    wins, and one process can hold several Routers for the same
    deployment (one per handle) — each setting its OWN backlog would
    clobber the others', so the count aggregates here and the gauge is
    set under the same lock."""
    with _queued_lock:
        n = max(0, _queued_counts.get(deployment, 0) + delta)
        if n:
            _queued_counts[deployment] = n
        else:
            _queued_counts.pop(deployment, None)
        try:
            router_metrics()["queued"].set(
                n, tags={"deployment": deployment})
        except Exception:
            pass  # metrics must never fail the data path


def replica_metrics() -> Dict[str, Any]:
    """Replica-side instruments (the user-code execution edge)."""
    def build():
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        return {
            "processed": Counter(
                "serve_deployment_processed_queries",
                "Requests a replica finished",
                tag_keys=("deployment", "replica", "status")),
            "latency": Histogram(
                "serve_deployment_processing_latency_seconds",
                "User-code processing latency on the replica",
                boundaries=_LATENCY_BOUNDARIES,
                tag_keys=("deployment", "replica")),
            "ongoing": Gauge(
                "serve_replica_ongoing_requests",
                "Requests currently executing on a replica",
                tag_keys=("deployment", "replica")),
        }

    return _component("replica", build)


def engine_metrics() -> Dict[str, Any]:
    """Continuous-batching engine + overload-shedding instruments
    (`serve_engine_*`). The engine gauges live in the process hosting the
    `InferenceEngine`; the shed counter belongs to the ingress (sheds
    happen BEFORE work is queued, so the ingress is the only place that
    can count them)."""
    def build():
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        return {
            "batch_occupancy": Gauge(
                "serve_engine_batch_occupancy",
                "Sequences in the engine's running decode batch"),
            "cache_utilization": Gauge(
                "serve_engine_cache_utilization",
                "Fraction of KV-cache blocks allocated"),
            "queue_depth": Gauge(
                "serve_engine_queue_depth",
                "Requests waiting for engine admission"),
            "preemptions": Counter(
                "serve_engine_preemptions",
                "Sequences preempted (blocks freed, requeued) under "
                "cache pressure"),
            "tokens": Counter(
                "serve_engine_tokens_generated",
                "Tokens generated across all sequences"),
            "prefix_hit_tokens": Counter(
                "serve_engine_prefix_hit_tokens",
                "Prompt tokens served from shared prefix blocks "
                "(adopted by reference, no prefill compute)"),
            "cow": Counter(
                "serve_engine_cow_copies",
                "Copy-on-write block copies (a write into a shared "
                "KV block privatized it first)"),
            "step_phase": Counter(
                "serve_engine_step_seconds",
                "Cumulative model time split by phase",
                # prefill | decode | kv_gather | model_step | kv_write
                # (the last three split the decode step — paged decode
                # collapses kv_gather to table padding)
                tag_keys=("phase",)),
            "kv_pool_bytes": Gauge(
                "serve_engine_kv_pool_bytes",
                "Preallocated KV block-pool size, tagged with where "
                "the pool lives (device: a torch tensor mutated in "
                "place; host: numpy)",
                tag_keys=("replica", "residency")),
            "jit_evictions": Counter(
                "serve_engine_jit_bucket_evictions",
                "Compiled shape buckets dropped by the engine model's "
                "LRU jit caches"),
            "shed": Counter(
                "serve_engine_shed_requests",
                "Requests shed at the ingress before queuing",
                tag_keys=("status",)),    # 429 | 503
            "ttft": Histogram(
                "serve_engine_time_to_first_token_seconds",
                "Submit-to-first-token latency",
                boundaries=_LATENCY_BOUNDARIES),
            # Per-replica radix-index state: what fleet digest
            # freshness is judged against. Gauges (state, last-write-
            # wins per replica tag), not counters — the engine's own
            # fields stay the source of truth.
            "prefix_nodes": Gauge(
                "serve_prefix_index_nodes",
                "Radix prefix-index nodes held by a replica's engine",
                tag_keys=("replica",)),
            "prefix_sealed": Gauge(
                "serve_prefix_sealed_blocks",
                "Sealed KV blocks pinned by a replica's prefix index",
                tag_keys=("replica",)),
            "prefix_hits_state": Gauge(
                "serve_prefix_hits",
                "Cumulative prefix-index admission hits on a replica",
                tag_keys=("replica",)),
            "prefix_evictions_state": Gauge(
                "serve_prefix_evictions",
                "Cumulative cold-prefix evictions on a replica",
                tag_keys=("replica",)),
        }

    return _component("engine", build)


def fleet_metrics() -> Dict[str, Any]:
    """Multi-replica fleet-layer instruments (`serve_fleet_*`): KV-aware
    routing outcomes, cross-replica prefix ships, and conversation
    recoveries. Live in the process hosting the fleet router."""
    def build():
        from ray_tpu_torch.util.metrics import Counter, Gauge

        return {
            "ships": Counter(
                "serve_fleet_prefix_ships",
                "Sealed prefix chains shipped between replicas "
                "(router-observed miss-with-remote-hit)"),
            "ship_tokens": Counter(
                "serve_fleet_prefix_ship_tokens",
                "Prompt tokens covered by shipped prefix chains"),
            "recoveries": Counter(
                "serve_fleet_conversation_recoveries",
                "Conversations requeued onto a survivor after replica "
                "death"),
            "route_prefix_hits": Counter(
                "serve_fleet_route_prefix_hits",
                "Requests routed to a replica because it held the "
                "longest cached prefix"),
            "route_sticky_hits": Counter(
                "serve_fleet_route_sticky_hits",
                "Requests kept on their session's replica"),
            "replicas_alive": Gauge(
                "serve_fleet_replicas_alive",
                "Live replicas behind the fleet router"),
        }

    return _component("fleet", build)
