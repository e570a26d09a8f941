"""Serve configuration dataclasses.

Reference equivalent: `python/ray/serve/config.py` (DeploymentConfig,
AutoscalingConfig, HTTPOptions) — the subset that drives the controller's
reconciliation and the autoscaling policy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-length autoscaling (reference:
    `serve/_private/autoscaling_policy.py:12` + serve/config.py
    AutoscalingConfig): desired = ceil(total ongoing / target per
    replica), smoothed by up/downscale delays."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.25


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    version: Optional[str] = None
    health_check_period_s: float = 2.0
    graceful_shutdown_timeout_s: float = 20.0


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    # Admission control / load shedding at the ingress (reference:
    # serve's request_timeout + the Orca/vLLM-era practice of shedding
    # BEFORE queuing so p99 under overload stays bounded):
    # - max_inflight_requests: hard cap on concurrently-dispatched
    #   requests; beyond it the proxy answers 503 immediately (queue
    #   depth IS the overload signal — work is never buffered).
    # - admission_rate_limit/admission_burst: token bucket (requests/s,
    #   bucket size); exceeding it answers 429. None disables a gate.
    max_inflight_requests: Optional[int] = None
    admission_rate_limit: Optional[float] = None
    admission_burst: int = 16
