"""The ingress's admission gate, the in-flight cap of
`ray_tpu/serve/_private/proxy.py` that the LLM-serving bench uses. The
HTTP proxy itself, and its token-bucket rate limit, come with the Serve
slice."""

from __future__ import annotations

from typing import Optional


class _AdmissionGate:
    """Pre-queue overload gate: an in-flight cap that sheds with 503 (the
    system is saturated; retry against another ingress)."""

    def __init__(self, max_inflight: Optional[int] = None):
        self.max_inflight = max_inflight
        self.shed_503 = 0

    def check(self, inflight: int) -> Optional[str]:
        """None = admit; otherwise the shed status ("503")."""
        if self.max_inflight is not None \
                and inflight >= self.max_inflight:
            self.shed_503 += 1
            return "503"
        return None
