"""Multi-replica serving fleet, the port of `ray_tpu.serve.fleet`.

KV-cache-aware routing over published prefix digests, cross-replica
shipping of sealed KV blocks (array-native wire frames, never pickled),
and conversation recovery across replica death — the serving control
layer that makes N engines behave like one warm cache.
"""

from ray_tpu_torch.serve.fleet.digest import ReplicaDigest, prompt_chain_hashes
from ray_tpu_torch.serve.fleet.fleet import (Conversation, FleetConfig,
                                       FleetReplica, ServeFleet)
from ray_tpu_torch.serve.fleet.router import (FleetRouter, NoReplicasError,
                                        RouteDecision)
from ray_tpu_torch.serve.fleet.shipping import (decode_prefix_frames,
                                          encode_prefix_frames,
                                          ship_prefix)

__all__ = [
    "Conversation",
    "FleetConfig",
    "FleetReplica",
    "FleetRouter",
    "NoReplicasError",
    "ReplicaDigest",
    "RouteDecision",
    "ServeFleet",
    "decode_prefix_frames",
    "encode_prefix_frames",
    "prompt_chain_hashes",
    "ship_prefix",
]
