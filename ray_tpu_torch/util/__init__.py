"""ray_tpu_torch.util — utility APIs layered on the core runtime, the port
of `ray_tpu/util/__init__.py` (placement groups and metrics; `collective`,
`to_jax` and `get_to_device` wait for the device data plane's slice).
"""

from ray_tpu_torch.util import metrics  # noqa: F401
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup, get_current_placement_group, gpu_gang_placement_group,
    placement_group, placement_group_table, remove_placement_group)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "get_current_placement_group",
    "gpu_gang_placement_group",
]
