"""ray_tpu_torch.util — utility APIs layered on the core runtime, the port
of `ray_tpu/util/__init__.py` (placement groups, metrics, the eager
collectives, and the object-store-to-card bridge: `to_torch` in `to_jax`'s
place).
"""

from ray_tpu_torch.util import collective  # noqa: F401
from ray_tpu_torch.util import metrics  # noqa: F401
from ray_tpu_torch.util.device_arrays import (get_to_device,  # noqa: F401
                                              to_torch)
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
    "collective",
    "to_torch",
    "get_to_device",
]
