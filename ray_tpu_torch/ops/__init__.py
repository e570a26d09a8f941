"""Tensor ops of the port: attention (plain and the flash kernel's
dispatch) and rotary embeddings."""

from ray_tpu_torch.ops.attention import (attention, flash_attention,
                                         plain_attention)
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs

__all__ = ["attention", "flash_attention", "plain_attention",
           "apply_rotary", "rotary_freqs"]
