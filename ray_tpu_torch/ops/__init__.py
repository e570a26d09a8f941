"""Tensor ops of the port: attention (plain and the flash kernel's
dispatch), rotary embeddings and mixture-of-experts."""

from ray_tpu_torch.ops.attention import (attention, flash_attention,
                                         plain_attention)
from ray_tpu_torch.ops.moe import moe_ffn, top_k_gating
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_freqs

__all__ = ["attention", "flash_attention", "plain_attention",
           "apply_rotary", "rotary_freqs", "moe_ffn", "top_k_gating"]
