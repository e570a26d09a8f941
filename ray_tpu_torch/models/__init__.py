"""Models of the port: the flagship decoder LM, dense or mixture of
experts."""

from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              init_params, lm_loss,
                                              params_from_jax)
from ray_tpu_torch.ops.moe import moe_ffn, top_k_gating

__all__ = ["TransformerConfig", "forward", "init_params", "lm_loss",
           "params_from_jax", "moe_ffn", "top_k_gating"]
