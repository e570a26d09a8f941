"""Models of the port: the flagship decoder LM (dense)."""

from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              init_params, lm_loss,
                                              params_from_jax)

__all__ = ["TransformerConfig", "forward", "init_params", "lm_loss",
           "params_from_jax"]
