"""Models of the port: the flagship decoder LM, dense or mixture of
experts, unsharded, sharded over a mesh, or pipelined; and the MLP."""

from ray_tpu_torch.models.transformer import (TransformerConfig, backbone,
                                              forward, forward_pipelined,
                                              init_params, lm_loss,
                                              lm_loss_pipelined,
                                              param_specs, params_from_jax,
                                              pipelined_param_specs,
                                              to_pipelined)
from ray_tpu_torch.models.mlp import MLPConfig, mlp_forward, mlp_init
from ray_tpu_torch.ops.moe import moe_ffn, top_k_gating

__all__ = ["TransformerConfig", "backbone", "forward", "forward_pipelined",
           "init_params", "lm_loss", "lm_loss_pipelined", "param_specs",
           "params_from_jax", "pipelined_param_specs", "to_pipelined",
           "moe_ffn", "top_k_gating", "MLPConfig", "mlp_init",
           "mlp_forward"]
