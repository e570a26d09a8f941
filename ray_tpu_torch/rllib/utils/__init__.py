"""RLlib utility libraries (reference: rllib/utils/), the port of
`ray_tpu/rllib/utils/`."""
