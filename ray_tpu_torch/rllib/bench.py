"""RLlib throughput benchmark, the port of `ray_tpu/rllib/bench.py`.

Runs the actor-based PPO stack (LearnerGroup + remote EnvRunners, weight
sync included) on CartPole-v1 and prints the median steady-state
env-steps/sec, the metric `PPO.train()` reports; `--image` runs IMPALA on
the synthetic 84x84x4 pixel env through the conv module instead.

    python -m ray_tpu_torch.rllib.bench [--image] [--device cpu|cuda]

`--device` is the learner's (default: the first CUDA card); the env
runners are CPU actors either way. CartPole needs gymnasium.
"""

from __future__ import annotations

import argparse
import functools


def main(device=None) -> None:
    import ray_tpu_torch
    from ray_tpu_torch.rllib import PPOConfig

    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = PPOConfig(num_env_runners=2, num_envs_per_runner=8,
                         rollout_fragment_length=64, num_epochs=4,
                         minibatch_size=256, device=device).build()
        try:
            algo.train()  # warmup: worker spawn
            rates = sorted(algo.train()["env_steps_per_sec"]
                           for _ in range(5))
            print(round(rates[len(rates) // 2], 1), flush=True)
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()


def main_image(device=None) -> None:
    """IMPALA on 84x84x4 image observations through the conv RLModule —
    the Atari-shaped pipeline, on the synthetic pixel env."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
    from ray_tpu_torch.rllib.env.synthetic_atari import SyntheticAtariEnv

    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = IMPALAConfig(
            env_creator=functools.partial(SyntheticAtariEnv, max_blocks=8),
            num_env_runners=2, num_envs_per_runner=2,
            rollout_fragment_length=16, train_batch_fragments=2,
            updates_per_iteration=6, device=device).build()
        try:
            algo.train()  # warmup: worker spawn
            rates = sorted(algo.train()["env_steps_per_sec"]
                           for _ in range(3))
            print(round(rates[len(rates) // 2], 1), flush=True)
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", action="store_true")
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    (main_image if args.image else main)(args.device)
