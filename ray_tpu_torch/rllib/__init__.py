"""ray_tpu_torch.rllib — RL on the port's actor runtime, the port of
`ray_tpu/rllib/`.

Reference equivalent: `rllib/` new API stack (RLModule / Learner /
LearnerGroup / EnvRunner / Algorithm). This slice holds the on-policy PPO
family and the asynchronous IMPALA/APPO family with the modules both
stand on; the learners run on `cuda:0` unless their config's `device`
says otherwise, the env runners are CPU actors. DQN, the replay buffers,
the multi-agent env and multi-agent PPO (ROADMAP item 8b) raise on
access.
"""

from ray_tpu_torch.rllib.algorithms.impala import (APPO, APPOConfig, IMPALA,
                                                   IMPALAConfig)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.impala_learner import ImpalaLearner
from ray_tpu_torch.rllib.core.learner import PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.env.env_runner import (SingleAgentEnvRunner,
                                                compute_gae)

# The reference's names that wait for ROADMAP item 8b.
LATER = ("DQN", "DQNConfig", "DQNLearner", "ReplayBuffer",
         "PrioritizedReplayBuffer", "ReservoirReplayBuffer",
         "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
         "MultiAgentPPOConfig")


def __getattr__(name):
    if name in LATER:
        raise NotImplementedError(
            f"ray_tpu_torch.rllib.{name} comes with a later slice of the "
            f"port (ROADMAP item 8b: DQN, the replay buffers, the "
            f"multi-agent env and multi-agent PPO)")
    raise AttributeError(
        f"module 'ray_tpu_torch.rllib' has no attribute {name!r}")


__all__ = [
    "PPO", "PPOConfig", "PPOLearner", "LearnerGroup",
    "IMPALA", "IMPALAConfig", "APPO", "APPOConfig", "ImpalaLearner",
    "DiscreteMLPModule", "SingleAgentEnvRunner", "compute_gae",
]
