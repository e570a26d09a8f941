"""ray_tpu_torch.rllib — RL on the port's actor runtime, the port of
`ray_tpu/rllib/`.

Reference equivalent: `rllib/` new API stack (RLModule / Learner /
LearnerGroup / EnvRunner / Algorithm): the on-policy PPO family, the
asynchronous IMPALA/APPO family, DQN with its replay buffers, and
multi-agent PPO over dict-keyed environments. The learners run on
`cuda:0` unless their config's `device` says otherwise; the env runners
are CPU actors.
"""

from ray_tpu_torch.rllib.algorithms.dqn import (DQN, DQNConfig, DQNLearner,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.algorithms.impala import (APPO, APPOConfig, IMPALA,
                                                   IMPALAConfig)
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO, MultiAgentPPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.impala_learner import ImpalaLearner
from ray_tpu_torch.rllib.core.learner import PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.env.env_runner import (SingleAgentEnvRunner,
                                                compute_gae)
from ray_tpu_torch.rllib.env.multi_agent_env import (MultiAgentEnv,
                                                     MultiAgentEnvRunner)
from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer, ReservoirReplayBuffer)

__all__ = [
    "PPO", "PPOConfig", "PPOLearner", "LearnerGroup",
    "IMPALA", "IMPALAConfig", "APPO", "APPOConfig", "ImpalaLearner",
    "DQN", "DQNConfig", "DQNLearner", "ReplayBuffer",
    "PrioritizedReplayBuffer", "ReservoirReplayBuffer",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "DiscreteMLPModule", "SingleAgentEnvRunner", "compute_gae",
]
