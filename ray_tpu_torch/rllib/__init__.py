"""ray_tpu_torch.rllib: reinforcement learning, the port of
``ray_tpu/rllib/`` (reference: ``rllib/``).

The learner stack: ``Algorithm`` (a Tune Trainable) drives parallel
``EnvRunner`` actors, whose policies run on the CPU, and a ``Learner`` /
``LearnerGroup`` whose update (the module's forward, the loss, the
backward, the global-norm clip and Adam) runs on the card. The on-policy
algorithms: PPO (the flagship), PG, IMPALA, APPO and multi-agent PPO,
with the rollout-to-train stream. The off-policy ones, over a replay
buffer and learners of their own on the card: DQN, SAC (discrete and
continuous), DDPG and TD3. Offline: the JSON reader and writer, BC,
MARWIL, CQL, and the off-policy estimators (IS, WIS, DM and DR over an
FQE model).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.connectors import (
    ClipObs, Connector, ConnectorPipeline, FlattenObs, FrameStack,
    NormalizeObs)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.env_runner import EnvRunner, compute_gae
from ray_tpu_torch.rllib.estimators import (
    DirectMethod, DoublyRobust, FQEModel, ImportanceSampling,
    WeightedImportanceSampling)
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
    MultiAgentPPOConfig)
from ray_tpu_torch.rllib.offline import (
    BC, BCConfig, JsonReader, JsonWriter, MARWIL, MARWILConfig)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec
from ray_tpu_torch.rllib.rollout_stream import (
    RandomEnv, RolloutBlockStream, block_uid, make_rollout_streams,
    rollout_stream)
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = [
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
    "DDPG",
    "DDPGConfig",
    "DQN",
    "DQNConfig",
    "DirectMethod",
    "DoublyRobust",
    "EnvRunner",
    "FQEModel",
    "FlattenObs",
    "FrameStack",
    "IMPALA",
    "IMPALAConfig",
    "ImportanceSampling",
    "JsonReader",
    "JsonWriter",
    "Learner",
    "LearnerGroup",
    "MARWIL",
    "MARWILConfig",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "NormalizeObs",
    "PG",
    "PGConfig",
    "PPO",
    "PPOConfig",
    "RLModule",
    "RLModuleSpec",
    "RandomEnv",
    "RolloutBlockStream",
    "SAC",
    "SACConfig",
    "TD3",
    "TD3Config",
    "WeightedImportanceSampling",
    "block_uid",
    "compute_gae",
    "make_rollout_streams",
    "rollout_stream",
]
