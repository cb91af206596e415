"""ray_tpu_torch.rllib: reinforcement learning, the port of
``ray_tpu/rllib/`` (reference: ``rllib/``).

The learner stack: ``Algorithm`` (a Tune Trainable) drives parallel
``EnvRunner`` actors, whose policies run on the CPU, and a ``Learner`` /
``LearnerGroup`` whose update (the module's forward, the loss, the
backward, the global-norm clip and Adam) runs on the card. The on-policy
algorithms are ported: PPO (the flagship), PG, IMPALA, APPO and
multi-agent PPO, with the rollout-to-train stream. DQN, SAC, DDPG/TD3,
CQL, BC/MARWIL, the offline reader and writer and the off-policy
estimators wait for the next slice (ROADMAP Queue 1 item 10); their
names raise on access.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.connectors import (
    ClipObs, Connector, ConnectorPipeline, FlattenObs, FrameStack,
    NormalizeObs)
from ray_tpu_torch.rllib.env_runner import EnvRunner, compute_gae
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
    MultiAgentPPOConfig)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec
from ray_tpu_torch.rllib.rollout_stream import (
    RandomEnv, RolloutBlockStream, block_uid, make_rollout_streams,
    rollout_stream)

#: names of the JAX package's ``rllib`` whose modules wait for the next
#: slice (ROADMAP Queue 1 item 10), with the module of each
_LATER = {"DQN": "dqn", "DQNConfig": "dqn", "SAC": "sac",
          "SACConfig": "sac", "DDPG": "ddpg", "DDPGConfig": "ddpg",
          "TD3": "ddpg", "TD3Config": "ddpg", "CQL": "cql",
          "CQLConfig": "cql", "BC": "offline", "BCConfig": "offline",
          "MARWIL": "offline", "MARWILConfig": "offline",
          "JsonReader": "offline", "JsonWriter": "offline",
          "DirectMethod": "estimators", "DoublyRobust": "estimators",
          "FQEModel": "estimators", "ImportanceSampling": "estimators",
          "WeightedImportanceSampling": "estimators"}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"rllib.{name} waits for the port of rllib/{_LATER[name]}.py "
            f"(ROADMAP Queue 1 item 10)")
    raise AttributeError(name)


__all__ = [
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
    "EnvRunner",
    "FlattenObs",
    "FrameStack",
    "IMPALA",
    "IMPALAConfig",
    "Learner",
    "LearnerGroup",
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
    "block_uid",
    "compute_gae",
    "make_rollout_streams",
    "rollout_stream",
]
