"""ray_tpu_torch.rllib: the parts of ``ray_tpu/rllib/`` that RLHF reads.

``LearnerGroup`` (local or data-parallel remote learners with host-side
gradient averaging) and the rollout-to-train stream's consume edge
(``RolloutBlockStream``, ``block_uid``). ``Learner`` (the RLModule
learner) raises until the rest of ``rllib/`` is ported (ROADMAP Queue 1
item 10), as do the env-runner streams, which are not here.
"""

from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rollout_stream import RolloutBlockStream, block_uid

__all__ = ["Learner", "LearnerGroup", "RolloutBlockStream", "block_uid"]
