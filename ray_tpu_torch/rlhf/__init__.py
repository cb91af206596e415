"""RLHF in the port: the copy of ``ray_tpu/rlhf/`` over the port's engine
and learners (serve-engine rollouts on the paged kernel, a PPO learner on
the flash kernels, multi-learner streams, in-flight int8 weight sync).

- :mod:`ray_tpu_torch.rlhf.config` — ``RLHFConfig`` names the Podracer
  placement (``anakin`` colocated / ``sebulba`` disaggregated,
  arXiv:2104.06272) and lowers it to slice groups and the learners'
  ``ParallelPlan`` (``learner_plan``).
- :mod:`ray_tpu_torch.rlhf.rollout` — the serving engine as the PPO
  rollout backend: shared-system-prompt requests ride the radix-trie
  prefix cache, completions stream back as trajectory blocks carrying
  ``(token, policy_version, logprob)``.
- :mod:`ray_tpu_torch.rlhf.weight_sync` — learner-to-engine parameter
  refresh over the int8 blockwise wire, staged between decode steps
  by a pointer swap: decode never drains.
- :mod:`ray_tpu_torch.rlhf.trainer` — ``RLHFTrainer`` closes the loop:
  rollout rounds feed a multi-learner ``LearnerGroup`` through sharded
  streaming epoch-1 updates, with weights republished in flight under
  a ``max_weight_lag`` staleness bound on rollout admission.
"""

from ray_tpu_torch.rlhf.config import RLHFConfig, RLHFPlacement
from ray_tpu_torch.rlhf.rollout import (LocalBlockStream, RolloutEngine,
                                        make_rlhf_rollout_streams,
                                        rlhf_rollout_blocks)
from ray_tpu_torch.rlhf.trainer import PolicyLearner, RLHFTrainer
from ray_tpu_torch.rlhf.weight_sync import (WeightPublisher, pack_weights,
                                            packed_wire_bytes,
                                            unpack_weights)

__all__ = [
    "RLHFConfig", "RLHFPlacement", "RolloutEngine", "LocalBlockStream",
    "rlhf_rollout_blocks", "make_rlhf_rollout_streams", "RLHFTrainer",
    "PolicyLearner", "WeightPublisher", "pack_weights",
    "unpack_weights", "packed_wire_bytes",
]
