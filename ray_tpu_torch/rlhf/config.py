"""RLHFConfig: one declarative knob set for the whole RLHF loop, the
port's copy of ``ray_tpu/rlhf/config.py``.

``placement`` names the Podracer split (arXiv:2104.06272):

- ``"anakin"`` — learners and rollout engines **colocated** on one TPU
  slice (SLICE_PACK): weight sync crosses shared memory, rollout and
  update phases time-share the chips. Best for small models / short
  rollouts where transfer dominates.
- ``"sebulba"`` — **disaggregated** fleets (SLICE_SPREAD): the rollout
  engines own their slice(s) and decode continuously while the learner
  slice trains; weight refresh ships over the int8 wire and lands
  between decode steps. Best when generation is the bottleneck.

Lowering is a one-line choice: :meth:`RLHFConfig.lower` returns an
:class:`RLHFPlacement` whose ``slice_strategy`` and groups name the slice
set the placement implies (one shared slice packed, separate rollout +
train slices spread), and whose ``reserve(slice_manager)`` acquires it
from any object with the slice manager's methods. ``learner_plan()``
gives the learner fleet's ``ParallelPlan`` (dp across learners).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

PLACEMENTS = ("anakin", "sebulba")


@dataclasses.dataclass(frozen=True)
class RLHFConfig:
    """Knobs of the closed PPO-RLHF loop (see README "RLHF").

    - ``placement``: Podracer split — ``"anakin"`` (colocated,
      SLICE_PACK) or ``"sebulba"`` (disaggregated, SLICE_SPREAD).
    - ``num_learners``: learner replicas; >= 2 activates the sharded
      streaming epoch (every learner trains as blocks arrive).
    - ``num_engines``: rollout engine replicas.
    - ``rollouts_per_round``: trajectories generated per PPO round.
    - ``max_new_tokens``: fixed trajectory length (uniform shapes keep
      the learner's jitted update at ONE compiled signature).
    - ``system_prompt``: shared prompt prefix every rollout request
      carries — exactly the high-hit-rate workload the radix-trie
      prefix cache serves (hit rate is asserted by the e2e).
    - ``prompt_len``: total prompt length (system + per-request
      suffix), fixed so trajectory batches concatenate.
    - ``max_weight_lag``: staleness bound — a new rollout request is
      admitted only while ``learner_version - engine_version <= lag``.
    - ``sync_every_updates``: publish fresh weights to the engines
      after every N learner rounds (in flight — decode never stops).
    - ``quant_block_size``: int8 wire block size for weight sync.
    """
    placement: str = "anakin"
    num_learners: int = 2
    num_engines: int = 1
    rollouts_per_round: int = 8
    max_new_tokens: int = 16
    system_prompt: Tuple[int, ...] = tuple(range(2, 50))
    prompt_len: int = 56
    max_weight_lag: int = 1
    sync_every_updates: int = 1
    quant_block_size: int = 256
    minibatch_size: int = 4
    num_epochs: int = 1
    learning_rate: float = 1e-3
    clip_eps: float = 0.2
    seed: int = 0
    model: Optional[Dict[str, Any]] = None
    engine: Optional[Dict[str, Any]] = None
    slice_type: str = "pod"

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, "
                f"got {self.placement!r}")
        if min(self.num_learners, self.num_engines,
               self.rollouts_per_round, self.max_new_tokens) < 1:
            raise ValueError(
                "num_learners/num_engines/rollouts_per_round/"
                f"max_new_tokens must be >= 1, got {self}")
        if self.max_weight_lag < 0:
            raise ValueError("max_weight_lag must be >= 0")
        if not self.system_prompt:
            raise ValueError(
                "system_prompt must be non-empty (the shared prefix is "
                "what the radix trie amortizes across rollouts)")
        if self.prompt_len < len(self.system_prompt) + 1:
            raise ValueError(
                f"prompt_len={self.prompt_len} must leave room for at "
                f"least one suffix token after the "
                f"{len(self.system_prompt)}-token system prompt")

    # ------------------------------------------------------- lowering
    @property
    def slice_strategy(self) -> str:
        """SLICE_PACK (anakin, colocated) / SLICE_SPREAD (sebulba)."""
        return "SLICE_PACK" if self.placement == "anakin" \
            else "SLICE_SPREAD"

    def learner_plan(self):
        """The learner fleet's ``ParallelPlan``: dp across learners,
        carrying this placement's slice strategy down to the gang
        scheduler."""
        from ray_tpu_torch.parallel.plan import ParallelPlan
        return ParallelPlan(dp=max(1, self.num_learners),
                            slice_strategy=self.slice_strategy)

    def lower(self) -> "RLHFPlacement":
        """Clusterless lowering: which slices the placement wants and
        how the fleets map onto them (reserve() makes it live)."""
        if self.placement == "anakin":
            groups = [{"role": "shared", "engines": self.num_engines,
                       "learners": self.num_learners}]
        else:
            groups = [{"role": "rollout", "engines": self.num_engines,
                       "learners": 0},
                      {"role": "train", "engines": 0,
                       "learners": self.num_learners}]
        return RLHFPlacement(placement=self.placement,
                             slice_strategy=self.slice_strategy,
                             slice_type=self.slice_type,
                             groups=groups)

    def engine_config(self) -> Dict[str, Any]:
        """Engine knob dict with the RLHF invariants folded in:
        logprob capture on (the rollout payload), prefix sharing on
        (the system prompt is the whole point), speculation off
        (incompatible with capture), window sized to fit prompt +
        trajectory."""
        ec = dict(self.engine or {})
        ec["capture_logprobs"] = True
        ec["spec_tokens"] = 0
        ec.setdefault("enable_prefix_sharing", True)
        need = self.prompt_len + self.max_new_tokens + 2
        if ec.get("max_seq_len", 0) < need:
            ec["max_seq_len"] = need
        ec.setdefault("max_new_tokens", self.max_new_tokens)
        return ec

    def model_config(self) -> Dict[str, Any]:
        m = dict(self.model or {})
        m.setdefault("dtype", "float32")
        return m


@dataclasses.dataclass
class RLHFPlacement:
    """A lowered placement: one bundle group per slice the placement
    wants. ``reserve`` acquires them through a live ``SliceManager``
    (all-or-nothing: a partial acquisition is rolled back so a
    half-placed loop never runs split-brain); clusterless callers just
    read ``groups``/``slice_strategy``."""
    placement: str
    slice_strategy: str
    slice_type: str
    groups: List[Dict[str, Any]]
    slice_ids: List[str] = dataclasses.field(default_factory=list)

    @property
    def num_slices(self) -> int:
        return len(self.groups)

    def reserve(self, slice_manager, timeout_s: float = 60.0
                ) -> List[str]:
        acquired: List[str] = []
        for g in self.groups:
            sid = slice_manager.acquire_slice(self.slice_type)
            if sid is None or not slice_manager.wait_until_up(
                    sid, timeout_s=timeout_s):
                for s in acquired:
                    try:
                        slice_manager.drain_slice(
                            s, reason="rlhf placement rollback")
                    except Exception:
                        pass
                raise RuntimeError(
                    f"could not reserve {self.num_slices} "
                    f"{self.slice_type!r} slice(s) for the "
                    f"{self.placement!r} placement")
            g["slice_id"] = sid
            acquired.append(sid)
        self.slice_ids = acquired
        return acquired

    def release(self, slice_manager) -> None:
        for sid in self.slice_ids:
            try:
                slice_manager.drain_slice(sid, reason="rlhf shutdown")
            except Exception:
                pass
        self.slice_ids = []
