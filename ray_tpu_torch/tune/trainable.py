"""Trainable: the unit of execution Tune schedules, the class API of
``ray_tpu/tune/trainable.py`` (no device code), which rllib's
``Algorithm`` derives from. The function API (``FunctionTrainable``,
``report``, ``get_checkpoint``, ``with_parameters``) waits for the port
of ``tune/`` (ROADMAP Queue 1 item 11).

Reference: ``python/ray/tune/trainable/trainable.py`` — an actor with
``setup/step/save_checkpoint/load_checkpoint`` driven by repeated
``train()`` calls.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint

# Result-dict autofilled keys (reference ``tune/result.py``)
TRAINING_ITERATION = "training_iteration"
DONE = "done"
TRIAL_ID = "trial_id"


class Trainable:
    """Class API: subclass with setup/step/save/load (reference :239)."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}
        self._iteration = 0
        self.setup(self.config)

    # -- overridable ---------------------------------------------------
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def reset_config(self, new_config: Dict) -> bool:
        """Return True if the trainable supports in-place config swap
        (lets PBT exploit without actor teardown)."""
        return False

    def cleanup(self) -> None:
        pass

    # -- driver-facing -------------------------------------------------
    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> Dict:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        return result

    def save(self, checkpoint_dir: Optional[str] = None) -> Checkpoint:
        d = checkpoint_dir or tempfile.mkdtemp(prefix="tune_ckpt_")
        os.makedirs(d, exist_ok=True)
        out = self.save_checkpoint(d) or d
        return Checkpoint(out)

    def restore(self, checkpoint: Checkpoint) -> None:
        self.load_checkpoint(checkpoint.path)

    def reset(self, new_config: Dict) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
        return ok

    def stop(self) -> None:
        self.cleanup()
