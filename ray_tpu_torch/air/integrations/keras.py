"""Keras integration (reference:
``python/ray/air/integrations/keras.py`` — ``ReportCheckpointCallback``
reports metrics + checkpoints to the Train session at epoch end)."""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Union


def _keras_base():
    try:
        import keras
        return keras.callbacks.Callback
    except ImportError:
        try:
            from tensorflow import keras  # type: ignore
            return keras.callbacks.Callback
        except ImportError as e:
            raise ImportError(
                "ReportCheckpointCallback needs `keras` (or tensorflow), "
                "which is not installed") from e


def ReportCheckpointCallback(
        metrics: Optional[Union[str, List[str], Dict[str, str]]] = None,
        checkpoint_on: str = "epoch_end"):
    """Factory (class is built lazily so importing this module does not
    require keras)."""
    Base = _keras_base()

    class _ReportCheckpointCallback(Base):  # type: ignore[misc]
        def __init__(self):
            super().__init__()
            self._metrics = metrics

        def on_epoch_end(self, epoch, logs=None):
            from ray_tpu_torch.train import report
            from ray_tpu_torch.train._checkpoint import Checkpoint
            logs = logs or {}
            if isinstance(self._metrics, str):
                out = {self._metrics: logs.get(self._metrics)}
            elif isinstance(self._metrics, list):
                out = {m: logs.get(m) for m in self._metrics}
            elif isinstance(self._metrics, dict):
                out = {k: logs.get(v) for k, v in self._metrics.items()}
            else:
                out = dict(logs)
            ckpt = None
            if checkpoint_on == "epoch_end":
                d = tempfile.mkdtemp(prefix="keras_ckpt_")
                self.model.save(os.path.join(d, "model.keras"))
                ckpt = Checkpoint.from_directory(d)
            report(out, checkpoint=ckpt)

    return _ReportCheckpointCallback()
