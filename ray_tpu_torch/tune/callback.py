"""Tune callback API + built-in loggers.

Reference: ``python/ray/tune/callback.py`` (Callback hooks driven by
the trial loop) and ``tune/logger/`` (``CSVLoggerCallback``,
``JsonLoggerCallback``). The experiment-tracking adapters
(wandb/mlflow/comet) are in ``air/integrations/``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Hook points around the experiment loop. All optional."""

    def setup(self, stop=None, num_samples=None, **info) -> None:
        pass

    def on_trial_start(self, iteration: int, trials: List, trial,
                       **info) -> None:
        pass

    def on_trial_result(self, iteration: int, trials: List, trial,
                        result: Dict, **info) -> None:
        pass

    def on_trial_complete(self, iteration: int, trials: List, trial,
                          **info) -> None:
        pass

    def on_trial_error(self, iteration: int, trials: List, trial,
                       **info) -> None:
        pass

    def on_checkpoint(self, iteration: int, trials: List, trial,
                      checkpoint, **info) -> None:
        pass

    def on_experiment_end(self, trials: List, **info) -> None:
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self._cbs = list(callbacks or [])

    def __bool__(self):
        return bool(self._cbs)

    def fire(self, hook: str, *args, **kw) -> None:
        for cb in self._cbs:
            try:
                getattr(cb, hook)(*args, **kw)
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "callback %s.%s failed", type(cb).__name__, hook)


def _scrub(result: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten + drop non-scalar values for tabular sinks."""
    flat: Dict[str, Any] = {}

    def walk(prefix: str, obj: Any) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}{k}/" if isinstance(v, dict) else
                     f"{prefix}{k}", v)
        elif isinstance(obj, (int, float, str, bool)) or obj is None:
            flat[prefix.rstrip("/")] = obj

    walk("", result)
    return flat


class JsonLoggerCallback(Callback):
    """result.json per trial, one JSON line per result (reference:
    ``tune/logger/json.py``)."""

    def __init__(self):
        self._files: Dict[str, Any] = {}

    def _file(self, trial):
        f = self._files.get(trial.trial_id)
        if f is None:
            local_dir = getattr(trial, "local_dir", None)
            if not local_dir:
                return None
            os.makedirs(local_dir, exist_ok=True)
            f = self._files[trial.trial_id] = open(
                os.path.join(local_dir, "result.json"), "a")
        return f

    def on_trial_result(self, iteration, trials, trial, result, **info):
        f = self._file(trial)
        if f is None:
            return
        json.dump(_scrub(result), f, default=str)
        f.write("\n")
        f.flush()

    def on_experiment_end(self, trials, **info):
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass
        self._files.clear()


class CSVLoggerCallback(Callback):
    """progress.csv per trial (reference: ``tune/logger/csv.py``)."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def on_trial_result(self, iteration, trials, trial, result, **info):
        if not getattr(trial, "local_dir", None):
            return
        flat = _scrub(result)
        w = self._writers.get(trial.trial_id)
        if w is None:
            os.makedirs(trial.local_dir, exist_ok=True)
            f = open(os.path.join(trial.local_dir, "progress.csv"),
                     "w", newline="")
            w = csv.DictWriter(f, fieldnames=sorted(flat))
            w.writeheader()
            self._files[trial.trial_id] = f
            self._writers[trial.trial_id] = w
        w.writerow({k: flat.get(k) for k in w.fieldnames})
        self._files[trial.trial_id].flush()

    def on_experiment_end(self, trials, **info):
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass
        self._files.clear()
        self._writers.clear()
