"""Comet ML integration (reference:
``python/ray/air/integrations/comet.py`` — ``CometLoggerCallback``:
one Comet experiment per trial)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.callback import Callback, _scrub


def _require_comet():
    try:
        import comet_ml
        return comet_ml
    except ImportError as e:
        raise ImportError(
            "CometLoggerCallback needs the `comet_ml` package, which is not "
            "installed — install it to enable Comet tracking") from e


class CometLoggerCallback(Callback):
    def __init__(self, online: bool = True,
                 tags: Optional[List[str]] = None, **experiment_kwargs):
        self._comet = _require_comet()
        self.online = online
        self.tags = tags or []
        self.experiment_kwargs = experiment_kwargs
        self._experiments: Dict[str, Any] = {}

    def on_trial_start(self, iteration, trials, trial, **info):
        cls = (self._comet.Experiment if self.online
               else self._comet.OfflineExperiment)
        exp = cls(**self.experiment_kwargs)
        exp.set_name(trial.trial_name)
        exp.add_tags(self.tags)
        exp.log_parameters(trial.config)
        self._experiments[trial.trial_id] = exp

    def on_trial_result(self, iteration, trials, trial, result, **info):
        exp = self._experiments.get(trial.trial_id)
        if exp is None:
            return
        step = int(result.get("training_iteration", iteration))
        exp.log_metrics(
            {k: v for k, v in _scrub(result).items()
             if isinstance(v, (int, float))}, step=step)

    def on_trial_complete(self, iteration, trials, trial, **info):
        exp = self._experiments.pop(trial.trial_id, None)
        if exp is not None:
            exp.end()

    on_trial_error = on_trial_complete

    def on_experiment_end(self, trials, **info):
        for exp in self._experiments.values():
            try:
                exp.end()
            except Exception:
                pass
        self._experiments.clear()
