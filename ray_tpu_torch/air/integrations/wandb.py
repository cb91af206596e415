"""Weights & Biases integration (reference:
``python/ray/air/integrations/wandb.py`` — ``WandbLoggerCallback``
creates one wandb run per trial and streams scrubbed results;
``setup_wandb`` initializes a run inside a Train/Tune worker)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.callback import Callback, _scrub


def _require_wandb():
    try:
        import wandb
        return wandb
    except ImportError as e:
        raise ImportError(
            "WandbLoggerCallback needs the `wandb` package, which is not "
            "installed — install it to enable W&B tracking") from e


class WandbLoggerCallback(Callback):
    """One wandb run per trial; results stream as wandb.log rows."""

    def __init__(self, project: Optional[str] = None,
                 group: Optional[str] = None,
                 api_key: Optional[str] = None,
                 excludes: Optional[List[str]] = None,
                 log_config: bool = False, **kwargs: Any):
        self._wandb = _require_wandb()
        if api_key:
            self._wandb.login(key=api_key)
        self.project = project
        self.group = group
        self.excludes = set(excludes or ())
        self.log_config = log_config
        self.kwargs = kwargs
        self._runs: Dict[str, Any] = {}

    def on_trial_start(self, iteration, trials, trial, **info):
        self._runs[trial.trial_id] = self._wandb.init(
            project=self.project, group=self.group,
            name=trial.trial_name, reinit=True,
            config=trial.config if self.log_config else None,
            **self.kwargs)

    def on_trial_result(self, iteration, trials, trial, result, **info):
        run = self._runs.get(trial.trial_id)
        if run is None:
            return
        flat = {k: v for k, v in _scrub(result).items()
                if k not in self.excludes
                and isinstance(v, (int, float))}
        run.log(flat)

    def on_trial_complete(self, iteration, trials, trial, **info):
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish()

    on_trial_error = on_trial_complete

    def on_experiment_end(self, trials, **info):
        for run in self._runs.values():
            try:
                run.finish()
            except Exception:
                pass
        self._runs.clear()


def setup_wandb(config: Optional[Dict] = None, **kwargs: Any):
    """Worker-side init (reference ``setup_wandb``): call from inside a
    train loop to get a wandb run bound to this trial."""
    wandb = _require_wandb()
    from ray_tpu_torch.train._internal.session import get_session
    session = get_session()
    trial_name = getattr(session, "trial_name", None) if session else None
    return wandb.init(name=trial_name, config=config, **kwargs)
