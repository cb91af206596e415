"""MLflow integration (reference:
``python/ray/air/integrations/mlflow.py`` — ``MLflowLoggerCallback``
logs one MLflow run per trial; ``setup_mlflow`` configures the client
inside a worker)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.callback import Callback, _scrub


def _require_mlflow():
    try:
        import mlflow
        return mlflow
    except ImportError as e:
        raise ImportError(
            "MLflowLoggerCallback needs the `mlflow` package, which is not "
            "installed — install it to enable MLflow tracking") from e


class MLflowLoggerCallback(Callback):
    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: Optional[str] = None,
                 tags: Optional[Dict[str, Any]] = None,
                 save_artifact: bool = False):
        self._mlflow = _require_mlflow()
        if tracking_uri:
            self._mlflow.set_tracking_uri(tracking_uri)
        self.experiment_name = experiment_name
        self.tags = tags or {}
        self.save_artifact = save_artifact
        self._runs: Dict[str, Any] = {}
        self._client = None

    def setup(self, **info):
        self._client = self._mlflow.tracking.MlflowClient()
        exp = self._client.get_experiment_by_name(
            self.experiment_name) if self.experiment_name else None
        if exp is None and self.experiment_name:
            self._exp_id = self._client.create_experiment(
                self.experiment_name)
        elif exp is not None:
            self._exp_id = exp.experiment_id
        else:
            self._exp_id = "0"

    def on_trial_start(self, iteration, trials, trial, **info):
        run = self._client.create_run(
            experiment_id=self._exp_id,
            tags={**self.tags, "trial_name": trial.trial_name})
        self._runs[trial.trial_id] = run.info.run_id
        for k, v in trial.config.items():
            try:
                self._client.log_param(run.info.run_id, k, v)
            except Exception:
                pass

    def on_trial_result(self, iteration, trials, trial, result, **info):
        run_id = self._runs.get(trial.trial_id)
        if run_id is None:
            return
        step = int(result.get("training_iteration", iteration))
        for k, v in _scrub(result).items():
            if isinstance(v, (int, float)):
                self._client.log_metric(run_id, k.replace("/", "."),
                                        float(v), step=step)

    def on_trial_complete(self, iteration, trials, trial, **info):
        run_id = self._runs.pop(trial.trial_id, None)
        if run_id is not None:
            if self.save_artifact and getattr(trial, "checkpoint", None):
                try:
                    self._client.log_artifacts(
                        run_id, trial.checkpoint.path)
                except Exception:
                    pass
            self._client.set_terminated(run_id)

    def on_trial_error(self, iteration, trials, trial, **info):
        run_id = self._runs.pop(trial.trial_id, None)
        if run_id is not None:
            self._client.set_terminated(run_id, status="FAILED")


def setup_mlflow(config: Optional[Dict] = None,
                 tracking_uri: Optional[str] = None,
                 experiment_name: Optional[str] = None, **kwargs: Any):
    """Worker-side MLflow setup (reference ``setup_mlflow``)."""
    mlflow = _require_mlflow()
    if tracking_uri:
        mlflow.set_tracking_uri(tracking_uri)
    if experiment_name:
        mlflow.set_experiment(experiment_name)
    return mlflow
