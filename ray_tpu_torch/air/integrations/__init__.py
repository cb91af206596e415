"""Experiment-tracking integrations (reference:
``python/ray/air/integrations/`` — wandb/mlflow/comet/keras Tune
callback adapters). Each adapter import-gates on its tracking library:
where the package is not installed, construction raises a clear error
naming it. None of them imports JAX; ``keras.py`` is backend-agnostic
(``KERAS_BACKEND=torch`` runs it on PyTorch)."""
