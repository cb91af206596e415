"""``ray_tpu_torch.air.integrations`` on the CPU. The wandb, mlflow and
comet callbacks' gates run as the JAX package's own body
(``test_integrations_are_gated`` in ``tests/test_torch_tune.py``). The
JAX package has no test of the keras ``ReportCheckpointCallback``; this
file gives it one: in a process where JAX cannot be imported, with
``KERAS_BACKEND=torch``, one ``fit`` epoch of a two-layer keras model in
a one-worker ``TorchTrainer`` reports the epoch's metrics and a
checkpoint holding the saved model."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import os
    import sys
    for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu"):
        sys.modules[name] = None      # any import of them now fails
    try:
        import keras  # noqa: F401
    except ImportError as e:
        print("NO-KERAS", e)
        raise SystemExit(0)
    import ray_tpu_torch
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def train_func(config):
        import sys
        sys.modules["jax"] = None     # keras imports JAX where it can
        import numpy as np
        import keras
        from ray_tpu_torch.air.integrations.keras import \\
            ReportCheckpointCallback
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 4)).astype("float32")
        y = x.sum(axis=1, keepdims=True)
        model = keras.Sequential([keras.Input((4,)),
                                  keras.layers.Dense(8, activation="relu"),
                                  keras.layers.Dense(1)])
        model.compile(optimizer="sgd", loss="mse", metrics=["mae"])
        model.fit(x, y, epochs=1, batch_size=16, verbose=0,
                  callbacks=[ReportCheckpointCallback(
                      metrics={"loss": "loss", "mae": "mae"})])

    ray_tpu_torch.init(num_cpus=2, _num_initial_workers=1)
    try:
        result = TorchTrainer(
            train_func, scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="keras", storage_path=sys.argv[1])
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    m = result.metrics
    assert set(m) >= {"loss", "mae"}, m
    assert all(isinstance(m[k], float) and m[k] == m[k] for k in
               ("loss", "mae")), m
    ckpt = result.checkpoint
    assert ckpt is not None
    assert "model.keras" in os.listdir(ckpt.path), os.listdir(ckpt.path)
    leaked = [n for n in sys.modules if n.split(".")[0] in ("jax",
              "ray_tpu") and sys.modules[n] is not None]
    assert not leaked, leaked
    print("KERAS-OK", m["loss"], m["mae"])
""")


def test_keras_callback_reports_metrics_and_a_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), KERAS_BACKEND="torch",
               RAY_TPU_TORCH_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if "NO-KERAS" in proc.stdout:
        pytest.skip("keras cannot be imported here: " + proc.stdout.strip())
    assert "KERAS-OK" in proc.stdout, proc.stdout + proc.stderr
