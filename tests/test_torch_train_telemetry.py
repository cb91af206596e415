"""The port's trainer telemetry (``models/training.py::TrainStepBundle.
_telemetry``), the twins of the JAX package's
``tests/models/test_train_telemetry.py`` train-step bodies (they build a
JAX mesh and draw with ``jax.random``; the mailbox body is in the port's
pipeline tests): every ``telemetry_interval_s`` the step sets
``train_tokens_per_s``, the MFU gauge, the loss and grad norm and
observes the step wall, with one host sync on the window's last loss;
``0`` disables it; over a mesh only rank 0 reports. The loss gauge holds
the JAX step's loss from the same weights at 1e-5."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch.core.metric_defs import runtime_metrics
from ray_tpu_torch.models import get_config, make_train_step
from ray_tpu_torch.models import training


def _tiny_cfg(get=get_config):
    return dataclasses.replace(
        get("gptj-tiny"), d_model=32, n_layers=1, n_heads=2,
        head_dim=16, d_ff=64, vocab_size=128, max_seq_len=32,
        rotary_dim=16)


def _val(g):
    return list(g._values.values())[0]


def _batch(rows=8):
    ids = np.random.default_rng(1).integers(0, 128, (rows, 32)).astype(
        np.int32)
    return {"input_ids": ids, "loss_mask": np.ones((rows, 32), np.float32)}


def test_train_step_telemetry_sets_gauges():
    m = runtime_metrics()
    for g in (m.train_tokens_per_s, m.train_mfu, m.train_loss,
              m.train_grad_norm):
        g.clear()
    wall_before = sum(sum(c) for c in m.train_step_wall._counts.values())
    bundle = make_train_step(_tiny_cfg(), learning_rate=1e-3,
                             telemetry_interval_s=1e-6, device="cpu")
    state = bundle.init(seed=0)
    for _ in range(3):
        state, metrics = bundle.step(state, _batch())
    assert _val(m.train_tokens_per_s) > 0
    assert _val(m.train_mfu) >= 0
    assert _val(m.train_loss) == float(metrics["loss"])
    assert _val(m.train_grad_norm) == float(metrics["grad_norm"]) > 0
    wall_after = sum(sum(c) for c in m.train_step_wall._counts.values())
    assert wall_after == wall_before + 2    # windows closed: steps 2, 3


def test_train_step_telemetry_disabled_is_silent():
    m = runtime_metrics()
    m.train_tokens_per_s.clear()
    bundle = make_train_step(_tiny_cfg(), learning_rate=1e-3,
                             telemetry_interval_s=0, device="cpu")
    state = bundle.init(seed=0)
    bundle.step(state, _batch(2))
    assert not m.train_tokens_per_s._values


def test_only_rank_0_of_a_mesh_reports(monkeypatch):
    """A rank other than the mesh's first counts its steps and closes
    its windows but sets no gauge: the fleet sums processes, and every
    rank steps the same global batch."""
    m = runtime_metrics()
    m.train_tokens_per_s.clear()
    bundle = training.TrainStepBundle(
        config=_tiny_cfg(), mesh=object(), rules=None, init_fn=None,
        step_fn=None, telemetry_interval_s=1e-6)
    monkeypatch.setattr(training, "mesh_coordinate",
                        lambda mesh: {"dp": 1, "tp": 0})
    metrics = {"loss": torch.tensor(1.5), "grad_norm": torch.tensor(2.0)}
    ids = torch.zeros((4, 32), dtype=torch.int64)
    for _ in range(3):
        bundle._telemetry({"input_ids": ids}, metrics)
    assert not m.train_tokens_per_s._values
    assert bundle._tel_steps == 0          # each window was closed
    monkeypatch.setattr(training, "mesh_coordinate",
                        lambda mesh: {"dp": 0, "tp": 0})
    bundle._tel_reports = None
    for _ in range(2):
        bundle._telemetry({"input_ids": ids}, metrics)
    assert _val(m.train_tokens_per_s) > 0 and _val(m.train_loss) == 1.5


def test_the_loss_gauge_holds_the_jax_step_s_loss():
    """Same weights (the JAX train state carried by ``_bridge``) and
    batch at ``gptj-tiny``: the port's loss gauge after a step equals the
    JAX step's loss at 1e-5."""
    from ray_tpu.models import get_config as jax_get_config
    from ray_tpu.models import make_train_step as jax_make_train_step
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch._bridge import train_state_from_jax
    jb = jax_make_train_step(jax_get_config("gptj-tiny"),
                             build_mesh(MeshSpec(), jax.devices()[:1]),
                             learning_rate=1e-3, telemetry_interval_s=0)
    jstate = jb.init(seed=0)
    snap = jax.tree.map(np.asarray, jstate)
    batch = _batch()
    _, jmetrics = jb.step(jstate, batch)
    pb = make_train_step(get_config("gptj-tiny"), learning_rate=1e-3,
                         telemetry_interval_s=1e-6, device="cpu")
    pstate = train_state_from_jax(snap, get_config("gptj-tiny"), "cpu")
    m = runtime_metrics()
    m.train_loss.clear()
    pb._tel_last = 1.0                     # the window closes at step 1
    pb.step(pstate, batch)
    assert _val(m.train_loss) == pytest.approx(float(jmetrics["loss"]),
                                               rel=1e-5)
