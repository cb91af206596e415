"""The non-slow twin of the JAX package's slow
``tests/autoscaler/test_colocation_e2e.py::
test_colocation_preempt_fold_return_regrow`` (that file imports ``jax``
and is not loaded), against the JAX package itself: JAX's ``_Rig`` flow
at its ``tiny_config`` on the CPU, run once with the JAX package's
arbiter, slice manager and ``ElasticTrainer`` and once with the port's
from the same weights (carried by ``_bridge``'s layout). Sustained queue
pressure preempts the train slice, the trainer folds dp=2 -> dp=1, the
ebb returns a slice and it regrows to dp=2: the port's losses are
within 1e-5 of JAX's trainer's at every step, and the arbiter's actions,
events and the trainers' recoveries are the same."""

import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

from test_torch_autoscaler_arbiter import jax_module
from test_torch_elastic import _canonical_from_jax
from test_torch_runtime_loader import load_core_tests

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

_FILE = "autoscaler/test_colocation_e2e.py"
_BODIES = ("test_colocation_preempt_fold_return_regrow",
           "test_arbitration_soak")
#: the port's twin of the module: its helpers build the port's objects
_port = load_core_tests(_FILE, {n: "slow in the JAX package; twinned "
                                   "below" for n in _BODIES}, edits=(
    ("import jax\n\nimport ray_tpu_torch", "import torch\n\nimport "
                                             "ray_tpu_torch"),
    ("    import jax.numpy as jnp\n", ""),
    ("dtype=jnp.float32", "dtype=torch.float32"),
))


@pytest.fixture
def runtime():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=8, _num_initial_workers=0)
    yield
    ray_tpu_torch.shutdown()


def _batch(rows=8, seq=16, seed=1):
    ids = np.random.default_rng(seed).integers(0, 128, (rows, seq))
    return {"input_ids": ids.astype(np.int32),
            "loss_mask": np.ones((rows, seq), np.float32)}


def _flow(rig, trainer, batch, record):
    """JAX's acceptance path: 2 steps, sustained pressure preempts, 3
    folded steps, the drain completes, the ebb returns a slice, 3
    regrown steps. Records every loss, action and arbiter event."""
    def steps(n):
        for _ in range(n):
            record["losses"].append(trainer.step(batch).loss)
            record["plans"].append(trainer.plan.dp)
    steps(2)
    rig.gauges.queue_depth = 9.0
    record["actions"].append(rig.arbiter.update()["actions"])
    rig.clock.advance(2.5)
    record["actions"].append([a.split(":")[0] for a in
                              rig.arbiter.update()["actions"]])
    steps(3)
    rig.pump(busy=False)
    record["train_slice"] = rig.mgr.slices[rig.train_sid].state
    rig.gauges.queue_depth = 0.2
    record["actions"].append(rig.arbiter.update()["actions"])
    rig.clock.advance(4.5)
    record["actions"].append(rig.arbiter.update()["actions"])
    rig.pump(busy=True)
    steps(3)
    record["events"] = [(e["ev"], e.get("reason"), e.get("owner"))
                        for e in rig.events("ARBITER_PREEMPT")
                        + rig.events("ARBITER_RETURN")]
    record["recoveries"] = [(r.trigger, r.from_plan, r.to_plan,
                             r.steps_lost) for r in trainer.recoveries]
    record["counts"] = (rig.arbiter.preemptions, rig.arbiter.returns)
    live = sorted(rig.mgr.slices[s].state for s in rig.mgr.slices)
    record["slice_states"] = live


def test_colocation_fold_and_regrow_equal_the_jax_trainer(runtime):
    from ray_tpu.parallel.elastic import ElasticTrainer as JTrainer
    from ray_tpu.parallel.plan import ParallelPlan as JPlan
    from ray_tpu_torch.parallel.elastic import ElasticTrainer
    from ray_tpu_torch.parallel.plan import ParallelPlan
    jmod = jax_module(_FILE)
    batch = _batch()
    out = {}
    jrig = jmod._Rig()
    jt = JTrainer(JPlan(dp=2), jmod.tiny_config(), learning_rate=1e-3,
                  telemetry_interval_s=0, slice_manager=jrig.mgr,
                  slice_filter=lambda sid: sid in jrig.owned)
    start = _canonical_from_jax(jt.save_checkpoint())
    try:
        out["jax"] = rec = {"losses": [], "plans": [], "actions": []}
        _flow(jrig, jt, batch, rec)
    finally:
        jt.shutdown()
        jrig.shutdown()
    prig = _port["_Rig"]()
    pt = ElasticTrainer(ParallelPlan(dp=2), _port["tiny_config"](),
                        learning_rate=1e-3, telemetry_interval_s=0,
                        slice_manager=prig.mgr,
                        slice_filter=lambda sid: sid in prig.owned,
                        device="cpu")
    try:
        pt.load_checkpoint(start)
        out["port"] = rec = {"losses": [], "plans": [], "actions": []}
        _flow(prig, pt, batch, rec)
    finally:
        pt.shutdown()
        prig.shutdown()
    want, got = out["jax"], out["port"]
    assert want["plans"] == [2, 2, 1, 1, 1, 2, 2, 2]
    assert want["counts"] == (1, 1)
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    for key in ("plans", "actions", "events", "recoveries", "counts",
                "train_slice", "slice_states"):
        assert got[key] == want[key], key
