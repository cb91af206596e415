"""The port's ``ParallelPlan`` (``ray_tpu_torch.parallel.plan``) against the
JAX package's, on the CPU in f32.

- lowering selection and validation: the JAX bodies of
  ``tests/parallel/test_parallel_plan.py`` run on the port's class;
- the SPMD lowering at world 1 (the one-device step in this process) and
  at dp 2 (the sharded step on two gloo rank actors, with and without the
  flat sharded update) against JAX's plan from JAX's own start state: the
  loss and grad norm of 3 steps at 1e-5, and the canonical checkpoint
  after them equal to JAX's;
- the MPMD lowering: a checkpoint saved under ``pp=2, virtual=2``
  reloads under ``pp=1`` and under ``pp=2, virtual=1`` with the next
  step's loss equal; ``slice_strategy`` without slice capacity falls back
  to the local devices;
- the rank and stage actors refuse to start without a card unless told
  ``device="cpu"`` (or on workers of the CPU platform);
- ``mpmd3d`` builds (a mesh of rank actors a stage), the lowering
  selection equals JAX's, and the lazy ``parallel.mpmd_pipeline``,
  ``parallel.ParallelPlan`` and ``parallel.ElasticTrainer`` resolve
  (``tests/test_torch_mpmd3d.py`` holds the stage mesh against JAX's
  nested stages, ``tests/test_torch_elastic.py`` the trainer).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.transformer import TransformerConfig as JConfig
from ray_tpu.parallel.plan import ParallelPlan as JaxPlan
from ray_tpu_torch._bridge import _find_adam_state
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel.plan import ParallelPlan
from test_torch_runtime_loader import FIXTURES, load_core_tests

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")

_MESH3D = ("drives JAX's dp=2 stages in one process over two devices "
           "(device_indices); the port's stage mesh is one process a rank, "
           "and tests/test_torch_mpmd3d.py runs the same cases on it")

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_spmd_program_step_and_canonical_checkpoint":
        "compares the checkpoint's treedef with optax's adamw state; "
        "test_spmd_plan_at_world_1_matches_jax holds the port's canonical "
        "layout to JAX's values",
    "test_nested_stage_mesh_matches_spmd_short": _MESH3D,
    "test_nested_int8_stage_wire_is_quantized_and_tracks_fp32": _MESH3D,
    "test_sharded_update_flat_opt_state_checkpoints_param_shaped": _MESH3D,
    "test_checkpoint_round_trip_across_lowerings": _MESH3D + "; "
        "test_checkpoint_saved_at_v2_reloads_under_pp1_and_v1 is its "
        "twin on the mpmd lowering",
    "test_dp_shrink_reslices_uneven_flat_opt_shards": _MESH3D,
    "test_virtual_fold_to_v1_under_int8_grad_transport": _MESH3D,
}

globals().update(FIXTURES)
globals().update(load_core_tests("parallel/test_parallel_plan.py",
                                 LEAVE_OUT))

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2, head_dim=16,
            d_ff=64, max_seq_len=32, rotary_dim=8, block_style="gptj",
            remat=False, ce_chunk_size=8)
JCFG = JConfig(**TINY, dtype=jnp.float32)
TCFG = TransformerConfig(**TINY, dtype=torch.float32)


def _batch(rows=8, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (rows, seq)).astype(np.int32),
            "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}


def _canonical_from_jax(ck):
    """JAX's canonical checkpoint (an optax adamw state) as the port's."""
    adam = _find_adam_state(ck["opt_state"])
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": tree(ck["params"]),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": tree(adam.mu), "nu": tree(adam.nu)},
            "step": int(ck["step"])}


def _close(got, want, **tol):
    for path, v in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for p in path:
            t = t[p.key]
        np.testing.assert_allclose(np.asarray(t), v, **(tol or TOL),
                                   err_msg=str(path))


def _spmd_against_jax(plan_kw, build_kw):
    b = _batch()
    jprog = JaxPlan(**plan_kw).build(JCFG, learning_rate=1e-3, seed=0,
                                     telemetry_interval_s=0, **build_kw)
    prog = ParallelPlan(**plan_kw).build(TCFG, learning_rate=1e-3, seed=0,
                                         device="cpu")
    try:
        prog.load_checkpoint(_canonical_from_jax(jprog.save_checkpoint()))
        for _ in range(3):
            got, want = prog.step(b), jprog.step(b)
            assert got.loss == pytest.approx(want.loss, rel=1e-5)
            assert got.grad_norm == pytest.approx(want.grad_norm, rel=1e-5)
            assert got.step == want.step
        ck = prog.save_checkpoint()
        want = _canonical_from_jax(jprog.save_checkpoint())
        assert ck["step"] == want["step"] == 3
        assert ck["opt_state"]["count"] == want["opt_state"]["count"]
        for key in ("mu", "nu"):
            _close(ck["opt_state"][key], want["opt_state"][key])
        _close(ck["params"], want["params"])
    finally:
        prog.shutdown()


def test_spmd_plan_at_world_1_matches_jax():
    _spmd_against_jax({}, {})


@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4, _num_initial_workers=0)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("sharded_update", [False, True])
def test_spmd_plan_at_dp2_on_ranks_matches_jax(runtime, cpu_mesh_devices,
                                               sharded_update):
    _spmd_against_jax(dict(dp=2, shard_weight_update=sharded_update),
                      dict(devices=cpu_mesh_devices[:2]))


def test_checkpoint_saved_at_v2_reloads_under_pp1_and_v1(runtime):
    b = _batch(rows=4)
    prog = ParallelPlan(pp=2, virtual=2, n_microbatches=2).build(
        TCFG, learning_rate=1e-3, seed=0)
    assert prog.lowering == "mpmd"
    first = prog.step(b)
    assert first.bubble_fraction is not None and first.step == 1
    ck = prog.save_checkpoint()
    assert ck["step"] == 1 and ck["opt_state"]["count"] == 1
    one = ParallelPlan().build(TCFG, learning_rate=1e-3, seed=9,
                               device="cpu")
    one.load_checkpoint(ck)
    # slice capacity is absent here: the gang falls back to local devices
    v1 = ParallelPlan(pp=2, n_microbatches=2,
                      slice_strategy="SLICE_SPREAD").build(
        TCFG, learning_rate=1e-3, seed=9, placement_timeout_s=0.5)
    try:
        assert v1.pg is None
        v1.load_checkpoint(ck)
        want = prog.step(b)
        for other in (one, v1):
            got = other.step(b)
            assert got.loss == pytest.approx(want.loss, rel=1e-5)
            assert got.step == 2
        # and back: the one-device state reloads into the pipeline
        prog.load_checkpoint(one.save_checkpoint())
        assert prog.step(b).loss == pytest.approx(one.step(b).loss,
                                                  rel=1e-5)
    finally:
        prog.shutdown()
        v1.shutdown()


def test_plan_actors_need_the_card_unless_told_cpu(runtime, monkeypatch):
    """On a runtime that counts no GPU, with its workers not on the CPU
    platform, the sharded SPMD program and the pipeline refuse to start
    their actors instead of running them on the CPU; ``device="cpu"``
    puts them there."""
    from ray_tpu_torch.parallel.mpmd_pipeline import actor_device
    monkeypatch.delenv("RAY_TPU_TORCH_PLATFORM")
    for plan in (ParallelPlan(dp=2), ParallelPlan(fsdp=2),
                 ParallelPlan(pp=2, n_microbatches=2)):
        with pytest.raises(RuntimeError, match="counts no GPU"):
            plan.build(TCFG)
    assert actor_device("cpu", 2) == ("cpu", 0.0)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    assert actor_device(None, 2) == ("cpu", 0.0)


def test_mpmd3d_builds_and_elastic_resolves_like_jax(runtime):
    import ray_tpu_torch.parallel as par
    from ray_tpu_torch.parallel.elastic import ElasticTrainer
    assert par.ParallelPlan is ParallelPlan
    assert par.mpmd_pipeline.MPMDPipeline.__name__ == "MPMDPipeline"
    assert par.ElasticTrainer is ElasticTrainer
    for kw in (dict(pp=2, dp=2), dict(pp=2, fsdp=2),
               dict(pp=4, dp=2, fsdp=2), dict(pp=2, virtual=2, dp=2),
               dict(pp=2), dict(dp=2), dict()):
        assert ParallelPlan(**kw).lowering == JaxPlan(**kw).lowering
        assert ParallelPlan(**kw).describe() == JaxPlan(**kw).describe()
    prog = ParallelPlan(pp=2, dp=2, n_microbatches=2,
                        grad_transport="int8").build(TCFG)
    try:
        assert prog.lowering == "mpmd3d"
        pipe = prog.pipeline
        assert (pipe.n_stages, pipe.n_ranks, len(pipe.stages)) == (2, 2, 4)
        assert [len(row) for row in pipe.ranks] == [2, 2]
    finally:
        prog.shutdown()
    with pytest.raises(ValueError, match="mesh"):
        ParallelPlan(grad_transport="int8").build(TCFG, device="cpu")
    assert dataclasses.asdict(ParallelPlan(pp=2, virtual=2)) == \
        dataclasses.asdict(JaxPlan(pp=2, virtual=2))
