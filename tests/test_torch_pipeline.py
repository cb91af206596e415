"""The port's GPipe ``pipeline_apply`` (``ray_tpu_torch.ops.pipeline``)
against the JAX package's, on the CPU in f32.

Four gloo ranks (actors of the port's runtime) form ``MeshSpec(pp=4)``;
rank ``i`` holds stage ``i``'s slice of the stacked weights. The JAX
function runs over ``MeshSpec(pp=4, dp=2)`` on eight CPU devices with the
same numpy weights and input:

- ``tanh(h @ w)`` stages (the dry run's): outputs at 1e-5, the stacked
  gradient of ``sum(out ** 2)`` at JAX's own bound (rtol 1e-4, atol
  1e-5); the control sums the output over pp in the backward too, which
  multiplies every stage's gradient by 4, and falls outside;
- one ``gptj-tiny`` block a stage (``run_layers`` over a 1-layer slice),
  output and gradients;
- a batch that the microbatch count does not divide raises.
"""

import copy
import dataclasses
import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import transformer as jt
from ray_tpu.ops.pipeline import pipeline_apply as jax_pipeline_apply
from ray_tpu.ops.pipeline import stack_stage_params as jax_stack
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu_torch.ops.pipeline import stack_stage_params

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/models/test_moe_pipeline.py
S, M = 4, 4


@pytest.fixture(scope="module")
def ranks():
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    ray_tpu_torch.init(num_cpus=S, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(S, "gloo", group_name="pipeline-tests")
        yield actors
    finally:
        stop_ranks(actors)
        ray_tpu_torch.shutdown()


def _run(ranks, fn, *args):
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    return copy.deepcopy(run_on_ranks(
        ranks, lambda rank, *a: fn(rank, *a), *args))


def _mesh(rank):
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    if "pp4" not in rank.state:
        rank.state["pp4"] = build_mesh(MeshSpec(pp=S), device_type="cpu")
    return rank.state["pp4"]


class _SumBothWays(torch.autograd.Function):
    """The control: all-reduce forward AND backward."""

    @staticmethod
    def forward(ctx, x, group):
        from ray_tpu_torch.parallel.collective import _all_reduce
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        from ray_tpu_torch.parallel.collective import _all_reduce
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def _pipeline_on_rank(rank, stacked, x, stage, control=False):
    """This rank's stage slice of ``stacked`` through ``pipeline_apply``;
    returns (output, the slice's gradient of sum(out ** 2))."""
    from ray_tpu_torch.ops import pipeline
    from ray_tpu_torch.parallel.mesh import axis_group
    mesh = _mesh(rank)
    s = axis_group(mesh, "pp").rank
    mine = {k: torch.tensor(v[s:s + 1]).requires_grad_()
            for k, v in stacked.items()}
    inner = pipeline.reduce_from_region
    if control:
        pipeline.reduce_from_region = _SumBothWays.apply
    try:
        out = pipeline.pipeline_apply(stage, mine, torch.tensor(x), mesh, M)
    finally:
        pipeline.reduce_from_region = inner
    (out ** 2).sum().backward()
    return out.detach().numpy(), {k: t.grad.numpy()
                                  for k, t in mine.items()}


def _tanh_stage(p, h):
    return torch.tanh(h @ p["w"])


def _jax_pipeline(stage, stacked, x, devices):
    mesh = jbuild_mesh(JMeshSpec(pp=S, dp=2), devices)

    def loss(p):
        out = jax_pipeline_apply(stage, p, jnp.asarray(x), mesh, M)
        return jnp.sum(out ** 2), out
    grad, out = jax.jit(jax.grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, stacked))
    return np.asarray(out), jax.tree.map(np.asarray, grad)


def test_tanh_stages_equal_jax_and_the_control_falls_outside(
        ranks, cpu_mesh_devices):
    from ray_tpu_torch.parallel.dryrun import pp_part_inputs
    w, x = pp_part_inputs()
    stacked = {"w": w}
    want_out, want_g = _jax_pipeline(
        lambda p, h: jnp.tanh(h @ p["w"]), stacked, x, cpu_mesh_devices)
    outs = _run(ranks, _pipeline_on_rank, stacked, x, _tanh_stage)
    for out, _ in outs:
        np.testing.assert_allclose(out, want_out, **TOL)
    got = np.concatenate([g["w"] for _, g in outs])
    np.testing.assert_allclose(got, want_g["w"], **GRAD_TOL)
    ctl = np.concatenate([g["w"] for _, g in _run(
        ranks, _pipeline_on_rank, stacked, x, _tanh_stage, True)])
    np.testing.assert_allclose(ctl, S * want_g["w"], rtol=1e-4, atol=1e-5)
    assert not np.allclose(ctl, want_g["w"], **GRAD_TOL)
    # stack_stage_params stacks as the JAX function does
    stacked_t = stack_stage_params([{"w": torch.tensor(w[i])}
                                    for i in range(S)])
    np.testing.assert_array_equal(stacked_t["w"].numpy(), np.asarray(
        jax_stack([{"w": jnp.asarray(w[i])} for i in range(S)])["w"]))


def _block_stage(cfg):
    from ray_tpu_torch.models.transformer import run_layers
    return lambda p, h: run_layers(cfg, p, h)[0]


def test_gptj_tiny_block_stages_equal_jax(ranks, cpu_mesh_devices):
    from ray_tpu_torch.models import get_config
    jcfg = dataclasses.replace(jax_get_config("gptj-tiny"), n_layers=S)
    tcfg = dataclasses.replace(get_config("gptj-tiny"), n_layers=S)
    layers = jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.PRNGKey(0))["layers"])
    # [S, 1, ...]: stage i holds layer i as a 1-layer stack
    stacked = {k: v[:, None] for k, v in layers.items()}
    x = np.random.default_rng(5).standard_normal(
        (8, 16, jcfg.d_model)).astype(np.float32)
    want_out, want_g = _jax_pipeline(
        lambda p, h: jt.run_layers(jcfg, p, h)[0], stacked, x,
        cpu_mesh_devices)
    outs = _run(ranks, _pipeline_on_rank, stacked, x, _block_stage(tcfg))
    for out, _ in outs:
        np.testing.assert_allclose(out, want_out, **TOL)
    for k in stacked:
        got = np.concatenate([g[k] for _, g in outs])
        np.testing.assert_allclose(got, want_g[k], **GRAD_TOL, err_msg=k)


def _bad_batch_on_rank(rank):
    from ray_tpu_torch.ops.pipeline import pipeline_apply
    try:
        pipeline_apply(lambda p, h: h, {"w": torch.zeros(1, 1)},
                       torch.zeros(7, 16), _mesh(rank), n_microbatches=4)
    except ValueError as e:
        return str(e)
    return None


def test_bad_microbatch_count_raises(ranks):
    assert all(msg and "not divisible" in msg
               for msg in _run(ranks, _bad_batch_on_rank))
