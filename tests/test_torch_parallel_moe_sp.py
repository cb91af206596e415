"""The port's MoE over ``ep`` and ring attention over ``sp`` in the sharded
train step, against the JAX package's, on the CPU.

Four gloo ranks (actors of the port's runtime) run ``make_train_step``
over a mesh in f32, from the JAX package's own init carried over by
``_bridge.shard_train_state_from_jax``; the JAX step runs over the same
mesh on four CPU devices. Tolerance 1e-5 (rtol and atol):

- ``moe-tiny`` for 3 steps on (dp 2, ep 2), (fsdp 2, ep 2) and (ep 2,
  tp 2), and on (fsdp 2, ep 2) at ``capacity_factor=0.5``, where tokens
  are dropped on both batch ranks, so a capacity or a slot counted per
  rank would differ: the loss, the grad norm and the aux term at every
  step, and each rank's shards of the first step's gradients equal to
  JAX device ``i``'s (the expert leaves split over ``ep``, the rest
  replicated over it, which a sum of their gradients over ``ep`` would
  double), and the share of tokens dropped equal on every rank to one
  device's; in every case the ranks' shards of the start state
  (``shard_train_state_from_jax``) gather back (``gather_to_numpy``) to
  JAX's bit for bit;
- ``gptj-tiny`` and ``llama2-tiny`` for 5 steps on (fsdp 2, sp 2) and
  (sp 2, tp 2): the ring replaces the flash path, rotary positions are
  global, labels cross the chunk boundary, and the gradients are summed
  over ``sp`` (a step that did not would halve them and still learn):
  the loss and the grad norm at every step and each rank's gradient
  shards; under ``sp x tp`` the port keeps the heads split over ``tp``
  where JAX gathers them before its ring;
- ``grad_transport="int8"`` with the sharded weight update on (fsdp 2,
  sp 2) within JAX's bound of the fp32 run (|loss - fp32 loss| < 1e-2 at
  step 20, ``tests/models/test_sharded_update.py``), still learning;
- the dry run at n = 8: the JAX dry run's body (gptj-tiny on fsdp 2 x
  tp 2 x sp 2), its ep part (moe-tiny on dp 2 x ep 2 x tp 2) and its pp
  part (the 4-stage GPipe over pp 4 x dp 2) on 8 gloo ranks, the pp
  part's loss and stage gradients equal to JAX's (its own bound, rtol
  1e-4, atol 1e-5) from the same numpy weights.

The JAX bodies ``test_moe_train_step_on_ep_mesh`` (marked ``slow`` in
``tests/models/test_moe_pipeline.py``) and the ring bodies of
``tests/ops/test_attention.py`` drive JAX arrays through ``jax.random``
and ``shard_map``, so the loader cannot run them on the port; the cases
here and in ``tests/test_torch_ring_attention.py`` are their twins.
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
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu_torch.models import get_config

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4
DRYRUN_RANKS = 8
# tests/models/test_sharded_update.py's model and acceptance bound
INT8_CFG = dict(d_model=32, n_layers=1, n_heads=2, head_dim=16, d_ff=64,
                vocab_size=128, max_seq_len=32)
INT8_STEPS = 20
INT8_BOUND = 1e-2


@pytest.fixture(scope="module")
def ranks():
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    # room for the dry run's own eight ranks beside these
    ray_tpu_torch.init(num_cpus=W + DRYRUN_RANKS, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(W, "gloo", group_name="moe-sp-tests")
        yield actors
    finally:
        stop_ranks(actors)
        ray_tpu_torch.shutdown()


def _run(ranks, fn, *args):
    """``fn`` on every rank, the results copied out of the store (the
    lambda goes through cloudpickle, which sends ``fn`` by value)."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    return copy.deepcopy(run_on_ranks(
        ranks, lambda rank, *a: fn(rank, *a), *args))


def _batches(vocab, n, rows=4, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, seq)).astype(
                np.int32),
             "loss_mask": (rng.random((rows, seq)) > 0.2).astype(
                 np.float32)} for _ in range(n)]


def _device_shards(tree):
    """JAX device ``i``'s shard of every leaf, ``[i] -> {path: array}``."""
    out = [{} for _ in range(W)]
    for path, arr in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(p.key for p in path)
        for shard in arr.addressable_shards:
            out[shard.device.id][name] = np.asarray(shard.data)
    return out


def _jax_run(cfg, mesh_kw, batches, **kw):
    """JAX's run: the start state (numpy), (loss, grad norm) and, for an
    MoE config, the aux term of each step's loss (its metrics do not
    carry it: ``lm_loss`` on the state before the step gives it), and
    each device's shards of the first step's gradients. (The params
    after a few Adam steps are no test at 1e-5: an element whose
    gradient is within rounding of zero, as an expert that few tokens
    reach has, moves by a large share of the learning rate either way.)"""
    from ray_tpu.models import transformer as jtf
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), jax.devices()[:W])
    bundle = jax_make_train_step(cfg, mesh, learning_rate=1e-3, **kw)
    state = bundle.init(seed=0)
    start = jax.tree.map(np.asarray, state)
    psh = bundle.state_shardings["params"]
    grads = jax.jit(jax.grad(lambda p, b: jtf.lm_loss(
        cfg, p, b, mesh=mesh, rules=bundle.rules)[0]),
        out_shardings=psh)(state["params"], jax.device_put(
            {k: jnp.asarray(v) for k, v in batches[0].items()},
            bundle.batch_spec))
    grads = _device_shards(grads)
    out, aux = [], []
    for b in batches:
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        if cfg.n_experts:
            aux.append(float(jtf.lm_loss(cfg, state["params"],
                                         batch)[1]["moe_aux"]))
        state, m = bundle.step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return start, out, aux, grads


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _port_run(rank, cfg, mesh_kw, state_np, batches, kw):
    """The port's run on this rank: (loss, grad norm) and the aux term of
    each step, this rank's shards of the first step's gradients (summed
    over the data axes each leaf is replicated over, as the step sums
    them), and the start params gathered back from every rank's
    shards."""
    from ray_tpu_torch._bridge import (gather_to_numpy,
                                       shard_train_state_from_jax)
    from ray_tpu_torch.models import lm_loss, make_train_step
    from ray_tpu_torch.models.training import leaf_plans
    from ray_tpu_torch.parallel.collective import psum_tree
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec(**mesh_kw), device_type="cpu")
    bundle = make_train_step(cfg, mesh, learning_rate=1e-3, device="cpu",
                             **kw)
    state = shard_train_state_from_jax(
        state_np, cfg, mesh, device="cpu",
        shard_weight_update=kw.get("shard_weight_update", False),
        quant_block_size=kw.get("quant_block_size", 256))
    if kw.get("shard_weight_update"):   # the flat moments start at zero
        state["opt_state"] = bundle.init(0)["opt_state"]
    start = gather_to_numpy(state["params"], cfg, mesh)
    named = list(_named(state["params"]))
    leaves = [t.requires_grad_() for _, t in named]
    loss, _ = lm_loss(cfg, state["params"],
                      bundle.local_batch(batches[0]), mesh=mesh)
    plans = leaf_plans(cfg, mesh, bundle.rules, False)
    grads = {}
    for (name, _), g in zip(named, torch.autograd.grad(loss, leaves)):
        group = plans[tuple(name.split("."))].replicated
        grads[name] = psum_tree(g, group).numpy().copy()
    out, aux = [], []
    for b in batches:
        state, m = bundle.step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        aux.append(float(m.get("moe_aux", 0.0)))
    return out, aux, grads, start


def _check_start(outs, start):
    """Every rank's gathered start params are JAX's, bit for bit."""
    for _, _, _, gathered in outs:
        for path, v in jax.tree_util.tree_leaves_with_path(
                start["params"]):
            t = gathered
            for p in path:
                t = t[p.key]
            np.testing.assert_array_equal(t, v, err_msg=str(path))


def _check_rank_shards(got, want):
    """Rank ``r``'s arrays (``got[r]``) against JAX device ``r``'s."""
    for r, shards in enumerate(got):
        assert set(shards) == set(want[r])
        for name, arr in shards.items():
            np.testing.assert_allclose(arr, want[r][name], **TOL,
                                       err_msg=f"rank {r} {name}")


MOE_CASES = {
    "dp2_ep2": (dict(dp=2, ep=2), 1.25),
    "fsdp2_ep2": (dict(fsdp=2, ep=2), 1.25),
    "ep2_tp2": (dict(ep=2, tp=2), 1.25),
    "fsdp2_ep2_drops": (dict(fsdp=2, ep=2), 0.5),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_steps_on_ep_meshes_match_jax(ranks, cpu_mesh_devices, case):
    mesh_kw, cf = MOE_CASES[case]
    jcfg = dataclasses.replace(jax_get_config("moe-tiny"),
                               capacity_factor=cf)
    tcfg = dataclasses.replace(get_config("moe-tiny"), capacity_factor=cf)
    batches = _batches(jcfg.vocab_size, 1, seed=1) * 3   # memorized
    start, want, jaux, grads = _jax_run(jcfg, mesh_kw, batches)
    outs = _run(ranks, _port_run, tcfg, mesh_kw, start, batches, {})
    for got, aux, _, _ in outs:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(aux, jaux, **TOL)
    _check_rank_shards([o[2] for o in outs], grads)
    _check_start(outs, start)
    assert outs[0][0][-1][0] < outs[0][0][0][0]


def _dropped_on_rank(rank, cfg, ids):
    """Each layer's share of the global batch's tokens dropped for
    capacity, as this rank reports it."""
    from ray_tpu_torch.models import init_params, lm_loss
    from ray_tpu_torch.parallel import shard_params
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    mesh = build_mesh(MeshSpec(fsdp=2, ep=2), device_type="cpu")
    params = shard_params(init_params(cfg, 0, "cpu"), logical_axes(cfg),
                          FSDP_RULES, mesh)
    r = torch.distributed.get_rank()
    rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
    with torch.no_grad():
        _, aux = lm_loss(cfg, params, {"input_ids": torch.tensor(ids[rows])},
                         mesh=mesh)
    return aux["moe_dropped"].numpy().copy()


def test_capacity_drops_count_the_global_batch(ranks):
    """At ``capacity_factor=0.5`` every rank reports the one-device
    model's dropped share of each layer (the global batch's), and tokens
    are dropped."""
    from ray_tpu_torch.models import init_params, lm_loss
    cfg = dataclasses.replace(get_config("moe-tiny"), capacity_factor=0.5)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 24))
    with torch.no_grad():
        _, aux = lm_loss(cfg, init_params(cfg, 0, "cpu"),
                         {"input_ids": torch.tensor(ids)})
    want = aux["moe_dropped"].numpy()
    assert (want > 0).all()
    for got in _run(ranks, _dropped_on_rank, cfg, ids):
        np.testing.assert_allclose(got, want, **TOL)


SP_CASES = {f"{name}-{mesh}": (name, kw, {}) for name in ("gptj-tiny",
                                                          "llama2-tiny")
            for mesh, kw in (("fsdp2_sp2", dict(fsdp=2, sp=2)),
                             ("sp2_tp2", dict(sp=2, tp=2)))}
# the ring under selective checkpointing: the block's recompute in the
# backward runs the ring's exchanges again, on every rank alike
SP_CASES["gptj-tiny-fsdp2_sp2-dots"] = ("gptj-tiny", dict(fsdp=2, sp=2),
                                        dict(remat_policy="dots"))


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_ring_steps_on_sp_meshes_match_jax(ranks, cpu_mesh_devices, case):
    name, mesh_kw, kw = SP_CASES[case]
    batches = _batches(jax_get_config(name).vocab_size, 5, seed=3)
    start, want, _, grads = _jax_run(jax_get_config(name), mesh_kw,
                                     batches, **kw)
    outs = _run(ranks, _port_run, get_config(name), mesh_kw, start,
                batches, kw)
    for got, _, _, _ in outs:
        np.testing.assert_allclose(got, want, **TOL)
    _check_rank_shards([o[2] for o in outs], grads)
    _check_start(outs, start)


def test_int8_transport_on_an_sp_mesh_stays_within_jax_bound(
        ranks, cpu_mesh_devices):
    jcfg = dataclasses.replace(jax_get_config("gptj-tiny"), **INT8_CFG)
    tcfg = dataclasses.replace(get_config("gptj-tiny"), **INT8_CFG)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                        jcfg.vocab_size))
    batch = {"input_ids": ids, "loss_mask": np.ones((8, 32), np.float32)}
    mesh_kw = dict(fsdp=2, sp=2)
    start, base, _, _ = _jax_run(jcfg, mesh_kw, [batch] * INT8_STEPS,
                                 quant_block_size=64)
    outs = _run(ranks, _port_run, tcfg, mesh_kw, start,
                [batch] * INT8_STEPS,
                {"grad_transport": "int8", "shard_weight_update": True,
                 "quant_block_size": 64})
    for got, _, _, _ in outs:
        q = [loss for loss, _ in got]
        assert abs(q[-1] - base[-1][0]) < INT8_BOUND, (q, base)
        assert q[-1] < q[0]
        assert got == outs[0][0]


def test_dryrun_at_eight_ranks_runs_body_ep_and_pp_like_jax(
        ranks, cpu_mesh_devices):
    from ray_tpu.ops.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.dryrun import (dryrun_multichip, factor_mesh,
                                               pp_part_inputs)
    assert factor_mesh(8).axis_sizes() == dict(
        pp=1, dp=1, fsdp=2, ep=1, sp=2, tp=2)
    out = dryrun_multichip(DRYRUN_RANKS)
    assert sorted(out.parts) == ["body", "ep", "pp"]
    assert list(out) == out.parts["body"]
    for name in ("body", "ep"):
        losses = out.parts[name]
        assert len(losses) == DRYRUN_RANKS and len(set(losses)) == 1
        assert losses[0] > 0
    # the JAX dry run's pp part from the same weights and input
    w, x = pp_part_inputs()
    mesh = jbuild_mesh(JMeshSpec(pp=4, dp=2), cpu_mesh_devices)

    def loss(p):
        return jnp.sum(pipeline_apply(lambda q, h: jnp.tanh(h @ q["w"]), p,
                                      jnp.asarray(x), mesh, 4) ** 2)
    want_loss, want = jax.value_and_grad(loss)({"w": jnp.asarray(w)})
    pp = out.parts["pp"]
    assert len(pp) == DRYRUN_RANKS
    for loss_r, _ in pp:
        assert loss_r == pytest.approx(float(want_loss), rel=1e-5)
    # rank r is stage r // 2 (pp outermost), both dp replicas alike
    got = np.concatenate([pp[2 * s][1] for s in range(4)])
    for r in range(DRYRUN_RANKS):
        np.testing.assert_array_equal(pp[r][1], pp[r - r % 2][1])
    np.testing.assert_allclose(got, np.asarray(want["w"]), rtol=1e-4,
                               atol=1e-5)
