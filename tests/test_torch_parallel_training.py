"""The port's sharded train step against the JAX package's, on the CPU.

Four gloo ranks (actors of the port's runtime) run ``make_train_step``
over a mesh in f32, with weights and optimizer state from the JAX
package's own init carried over by ``_bridge.shard_train_state_from_jax``
(rank ``i`` takes JAX device ``i``'s shards); the JAX step runs over the
same mesh on four CPU devices. Tolerance 1e-5 (rtol and atol) for f32:

- 5 steps on (fsdp 2, tp 2) at ``gptj-tiny`` and ``llama2-tiny`` (GQA,
  whose wk/wv gradients are summed over tp): loss and grad norm at every
  step, and the params gathered from every rank after the last;
- 3 steps of ``DDP_RULES`` on (dp 2, tp 2);
- ``shard_weight_update`` from a JAX flat state against JAX's flat run,
  and against the port's replicated run (JAX's own claim);
- ``grad_transport="int8"`` (real int8 on both legs, where JAX adds one
  leg's error with ``fake_quant``) within JAX's acceptance bound
  (``tests/models/test_sharded_update.py``: |loss - fp32 loss| < 1e-2 at
  step 20, still learning), its wire bytes equal to ``tree_wire_bytes``
  of the reductions it makes;
- the sharded init is a slice of the one-device init, ``"dots"`` remat
  matches ``"none"`` through the collectives, ``apply`` and the eval
  step match one device, the dry-run twin passes at n = 4, and what is
  not ported (``pp > 1``) or not the port's (a JAX ``Mesh``) raises.
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
from ray_tpu.parallel import sharding as jsh
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu_torch.models import get_config, make_train_step

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4
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
    ray_tpu_torch.init(num_cpus=W + 8, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(W, "gloo", group_name="train-tests")
        yield actors
    finally:
        stop_ranks(actors)
        ray_tpu_torch.shutdown()


def _run(ranks, fn, *args):
    """``fn`` on every rank, the results copied out of the store. The
    runtime pickles a function of an importable module by reference, and
    the workers cannot import this test module: the lambda goes through
    cloudpickle, which sends ``fn`` by value (the module is registered)."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    return copy.deepcopy(run_on_ranks(
        ranks, lambda rank, *a: fn(rank, *a), *args))


def _batches(vocab, n, rows=4, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, seq)).astype(
                np.int32),
             "loss_mask": (rng.random((rows, seq)) > 0.2).astype(
                 np.float32)} for _ in range(n)]


def _jax_run(cfg, mesh_kw, batches, rules=None, **kw):
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), jax.devices()[:W])
    bundle = jax_make_train_step(cfg, mesh, rules=rules, learning_rate=1e-3,
                                 **kw)
    state = bundle.init(seed=0)
    start = jax.tree.map(np.asarray, state)
    out = []
    for b in batches:
        state, m = bundle.step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return start, out, jax.tree.map(np.asarray, state["params"])


def _port_run(rank, cfg, mesh_kw, rules_name, state_np, batches, kw):
    from ray_tpu_torch._bridge import (gather_to_numpy,
                                       shard_train_state_from_jax)
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    rules = getattr(sharding, rules_name)
    mesh = build_mesh(MeshSpec(**mesh_kw), device_type="cpu")
    bundle = make_train_step(cfg, mesh, rules, learning_rate=1e-3,
                             device="cpu", **kw)
    state = shard_train_state_from_jax(
        state_np, cfg, mesh, rules, device="cpu",
        shard_weight_update=kw.get("shard_weight_update", False),
        quant_block_size=kw.get("quant_block_size", 256))
    out = []
    for b in batches:
        state, m = bundle.step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, gather_to_numpy(state["params"], cfg, mesh, rules)


def _assert_params(got, want):
    for path, v in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for p in path:
            t = t[p.key]
        np.testing.assert_allclose(t, v, **TOL, err_msg=str(path))


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_five_steps_on_fsdp2_tp2_match_jax(ranks, cpu_mesh_devices, name):
    batches = _batches(jax_get_config(name).vocab_size, 5)
    start, want, params = _jax_run(jax_get_config(name),
                                   dict(fsdp=2, tp=2), batches)
    outs = _run(ranks, _port_run, get_config(name), dict(fsdp=2, tp=2),
                "FSDP_RULES", start, batches, {})
    for got, gathered in outs:
        np.testing.assert_allclose(got, want, **TOL)
        _assert_params(gathered, params)


def test_ddp_rules_on_dp2_tp2_match_jax(ranks, cpu_mesh_devices):
    batches = _batches(512, 3)
    start, want, params = _jax_run(jax_get_config("gptj-tiny"),
                                   dict(dp=2, tp=2), batches,
                                   rules=jsh.DDP_RULES)
    outs = _run(ranks, _port_run, get_config("gptj-tiny"), dict(dp=2, tp=2),
                "DDP_RULES", start, batches, {})
    for got, gathered in outs:
        np.testing.assert_allclose(got, want, **TOL)
        _assert_params(gathered, params)


def test_shard_weight_update_matches_jax_and_the_replicated_run(
        ranks, cpu_mesh_devices):
    batches = _batches(512, 4)
    cfg = jax_get_config("gptj-tiny")
    start, want, params = _jax_run(cfg, dict(fsdp=2, tp=2), batches,
                                   shard_weight_update=True)
    flat = _run(ranks, _port_run, get_config("gptj-tiny"),
                dict(fsdp=2, tp=2), "FSDP_RULES", start, batches,
                {"shard_weight_update": True})
    rep_start, _, _ = _jax_run(cfg, dict(fsdp=2, tp=2), batches[:0])
    rep = _run(ranks, _port_run, get_config("gptj-tiny"),
               dict(fsdp=2, tp=2), "FSDP_RULES", rep_start, batches, {})
    for (got, gathered), (rgot, rgathered) in zip(flat, rep):
        np.testing.assert_allclose(got, want, **TOL)
        _assert_params(gathered, params)
        np.testing.assert_allclose(got, rgot, **TOL)
        _assert_params(gathered, rgathered)


def _int8_on_rank(rank, cfg, state_np, batch, steps):
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.models.training import int8_wire_lengths
    from ray_tpu_torch.parallel import collective
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.quantization import tree_wire_bytes
    from ray_tpu_torch._bridge import shard_train_state_from_jax
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    sent = []
    run = collective._run

    def counting(op, fn, out, *inputs, pg):
        if op == "all_to_all":          # the scatter leg's int8 and scales
            sent.append(inputs[0].numel() * inputs[0].element_size())
        run(op, fn, out, *inputs, pg=pg)
    out = {}
    for swu in (False, True):
        bundle = make_train_step(cfg, mesh, learning_rate=1e-3,
                                 device="cpu", grad_transport="int8",
                                 shard_weight_update=swu,
                                 quant_block_size=64)
        state = shard_train_state_from_jax(state_np, cfg, mesh,
                                           device="cpu")
        if swu:      # the flat layout's moments start at zero as JAX's
            state["opt_state"] = bundle.init(0)["opt_state"]
        losses = []
        del sent[:]
        collective._run = counting
        try:
            for _ in range(steps):
                state, m = bundle.step(state, batch)
                losses.append(float(m["loss"]))
        finally:
            collective._run = run
        out[swu] = {"losses": losses, "sent": sum(sent),
                    "want": steps * tree_wire_bytes(
                        int8_wire_lengths(cfg, mesh, None, swu, 64), 64)}
    return out


def test_int8_transport_stays_within_jax_bound(ranks, cpu_mesh_devices):
    jcfg = dataclasses.replace(jax_get_config("gptj-tiny"), **INT8_CFG)
    tcfg = dataclasses.replace(get_config("gptj-tiny"), **INT8_CFG)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                        jcfg.vocab_size))
    batch = {"input_ids": ids, "loss_mask": np.ones((8, 32), np.float32)}
    start, base, _ = _jax_run(jcfg, dict(fsdp=2, tp=2),
                              [batch] * INT8_STEPS, quant_block_size=64)
    outs = _run(ranks, _int8_on_rank, tcfg, start, batch, INT8_STEPS)
    for out in outs:
        for swu in (False, True):
            q = out[swu]["losses"]
            assert abs(q[-1] - base[-1][0]) < INT8_BOUND, (swu, q, base)
            assert q[-1] < q[0]            # still learning
            assert out[swu]["sent"] == out[swu]["want"] > 0
        assert out[True]["losses"] == outs[0][True]["losses"]


def _init_and_apply_on_rank(rank, cfg, ids):
    from ray_tpu_torch._bridge import gather_to_numpy
    from ray_tpu_torch.models import apply, init_params, lm_loss
    from ray_tpu_torch.models import make_eval_step, make_train_step
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel import shard_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    bundle = make_train_step(cfg, mesh, device="cpu")
    params = bundle.init(3)["params"]
    full = init_params(cfg, 3, "cpu")
    want = shard_params(full, logical_axes(cfg), FSDP_RULES, mesh)
    same = all(torch.equal(a, b)
               for a, b in zip(_leaves(params), _leaves(want)))
    batch = bundle.local_batch({"input_ids": ids})
    logits = apply(cfg, params, batch["input_ids"], mesh=mesh)
    out = {"init_is_a_slice": same, "logits": logits.detach().numpy(),
           "gathered_init_is_full": all(
               np.array_equal(a, b.numpy()) for a, b in zip(
                   _leaves(gather_to_numpy(params, cfg, mesh)),
                   _leaves(full)))}
    for policy in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=None, remat_policy=policy,
                                ce_chunk_size=8)
        leaves = [t.requires_grad_() for t in _leaves(params)]
        loss, _ = lm_loss(c, params, batch, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        out[policy] = (float(loss), [g.numpy() for g in grads])
    c0 = dataclasses.replace(cfg, ce_chunk_size=0)
    out["materialized"] = float(lm_loss(c0, params, batch, mesh=mesh)[0])
    out["eval"] = float(make_eval_step(cfg, mesh, device="cpu")(
        params, {"input_ids": ids})["loss"])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def test_sharded_init_apply_remat_and_eval_match_one_device(ranks):
    from ray_tpu_torch.models import apply, init_params, lm_loss
    cfg = get_config("gptj-tiny")
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 20))
    outs = _run(ranks, _init_and_apply_on_rank, cfg, ids)
    full = init_params(cfg, 3, "cpu")
    logits = apply(cfg, full, torch.tensor(ids)).detach().numpy()
    loss = float(lm_loss(cfg, full, {"input_ids": torch.tensor(ids)})[0])
    for r, out in enumerate(outs):
        assert out["init_is_a_slice"] and out["gathered_init_is_full"]
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)     # data rank's rows
        np.testing.assert_allclose(out["logits"], logits[rows], **TOL)
        for policy in ("dots", "full"):
            assert out[policy][0] == pytest.approx(out["none"][0],
                                                   rel=1e-6)
            for a, b in zip(out[policy][1], out["none"][1]):
                np.testing.assert_allclose(a, b, **TOL)
        assert out["none"][0] == pytest.approx(loss, rel=1e-5)
        assert out["materialized"] == pytest.approx(loss, rel=1e-5)
        assert out["eval"] == pytest.approx(loss, rel=1e-5)


def _refused_on_rank(rank):
    from ray_tpu_torch.models import get_config, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec(pp=2, tp=2), device_type="cpu")
    try:
        make_train_step(get_config("gptj-tiny"), mesh, device="cpu")
    except NotImplementedError as e:
        return str(e)
    return None


def test_what_is_not_ported_raises(ranks, cpu_mesh_devices):
    """A ``pp`` axis over 1 and the dry run's pp part at 8 ranks (ROADMAP
    Queue 1 item 9; the sequence and expert axes run since item 8, and
    ``tests/test_torch_parallel_moe_sp.py`` holds the dry run's body and
    ep part), and what is not the port's (a JAX ``Mesh``, the
    communication knobs without a mesh)."""
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip
    assert all("item 9" in msg for msg in _run(ranks, _refused_on_rank))
    with pytest.raises(NotImplementedError, match="item 9"):
        dryrun_multichip(8)
    cfg = get_config("gptj-tiny")
    jmesh = jbuild_mesh(JMeshSpec(dp=8), cpu_mesh_devices)
    with pytest.raises(TypeError, match="JAX Mesh"):
        make_train_step(cfg, jmesh, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, grad_transport="int8", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, shard_weight_update=True, device="cpu")


def test_dryrun_twin_passes_at_four_ranks(ranks):
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip, factor_mesh
    from __graft_entry__ import _factor_mesh
    for n in (1, 2, 4, 8, 16):
        assert factor_mesh(n).axis_sizes() == _factor_mesh(n).axis_sizes()
    losses = dryrun_multichip(4)
    assert len(losses) == 4 and len(set(losses)) == 1 and losses[0] > 0
