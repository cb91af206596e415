"""The port's mixture-of-experts (``ray_tpu_torch/models/moe.py``) and the
MoE model on one device, against the JAX package's, on the CPU in f32.

- ``moe_mlp``: the output, the aux term and the gradients of
  ``sum(out * w) + 3 * aux`` with respect to ``h`` and the three leaves,
  at ``moe-tiny`` and at ``capacity_factor=0.5``, where tokens are
  dropped (a token's slot counts the tokens before it in ``(batch,
  seq)`` order);
- ``moe-tiny``'s ``apply`` (with the aux term) and ``lm_loss`` with its
  gradients, in both block styles (JAX's registry has the GPT-J one; its
  model builds the llama one too), weights from the JAX package's
  ``init_params``;
- 5 ``make_train_step`` steps against JAX's on a one-device CPU mesh;
- the init's shapes and tree, ``logical_axes``, ``num_params``,
  ``num_active_params`` and ``flops_per_token`` equal JAX's.

Tolerance 1e-5 (rtol and atol). ``test_moe_forward_routes_and_conserves``
(``tests/models/test_moe_pipeline.py``) draws its inputs with
``jax.random`` and calls ``moe_mlp`` on JAX arrays, so the loader cannot
run it on the port; its checks (shape, finite values, an aux term near
its minimum of 1 at random routing) run here on the same numpy inputs
as the JAX function's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import transformer as jtf
from ray_tpu.models.moe import moe_mlp as jax_moe_mlp
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch._bridge import params_from_jax, train_state_from_jax
from ray_tpu_torch.models import get_config, make_train_step
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.moe import (moe_logical_axes, moe_mlp,
                                      moe_param_shapes)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(capacity_factor=1.25, block_style="gptj"):
    kw = dict(capacity_factor=capacity_factor, block_style=block_style)
    return (dataclasses.replace(jax_get_config("moe-tiny"), **kw),
            dataclasses.replace(get_config("moe-tiny"), **kw))


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_mlp_matches_jax(capacity_factor):
    jcfg, tcfg = _configs(capacity_factor)
    rng = np.random.default_rng(0)
    lp = {"moe_wg": 0.3 * rng.standard_normal((64, 4)),
          "moe_wi": 0.1 * rng.standard_normal((4, 64, 128)),
          "moe_wo": 0.1 * rng.standard_normal((4, 128, 64))}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal((2, 16, 64)).astype(np.float32)

    def jax_loss(lp, h):
        out, aux = jax_moe_mlp(jcfg, lp, h)
        return jnp.sum(out * w) + 3.0 * aux, (out, aux)
    (_, (jout, jaux)), (jg_lp, jg_h) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(h))

    tlp = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h, requires_grad=True)
    out, aux = moe_mlp(tcfg, tlp, th)
    loss = (out * torch.tensor(w)).sum() + 3.0 * aux
    grads = torch.autograd.grad(loss, [th] + list(tlp.values()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_h), **TOL)
    for name, g in zip(tlp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_lp[name]),
                                   **TOL, err_msg=name)
    # the JAX body's own checks: shape, finite, aux near its minimum
    assert out.shape == th.shape and torch.isfinite(out).all()
    assert 0.9 < aux.item() < 2.5


def test_capacity_drops_tokens_in_batch_then_sequence_order():
    """At a capacity of one token an expert keeps only the first token
    routed to it, in (batch, seq) order; every other output is zero."""
    _, tcfg = _configs(capacity_factor=4 / 12)     # capacity 1 of 12
    rng = np.random.default_rng(1)
    lp = {"moe_wg": torch.tensor(rng.standard_normal((64, 4)),
                                 dtype=torch.float32),
          "moe_wi": torch.tensor(rng.standard_normal((4, 64, 128)),
                                 dtype=torch.float32),
          "moe_wo": torch.tensor(rng.standard_normal((4, 128, 64)),
                                 dtype=torch.float32)}
    h = torch.tensor(rng.standard_normal((2, 6, 64)), dtype=torch.float32)
    out, _ = moe_mlp(tcfg, lp, h)
    expert = (h.reshape(12, 64) @ lp["moe_wg"]).argmax(-1).tolist()
    first = {e: expert.index(e) for e in set(expert)}
    kept = (out.reshape(12, 64).abs().sum(-1) > 0).tolist()
    assert kept == [first[e] == i for i, e in enumerate(expert)]


@pytest.mark.parametrize("block_style", ["gptj", "llama"])
def test_apply_and_lm_loss_match_jax(block_style):
    jcfg, tcfg = _configs(0.5, block_style)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu", masters=True)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)
    batch = {"input_ids": ids, "loss_mask": mask}

    jlogits, jaux = jtf.apply(jcfg, jparams, ids, return_moe_aux=True)
    tlogits, taux = ttf.apply(tcfg, tparams, torch.tensor(ids),
                              return_moe_aux=True)
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)

    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, batch), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for t in _leaves(tparams)]
    tloss, taux = ttf.lm_loss(tcfg, tparams, {
        "input_ids": torch.tensor(ids), "loss_mask": torch.tensor(mask)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(taux["moe_aux"].item(),
                               float(jaux["moe_aux"]), **TOL)
    assert float(taux["n_tokens"]) == float(jaux["n_tokens"])
    assert taux["moe_dropped"].shape == (tcfg.n_layers,)
    assert (taux["moe_dropped"] > 0).all()         # capacity 0.5 drops
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def test_five_train_steps_match_jax():
    jcfg, tcfg = _configs()
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    bundle = jax_make_train_step(jcfg, mesh, learning_rate=1e-3,
                                 telemetry_interval_s=0)
    rng = np.random.default_rng(5)
    batches = [{"input_ids": rng.integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32),
        "loss_mask": (rng.random((4, 32)) > 0.1).astype(np.float32)}
        for _ in range(5)]
    state = bundle.init(seed=0)
    start = jax.tree.map(np.asarray, state)
    want = []
    for b in batches:
        state, m = bundle.step(state, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    tb = make_train_step(tcfg, learning_rate=1e-3, device="cpu")
    tstate = train_state_from_jax(start, tcfg, "cpu")
    got = []
    for b in batches:
        tstate, m = tb.step(tstate, b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
        # two layers' terms, each within the JAX body's bounds
        assert 2 * 0.9 < float(m["moe_aux"]) < 2 * 2.5
    np.testing.assert_allclose(got, want, **TOL)
    assert int(tstate["step"]) == 5


def test_init_axes_and_counts_match_jax():
    for block_style in ("gptj", "llama"):
        jcfg, tcfg = _configs(block_style=block_style)
        jshapes = jax.tree.map(lambda x: tuple(x.shape), jtf.init_params(
            jcfg, jax.random.PRNGKey(0)))
        assert ttf.param_shapes(tcfg) == jshapes
        assert jax.tree.map(lambda t: tuple(t.shape), ttf.init_params(
            tcfg, 0, device="cpu"), is_leaf=lambda x: isinstance(
                x, torch.Tensor)) == jshapes
        assert ttf.logical_axes(tcfg) == jtf.logical_axes(jcfg)
        assert tcfg.num_params == jcfg.num_params
        assert tcfg.num_active_params == jcfg.num_active_params
        assert tcfg.flops_per_token() == jcfg.flops_per_token()
        assert tcfg.flops_per_token(512) == jcfg.flops_per_token(512)
    assert moe_param_shapes(tcfg) == {"moe_wg": (64, 4),
                                      "moe_wi": (4, 64, 128),
                                      "moe_wo": (4, 128, 64)}
    assert set(moe_logical_axes()) == set(moe_param_shapes(tcfg))
    big = get_config("gptj-6b", n_experts=4)
    assert big.num_active_params == \
        big.num_params - big.n_layers * 3 * 2 * 4096 * 16384
