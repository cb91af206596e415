"""The port's training path against the JAX package's, on the CPU in f32.

- ``apply`` and ``lm_loss`` with their gradients at ``gptj-tiny``,
  ``llama2-tiny`` (GQA) and a 2-layer cut of ``entry()``'s config
  (head_dim 128); weights from the JAX package's ``init_params``, carried
  over with ``params_from_jax(..., masters=True)``.
- The remat policies ``"none"``, ``"full"`` and ``"dots"`` give the same
  loss and gradients; ``"dots"`` runs the flash forward once per layer,
  ``"full"`` twice.
- A 20-step ``make_train_step`` trajectory (loss and unclipped grad norm
  at every step) against JAX's on a one-device CPU mesh, and a resume at
  step 10 from ``train_state_from_jax``.
- What is not ported raises (``NotImplementedError``; a JAX ``Mesh`` a
  ``TypeError``); entry points need
  CUDA unless told ``"cpu"``.

On the CPU JAX runs ``attention_reference`` and the port the flash
kernels' plain versions; both fuse the LM head into the chunked loss.
Tolerance 1e-5 (rtol and atol) everywhere: the same f32 arithmetic
summed in another order. Over the 20 steps (clipping active while the
grad norm is above 1) the loss and grad norm drift apart by at most
about 5e-7 relative on a CPU.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch._bridge import (params_from_jax, to_numpy,
                                   train_state_from_jax)
from ray_tpu_torch.models import get_config, make_eval_step, make_train_step
from ray_tpu_torch.models import transformer as ttf

torch.set_num_threads(1)
# the module (the package exports a function of the same name)
flash_mod = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
ENTRY_KW = dict(vocab_size=32128, d_model=512, n_layers=2, n_heads=4,
                head_dim=128, d_ff=2048, max_seq_len=256, rotary_dim=64,
                block_style="gptj", remat=False)


def _configs(name):
    """(JAX config, port config) of one name, both f32."""
    if name == "entry-2l":
        return (jtf.TransformerConfig(dtype=jnp.float32, **ENTRY_KW),
                ttf.TransformerConfig(dtype=torch.float32, **ENTRY_KW))
    return jax_get_config(name), get_config(name)


def _leaves_with_grad(tree):
    return [t.requires_grad_(True) for t in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
                x, torch.Tensor))]


@pytest.mark.parametrize("name,seq", [("gptj-tiny", 24),
                                      ("llama2-tiny", 24),
                                      ("entry-2l", 64)])
def test_apply_and_lm_loss_match_jax(name, seq):
    jcfg, tcfg = _configs(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu", masters=True)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    mask = (rng.random((2, seq)) > 0.2).astype(np.float32)
    batch = {"input_ids": ids, "loss_mask": mask}

    jlogits = jtf.apply(jcfg, jparams, ids)
    tlogits = ttf.apply(tcfg, tparams, torch.tensor(ids))
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits), **TOL)

    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, batch), has_aux=True)(jparams)
    leaves = _leaves_with_grad(tparams)
    tloss, taux = ttf.lm_loss(tcfg, tparams, {
        "input_ids": torch.tensor(ids), "loss_mask": torch.tensor(mask)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert float(taux["n_tokens"]) == float(jaux["n_tokens"])
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_remat_policies_agree_and_dots_saves_the_flash_output(name,
                                                              monkeypatch):
    """Same loss and gradients under "none", "full" and "dots"; the flash
    forward (its plain version on the CPU) runs L times per step under
    "none" and "dots" and 2L under "full"."""
    calls = []
    plain = flash_mod.flash_fwd_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(flash_mod, "flash_fwd_plain", counting)
    cfg = get_config(name)
    params = ttf.init_params(cfg, 0, device="cpu")
    ids = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 20)))
    runs = {}
    for policy in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=None, remat_policy=policy)
        p = jax.tree.map(lambda t: t.clone(), params)
        leaves = _leaves_with_grad(p)
        calls.clear()
        loss, _ = ttf.lm_loss(c, p, {"input_ids": ids})
        grads = torch.autograd.grad(loss, leaves)
        runs[policy] = (loss, grads, len(calls))
    L = cfg.n_layers
    assert [runs[p][2] for p in ("none", "full", "dots")] == [L, 2 * L, L]
    for policy in ("full", "dots"):
        torch.testing.assert_close(runs[policy][0], runs["none"][0], **TOL)
        for g, r in zip(runs[policy][1], runs["none"][1]):
            torch.testing.assert_close(g, r, **TOL)
    for policy in ("dots_all", "offload"):
        with pytest.raises(NotImplementedError):
            ttf.remat_policy_fn(policy)
    with pytest.raises(ValueError):
        ttf.remat_policy_fn("everything")


def _trajectory_setup():
    cfg = jax_get_config("gptj-tiny")
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    bundle = jax_make_train_step(cfg, mesh, learning_rate=1e-3,
                                 weight_decay=0.01, telemetry_interval_s=0)
    rng = np.random.default_rng(5)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32),
        "loss_mask": (rng.random((4, 32)) > 0.1).astype(np.float32)}
        for _ in range(4)]
    return cfg, bundle, batches


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX's 20 steps: losses, grad norms, and the state (as numpy) at
    steps 0 and 10 (taken before the next step donates it)."""
    cfg, bundle, batches = _trajectory_setup()
    state = bundle.init(seed=0)
    snaps, losses, norms = {}, [], []
    for i in range(20):
        if i in (0, 10):
            snaps[i] = jax.tree.map(np.asarray, state)
        state, m = bundle.step(state, batches[i % 4])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return batches, snaps, np.array(losses), np.array(norms)


def _port_run(state, batches, first, last):
    bundle = make_train_step(get_config("gptj-tiny"), learning_rate=1e-3,
                             weight_decay=0.01, device="cpu")
    losses, norms = [], []
    for i in range(first, last):
        state, m = bundle.step(state, batches[i % 4])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, np.array(losses), np.array(norms)


def test_train_trajectory_matches_jax(jax_trajectory):
    batches, snaps, jl, jn = jax_trajectory
    state = train_state_from_jax(snaps[0], get_config("gptj-tiny"), "cpu")
    state, losses, norms = _port_run(state, batches, 0, 20)
    np.testing.assert_allclose(losses, jl, **TOL)
    np.testing.assert_allclose(norms, jn, **TOL)
    assert int(state["step"]) == 20 and int(state["opt_state"]["count"]) == 20
    assert losses[-1] < losses[0]


def test_resume_at_step_10_from_jax_state(jax_trajectory):
    batches, snaps, jl, jn = jax_trajectory
    state = train_state_from_jax(snaps[10], get_config("gptj-tiny"), "cpu")
    assert int(state["step"]) == 10
    np.testing.assert_array_equal(
        to_numpy(state["opt_state"]["mu"])["layers"]["wq"],
        np.asarray(snaps[10]["opt_state"][1][0].mu["layers"]["wq"]))
    _, losses, norms = _port_run(state, batches, 10, 20)
    np.testing.assert_allclose(losses, jl[10:], **TOL)
    np.testing.assert_allclose(norms, jn[10:], **TOL)


def test_eval_step_and_undonated_state():
    cfg = get_config("gptj-tiny")
    """The step updates its state in place; a clone the caller keeps (the
    JAX step's undonated input) stays as it was."""
    bundle = make_train_step(cfg, learning_rate=1e-3, device="cpu")
    state = bundle.init(seed=1)
    kept = jax.tree.map(torch.clone, state)
    before = state["params"]["layers"]["wq"].clone()
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))
    new, m = bundle.step(state, {"input_ids": ids})
    assert new is state
    torch.testing.assert_close(kept["params"]["layers"]["wq"], before,
                               rtol=0, atol=0)
    assert not torch.equal(new["params"]["layers"]["wq"], before)
    assert int(kept["step"]) == 0 and int(new["step"]) == 1
    assert float(m["n_tokens"]) == 2 * 15
    ev = make_eval_step(cfg, device="cpu")(new["params"], {"input_ids": ids})
    loss, _ = ttf.lm_loss(cfg, new["params"],
                          {"input_ids": torch.as_tensor(ids)})
    torch.testing.assert_close(ev["loss"], loss.detach(), **TOL)


def test_flops_and_params_match_jax():
    for name in ("gptj-6b", "llama2-7b", "gptj-tiny"):
        jcfg, tcfg = jax_get_config(name), get_config(name)
        assert tcfg.num_active_params == jcfg.num_active_params
        assert tcfg.flops_per_token() == jcfg.flops_per_token()
        assert tcfg.flops_per_token(512) == jcfg.flops_per_token(512)
    assert get_config("gptj-6b", n_layers=8).num_params == 2_023_777_504


def test_unported_paths_raise():
    """What the port still refuses: the offload remat policy, an unknown
    transport and a JAX ``Mesh`` (of any size). The paths that raised
    before run now: sharded steps, int8 transport and the sharded weight
    update (``tests/test_torch_parallel_training.py``), MoE configs
    (``tests/test_torch_moe.py``; here one step on one device) and the
    sequence and expert axes, with the dry run at 8 ranks, which raises
    only for its pipeline part (``tests/test_torch_parallel_moe_sp.py``).
    """
    cfg = get_config("gptj-tiny")
    moe = make_train_step(get_config("moe-tiny"), device="cpu")
    _, m = moe.step(moe.init(0), {"input_ids": np.ones((2, 8), np.int32)})
    assert np.isfinite(float(m["loss"])) and float(m["moe_aux"]) > 0
    with pytest.raises(NotImplementedError):
        make_train_step(cfg, remat_policy="offload", device="cpu")
    with pytest.raises(ValueError):
        make_train_step(cfg, grad_transport="fp8", device="cpu")
    for mesh in (build_mesh(MeshSpec(dp=8), jax.devices()[:8]),
                 build_mesh(MeshSpec(), jax.devices()[:1])):
        with pytest.raises(TypeError, match="JAX Mesh"):
            make_train_step(cfg, mesh, device="cpu")
        with pytest.raises(TypeError, match="JAX Mesh"):
            make_eval_step(cfg, mesh, device="cpu")


def test_train_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_config("gptj-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg)
    state = make_train_step(cfg, device="cpu").init(seed=0)
    assert state["params"]["layers"]["wq"].dtype == torch.float32
    assert state["opt_state"]["mu"]["embed"].shape == (512, 64)
