"""The RLHF PPO learner against the JAX package's, on the CPU.

The port's ``PolicyLearner`` starts from the JAX ``PolicyLearner``'s
params (carried by ``_bridge``) on one seeded batch at the tiny f32
model of ``tests/rlhf/test_rlhf_chaos.py``: loss, ``approx_kl``,
``ratio_mean``, ``grad_norm`` and every gradient leaf agree at 1e-5;
after 3 ``update_from_batch`` steps the params agree at 1e-5 (the clip
and Adam against optax's); a port learner resumed from the JAX learner's
state after 2 steps takes the third step as the JAX one does; and a
``LearnerGroup`` of 2 remote learners on the port's CPU runtime, with
equal shards, reaches the JAX single learner's full-batch weights at
1e-5 with its two replicas bit-identical.
"""

import functools
import os

import jax
import numpy as np
import pytest

from ray_tpu.rlhf.trainer import PolicyLearner as JaxPolicyLearner

import ray_tpu_torch
from ray_tpu_torch._bridge import (params_from_jax, policy_state_from_jax,
                                   to_numpy)
from ray_tpu_torch.rlhf import PolicyLearner
from ray_tpu_torch.rllib import Learner, LearnerGroup

pytestmark = pytest.mark.rlhf

# the runtime's workers stay off the card, as the loaded test bodies' do
os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")

MODEL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
             head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
             dtype="float32", remat_policy="none")
LR = 1e-2          # large enough that 3 Adam steps move every leaf
TOL = 1e-5


def _batch(seed=0, rows=4, plen=12, tlen=6):
    rng = np.random.default_rng(seed)
    return {
        "prompt": rng.integers(2, 64, (rows, plen)).astype(np.int32),
        "tokens": rng.integers(2, 64, (rows, tlen)).astype(np.int32),
        # behaviour log-probabilities near the tiny model's ln(1/64), so
        # that some ratios leave [0.8, 1.2] and the clip takes effect
        "logprobs": (np.log(1 / 64) + rng.normal(0, 0.3, (rows, tlen))
                     ).astype(np.float32),
        "advantages": rng.normal(0, 1, (rows,)).astype(np.float32),
    }


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}.")]
    return [(prefix[:-1], np.asarray(tree))]


def _assert_trees_close(got, want, tol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


#: below the gradients' norm on these batches, so the clip scales
#: every update
GRAD_CLIP = 0.05


@pytest.fixture(scope="module")
def jax_learner():
    """One JAX learner for the file (its jitted gradient program compiles
    once); each test starts it from its initial state."""
    jl = JaxPolicyLearner(MODEL, learning_rate=LR, grad_clip=GRAD_CLIP)
    init = jl._state
    yield jl, init
    jl._state = init


def _pair(jax_learner):
    jl, init = jax_learner
    jl._state = init
    pl = PolicyLearner(MODEL, learning_rate=LR, grad_clip=GRAD_CLIP,
                       device="cpu")
    pl.set_weights(jl.get_weights())
    return jl, pl


def test_loss_metrics_and_gradients_match_jax(jax_learner):
    jl, pl = _pair(jax_learner)
    batch = _batch()
    jg, jm = jl.compute_gradients(batch)
    pg, pm = pl.compute_gradients(batch)
    assert list(pm) == list(jm) == ["approx_kl", "ratio_mean",
                                    "total_loss", "grad_norm"]
    for k in jm:
        assert abs(pm[k] - jm[k]) <= TOL * max(1.0, abs(jm[k])), (k, pm, jm)
    # the batch exercises the clip: ratios on both sides of 1 +- 0.2
    assert jm["grad_norm"] > 0 and abs(jm["ratio_mean"] - 1) < 0.5
    _assert_trees_close(to_numpy(pg), _np(jg))


def test_three_updates_match_optax_clip_and_adam(jax_learner):
    jl, pl = _pair(jax_learner)
    w0 = jl.get_weights()
    for step in range(3):
        batch = _batch(seed=step)
        jm = jl.update_from_batch(batch)
        pm = pl.update_from_batch(batch)
        assert jm["grad_norm"] > GRAD_CLIP
        for k in jm:
            assert abs(pm[k] - jm[k]) <= TOL * max(1.0, abs(jm[k])), \
                (step, k, pm, jm)
    _assert_trees_close(pl.get_weights(), jl.get_weights())
    # the three steps moved the weights
    assert max(np.abs(a - b).max() for (_, a), (_, b) in
               zip(_leaves(w0), _leaves(jl.get_weights()))) > 1e-3


def test_resume_from_a_jax_learner_state(jax_learner):
    jl, _ = _pair(jax_learner)
    for step in range(2):
        jl.update_from_batch(_batch(seed=10 + step))
    pl = PolicyLearner(MODEL, learning_rate=LR, grad_clip=GRAD_CLIP,
                       device="cpu")
    pl.load_state(policy_state_from_jax(_np(jl._state), pl.config, "cpu"))
    assert int(pl._state["opt_state"]["count"]) == 2
    batch = _batch(seed=12)
    jm, pm = jl.update_from_batch(batch), pl.update_from_batch(batch)
    assert abs(pm["total_loss"] - jm["total_loss"]) <= TOL
    _assert_trees_close(pl.get_weights(), jl.get_weights())


def test_policy_learner_needs_the_card_unless_the_cpu_is_named():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyLearner(MODEL)


def test_rlmodule_learner_waits_for_the_rllib_port():
    """The RLModule ``Learner`` is ported (it raised until then): like
    every entry point, it needs the card unless the CPU is named."""
    import torch

    from ray_tpu_torch.rllib.ppo import ppo_loss
    from ray_tpu_torch.rllib.rl_module import RLModuleSpec
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = RLModuleSpec(observation_dim=4, num_actions=2, hiddens=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Learner(spec, ppo_loss)
    learner = Learner(spec, ppo_loss, device="cpu")
    assert learner.device == torch.device("cpu")


def test_two_remote_learners_match_the_jax_single_learner(jax_learner):
    jl, init = jax_learner
    jl._state = init
    w0 = jl.get_weights()
    batch = _batch(seed=20)
    ray_tpu_torch.init(num_cpus=4, _num_initial_workers=2,
                       ignore_reinit_error=True)
    group = None
    try:
        group = LearnerGroup(functools.partial(
            PolicyLearner, MODEL, learning_rate=LR, grad_clip=GRAD_CLIP),
            num_learners=2)
        group.set_weights(w0)
        gm = group.update_from_batch(batch)        # 2 shards of 2 rows
        jm = jl.update_from_batch(batch)
        assert np.isfinite(gm["total_loss"]) and gm["grad_norm"] > 0
        w = [ray_tpu_torch.get(a.get_weights.remote(), timeout=60)
             for a in group._remote]
        for (_, a), (_, b) in zip(_leaves(w[0]), _leaves(w[1])):
            assert np.array_equal(a, b)           # replicas bit-identical
        _assert_trees_close(w[0], jl.get_weights())
        assert jm["grad_norm"] > 0
    finally:
        if group is not None:
            group.shutdown()
        ray_tpu_torch.shutdown()


def test_bridge_carries_params_as_f32_masters(jax_learner):
    jl, _ = _pair(jax_learner)
    pl = PolicyLearner(MODEL, device="cpu")
    tree = params_from_jax(jl.get_weights(), pl.config, "cpu", masters=True)
    pl.load_state({"params": tree, "opt_state": pl._opt.init(tree)})
    _assert_trees_close(pl.get_weights(), jl.get_weights(), tol=0)
