"""rllib's offline IO and losses against the JAX package's, on the CPU in
f32 at 1e-5.

Held: ``JsonWriter``/``JsonReader`` across the packages both ways (each
package reads the other's files into the same arrays and samples the
same rows for a seed, in the same order); ``compute_monte_carlo_returns``;
``bc_loss`` and ``marwil_loss`` (MARWIL's weights normalized by the
batch's own RMS advantage, their exponent clipped at +-10) and their
gradients; 20 ``Learner`` updates of each from the JAX module's weights
and moments (``_bridge.rllib_state_from_jax``); BC and MARWIL one
iteration each from the same file, from carried weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.learner import Learner as JaxLearner
from ray_tpu.rllib.offline import JsonReader as JaxReader
from ray_tpu.rllib.offline import JsonWriter as JaxWriter
from ray_tpu.rllib.offline import bc_loss as jax_bc_loss
from ray_tpu.rllib.offline import \
    compute_monte_carlo_returns as jax_mc_returns
from ray_tpu.rllib.offline import marwil_loss as jax_marwil_loss
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec

from ray_tpu_torch._bridge import rllib_state_from_jax
from ray_tpu_torch.rllib import (BC, BCConfig, JsonReader, JsonWriter,
                                 Learner, MARWIL, MARWILConfig)
from ray_tpu_torch.rllib.offline import (bc_loss,
                                         compute_monte_carlo_returns,
                                         marwil_loss)
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from test_torch_rllib_dqn import DISCRETE, close, np_tree, trees_close

LOSSES = {"bc": (jax_bc_loss, bc_loss, {"entropy_coeff": 0.01}),
          "marwil": (jax_marwil_loss, marwil_loss,
                     {"beta": 1.5, "vf_loss_coeff": 0.5})}


def episodes(seed=0, n=6, obs_dim=4, num_actions=3):
    """Episode batches of varying length: obs, actions, rewards, dones."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(3, 9))
        out.append({"obs": rng.normal(size=(t, obs_dim)).astype(np.float32),
                    "actions": rng.integers(0, num_actions, t),
                    "rewards": rng.normal(size=t).astype(np.float32),
                    "dones": np.eye(t, dtype=np.float32)[-1]})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_the_packages(tmp_path, writer):
    w = (JaxWriter if writer == "jax" else JsonWriter)(str(tmp_path))
    eps = episodes()
    for e in eps:
        w.write(e)
    w.close()
    jr, tr = JaxReader(str(tmp_path), seed=4), JsonReader(str(tmp_path),
                                                          seed=4)
    assert tr.num_samples == jr.num_samples == sum(len(e["obs"])
                                                   for e in eps)
    for k in jr._data:
        np.testing.assert_array_equal(tr._data[k], jr._data[k])
        np.testing.assert_array_equal(
            tr._data[k], np.concatenate([e[k] for e in eps]))
    for got, want in ((tr.sample(10), jr.sample(10)),
                      *zip(tr.iter_epochs(7), jr.iter_epochs(7))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_monte_carlo_returns():
    e = episodes(1, n=1)[0]
    rng = np.random.default_rng(2)
    r = rng.normal(size=20).astype(np.float32)
    d = (rng.random(20) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(compute_monte_carlo_returns(r, d, 0.9),
                                  jax_mc_returns(r, d, 0.9))
    assert e["dones"][-1] == 1.0


def _batch(rng, n=32):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 3, n),
            "returns": (3 * rng.normal(size=n)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_gradients(name):
    """The loss, its metrics and its gradients on the same weights; the
    MARWIL batch's advantages are large enough that the +-10 clip of the
    exponent acts."""
    jax_loss, loss, kw = LOSSES[name]
    jl = JaxLearner(JaxSpec(**DISCRETE), jax_loss, loss_config=kw)
    params = np_tree(jl._state["params"])
    b = _batch(np.random.default_rng(3))
    if name == "marwil":
        b["returns"][:4] = [40.0, -40.0, 35.0, -35.0]
    module = JaxSpec(**DISCRETE).build()

    def jax_total(p):
        out = module.forward_train(p, jnp.asarray(b["obs"]))
        return jax_loss(out, {k: jnp.asarray(v) for k, v in b.items()}, **kw)

    (jtot, jm), jg = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tmod = RLModuleSpec(**DISCRETE).build()
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    tb = {"obs": torch.tensor(b["obs"]),
          "actions": torch.tensor(b["actions"]),
          "returns": torch.tensor(b["returns"])}
    ttot, tm = loss(tmod.forward_train(tp, tb["obs"]), tb, **kw)
    ttot.backward()
    close(float(ttot.detach()), float(jtot))
    for k in jm:
        close(float(tm[k].detach()), float(jm[k]))
    # BC's loss does not reach the value head: JAX's gradient is zero there
    trees_close(jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                             if t.grad is None else t.grad.numpy(), tp),
                np_tree(jg))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_twenty_learner_updates_match_jax(name):
    jax_loss, loss, kw = LOSSES[name]
    jl = JaxLearner(JaxSpec(**DISCRETE), jax_loss, learning_rate=1e-2,
                    grad_clip=0.5, seed=1, loss_config=kw)
    tl = Learner(RLModuleSpec(**DISCRETE), loss, learning_rate=1e-2,
                 grad_clip=0.5, seed=1, loss_config=kw, device="cpu")
    tl.load_state(rllib_state_from_jax(np_tree(jl._state), "cpu"))
    rng = np.random.default_rng(5)
    for _ in range(20):
        b = _batch(rng)
        jm, tm = jl.update_from_batch(b), tl.update_from_batch(b)
        for k in jm:
            close(tm[k], jm[k])
    trees_close(tl.get_weights(), jl.get_weights())


@pytest.mark.parametrize("algo", ["BC", "MARWIL"])
def test_one_iteration_from_a_file_matches_jax(tmp_path, algo):
    """An iteration of BC or MARWIL on the CPU from the same file and the
    same weights: the reader's rows, the returns MARWIL adds, the
    update's metrics and the weights after it equal the JAX
    algorithm's."""
    import ray_tpu.rllib as jrl
    w = JsonWriter(str(tmp_path))
    for e in episodes(7, n=10):
        w.write(e)
    w.close()

    def config(cls):
        c = cls().training(lr=1e-2, train_batch_size=24,
                           model={"fcnet_hiddens": (16, 16)})
        c.offline_data = str(tmp_path)
        return c.debugging(seed=2)
    port_cfg = config(BCConfig if algo == "BC" else MARWILConfig)
    port_cfg.learner_device = "cpu"
    ja = getattr(jrl, algo)(config(getattr(jrl, algo + "Config")))
    ta = (BC if algo == "BC" else MARWIL)(port_cfg)
    try:
        for k in ja.reader._data:
            close(ta.reader._data[k], ja.reader._data[k], 1e-6)
        w0 = ja.learner_group.get_weights()
        ta.learner_group.set_weights(np_tree(w0))
        jr, tr = ja.train(), ta.train()
        for k in jr["learner"]:
            close(tr["learner"][k], jr["learner"][k])
        trees_close(ta.learner_group.get_weights(),
                    ja.learner_group.get_weights())
    finally:
        ja.cleanup()
        ta.cleanup()
