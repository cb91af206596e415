"""The port's cross entropy against the JAX package's, on the CPU in f32:
``cross_entropy_loss`` on materialized logits and the chunked
``fused_lm_head_loss`` (loss and gradients of x, the head matrix and
its bias), over chunk sizes that divide the sequence, leave a ragged
last chunk, or exceed it, with and without z-loss and a mask. Inputs
come from ``numpy.random.default_rng``.

Tolerance 1e-5 (rtol and atol): the same f32 arithmetic summed in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.cross_entropy import cross_entropy_loss as jax_ce
from ray_tpu.ops.cross_entropy import fused_lm_head_loss as jax_fused
from ray_tpu_torch.ops import cross_entropy_loss, fused_lm_head_loss

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("z", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(z, masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 8, 32), dtype=np.float32) * 3
    labels = rng.integers(0, 32, (4, 8)).astype(np.int32)
    mask = (rng.random((4, 8)) > 0.4).astype(np.float32) if masked else None

    def f(lg):
        return jax_ce(lg, labels, mask=mask, z_loss_coeff=z)
    (jloss, jn), vjp = jax.vjp(f, logits)
    jgrad = vjp((jnp.ones(()), jnp.zeros(())))[0]
    tl = _t(logits, True)
    loss, n = cross_entropy_loss(tl, _t(labels),
                                 mask=None if mask is None else _t(mask),
                                 z_loss_coeff=z)
    (grad,) = torch.autograd.grad(loss, tl)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert float(n) == float(jn)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("chunk", [5, 13, 64])
@pytest.mark.parametrize("z", [0.0, 1e-3])
def test_fused_lm_head_loss_matches_jax(chunk, z):
    """x (2, 40, 16) against a (16, 64) head with bias and a mask: chunk 5
    divides the sequence, 13 leaves a ragged last chunk, 64 exceeds it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 16), dtype=np.float32)
    w = rng.standard_normal((16, 64), dtype=np.float32) * 0.5
    bias = rng.standard_normal(64, dtype=np.float32) * 0.1
    labels = rng.integers(0, 64, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) > 0.25).astype(np.float32)

    def f(x, w, b):
        return jax_fused(x, w, labels, head_bias=b, mask=mask,
                         z_loss_coeff=z, chunk_size=chunk)
    (jloss, jn), vjp = jax.vjp(f, x, w, bias)
    jgrads = vjp((jnp.ones(()), jnp.zeros(())))
    tx, tw, tb = _t(x, True), _t(w, True), _t(bias, True)
    loss, n = fused_lm_head_loss(tx, tw, _t(labels), head_bias=tb,
                                 mask=_t(mask), z_loss_coeff=z,
                                 chunk_size=chunk)
    grads = torch.autograd.grad(loss, (tx, tw, tb))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert float(n) == float(jn)
    for name, g, jg in zip(("dx", "dw", "db"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


def test_fused_without_bias_or_mask_matches_materialized():
    """No head bias (Llama) and no mask: the fused loss equals the
    reference on materialized logits, value and gradients, and JAX's."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 21, 8), dtype=np.float32)
    w = rng.standard_normal((8, 48), dtype=np.float32)
    labels = rng.integers(0, 48, (3, 21)).astype(np.int32)
    tx, tw = _t(x, True), _t(w, True)
    loss, n = fused_lm_head_loss(tx, tw, _t(labels), chunk_size=8)
    grads = torch.autograd.grad(loss, (tx, tw))
    ref, rn = cross_entropy_loss(tx @ tw, _t(labels))
    ref_grads = torch.autograd.grad(ref, (tx, tw))
    torch.testing.assert_close(loss, ref, **TOL)
    assert float(n) == float(rn) == 63.0
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **TOL)
    jloss, _ = jax_fused(x, w, labels, chunk_size=8)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
