"""The port's flash attention on the CPU against the JAX package's.

On the CPU the port's wrappers run their kernels' plain PyTorch versions
(the CUDA kernels have no CPU mode; ``test_torch_kernels_gpu.py`` holds
them against these on the card). The JAX side runs its Pallas kernels in
interpret mode, as its own tests do: the forward (O and the LSE of
``_fwd_pallas``) and the delta kernel in every case; the backward against
``backward="xla"`` (the lax.scan formulation) in every case and against
the Pallas dq/dk/dv kernels in one small case, since interpret mode is
slow there. Inputs come from ``numpy.random.default_rng``, f32.

Tolerance 1e-5 (rtol and atol): the same f32 arithmetic summed in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import attention_reference as jax_reference
from ray_tpu.ops.flash_attention import _Cfg, _delta_pallas, _fwd_pallas
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import (attention_reference, flash_attention,
                               multihead_attention)
from ray_tpu_torch.ops.flash_attention import (flash_delta, flash_dkdv,
                                               flash_dq, flash_fwd)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
WRAPPERS = (flash_fwd, flash_delta, flash_dkdv, flash_dq)
# (causal, sq, sk): self-attention both ways and end-aligned sq < sk
CASES = [(False, 128, 128), (True, 128, 128), (True, 64, 192)]


def _inputs(seed, sq, sk, b=1, h=2, d=64):
    """(B, H, S, D) f32 arrays, the JAX flash layout."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, sk, d), dtype=np.float32)
    do = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    return q, k, v, do


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _launches():
    return [w.kernel_launches for w in WRAPPERS]


@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_forward_and_lse_match_jax_interpret(causal, sq, sk):
    q, k, v, _ = _inputs(1, sq, sk)
    cfg = _Cfg(causal=causal, sm_scale=1 / 8.0, block_q=64, block_k=64,
               interpret=True)
    jo, jlse = _fwd_pallas(cfg, q, k, v)
    jo_api = jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                       interpret=True)
    before = _launches()
    o, lse = flash_fwd(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                       _t(v).transpose(1, 2), causal=causal)
    assert _launches() == before                # CPU: the plain version
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(jo),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jo_api),
                               **TOL)


@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_backward_matches_jax_xla_vjp(causal, sq, sk):
    q, k, v, do = _inputs(2, sq, sk)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                         interpret=True, backward="xla")
    _, vjp = jax.vjp(f, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    before = _launches()
    out = flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    assert _launches() == before
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


def test_backward_matches_jax_pallas_kernels():
    """One small case against the Pallas dq/dk/dv kernels themselves
    (1 x 2 x 128 x 64, blocks 64, causal) and their delta kernel."""
    q, k, v, do = _inputs(3, 128, 128)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=True, block_q=64, block_k=64,
                         interpret=True, backward="pallas")
    o, vjp = jax.vjp(f, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    cfg = _Cfg(causal=True, sm_scale=1 / 8.0, block_q=64, block_k=64,
               interpret=True)
    jdelta = _delta_pallas(cfg, o, jnp.asarray(do))[:, :, 0, :]
    tdelta = flash_delta(_t(np.asarray(o)).transpose(1, 2).contiguous(),
                         _t(do).transpose(1, 2).contiguous())
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), **TOL)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = flash_attention(tq, tk, tv, causal=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,sq,sk", [(False, 128, 128), (True, 64, 192)])
def test_bf16_backward_on_cpu_runs_plain_with_zero_launches(causal, sq, sk):
    """bf16 tensors on the CPU: :func:`flash_dkdv` and :func:`flash_dq`
    run their plain versions (no launch; on the card bf16 goes to the
    sm_90 kernels) and return bf16 gradients that match JAX's backward on
    the same bf16-rounded values up to the rounding of the outputs to
    bf16 (2^-9 relative; held at 1e-2 of each tensor's largest entry)."""
    bf = [torch.tensor(np.swapaxes(a, 1, 2)).to(torch.bfloat16)
          for a in _inputs(10, sq, sk)]              # [B, S, H, D]
    q32, k32, v32, do32 = (x.float() for x in bf)
    o, lse = flash_fwd(q32, k32, v32, causal=causal)
    delta = flash_delta(o, do32)
    before = _launches()
    dk, dv = flash_dkdv(*bf, lse, delta, causal=causal)
    dq = flash_dq(*bf, lse, delta, causal=causal)
    assert _launches() == before
    assert [g.dtype for g in (dq, dk, dv)] == [torch.bfloat16] * 3

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                         interpret=True, backward="xla")
    _, vjp = jax.vjp(f, *(np.swapaxes(x.numpy(), 1, 2)
                          for x in (q32, k32, v32)))
    jgrads = vjp(jnp.asarray(np.swapaxes(do32.numpy(), 1, 2)))
    for name, g, jg in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        want = np.swapaxes(np.asarray(jg), 1, 2)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_dispatch_runs_plain_with_zero_launches(causal):
    """``multihead_attention(impl="auto")`` on a CPU tensor goes through
    the flash op's plain versions (no launch) and agrees, value and
    gradients, with the reference path and with JAX's reference."""
    q, k, v, do = (np.swapaxes(a, 1, 2) for a in _inputs(4, 96, 96))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    before = _launches()
    out = multihead_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    assert _launches() == before
    ref = multihead_attention(tq, tk, tv, causal=causal, impl="reference")
    ref_grads = torch.autograd.grad(ref, (tq, tk, tv), _t(do))
    jref = jax_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jref), **TOL)
    torch.testing.assert_close(out, ref, **TOL)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, **TOL)


def test_kernel_impl_on_cpu_raises():
    q, k, v, _ = (np.swapaxes(a, 1, 2) for a in _inputs(5, 32, 32))
    for impl in ("kernel", "flash"):
        with pytest.raises(ValueError, match="CUDA"):
            multihead_attention(_t(q), _t(k), _t(v), causal=True, impl=impl)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multihead_attention(_t(q), _t(k), _t(v), impl="xla")


def test_causal_rows_before_the_first_key_are_rejected():
    """A causal call with sq > sk leaves rows that see no key: the flash
    path rejects it on every device; the reference path (and an explicit
    mask) still computes what JAX's reference does."""
    q, k, v, _ = (np.swapaxes(a, 1, 2) for a in _inputs(6, 64, 32))
    k, v = k[:, :32], v[:, :32]
    with pytest.raises(ValueError, match="sq <= sk"):
        multihead_attention(_t(q), _t(k), _t(v), causal=True)
    with pytest.raises(ValueError, match="sq <= sk"):
        flash_fwd(_t(q), _t(k), _t(v), causal=True)
    ref = multihead_attention(_t(q), _t(k), _t(v), causal=True,
                              impl="reference")
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jax_reference(q, k, v, causal=True)), **TOL)


def test_explicit_mask_takes_the_reference_path():
    q, k, v, _ = (np.swapaxes(a, 1, 2) for a in _inputs(7, 16, 16))
    mask = np.random.default_rng(8).random((1, 1, 16, 16)) > 0.3
    mask[..., 0] = True
    before = _launches()
    got = multihead_attention(_t(q), _t(k), _t(v), mask=torch.tensor(mask))
    assert _launches() == before
    want = jax_reference(q, k, v, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(
        got, attention_reference(_t(q), _t(k), _t(v),
                                 mask=torch.tensor(mask)), **TOL)


def test_block_sizes_are_the_kernels_tiles():
    q, k, v, _ = _inputs(9, 32, 32)
    out = flash_attention(_t(q), _t(k), _t(v), causal=True, block_q=64,
                          block_k=64)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(_t(q), _t(k), _t(v), block_q=128)
