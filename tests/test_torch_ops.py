"""The port's ops against the JAX package's, on the CPU in f32.

Inputs come from ``numpy.random.default_rng``; both sides get the same
arrays. Norms and rotary hold 1e-6. The port's paged attention on a CPU
tensor runs the kernel's plain version; it holds 1e-5 against the JAX
Pallas kernel in interpret mode and against the JAX gather reference
(f32 softmax, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu.ops.paged_flash import paged_flash_attention as jax_paged_kernel
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops.paged_flash import paged_flash_attention

torch.set_num_threads(1)

TOL6 = dict(rtol=1e-6, atol=1e-6)
TOL5 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_norms_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tops.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL6)
    np.testing.assert_allclose(
        tops.layer_norm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(jops.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias))), **TOL6)


@pytest.mark.parametrize("layout,rot_dim,with_pos",
                         [("gptj", 8, True), ("gptj", 16, False),
                          ("neox", 16, True), ("neox", 8, False)])
def test_rotary_matches_jax(layout, rot_dim, with_pos):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 6)).astype(np.int32)
    ts, tc = tops.rotary_table(40, rot_dim)
    js, jc = jops.rotary_table(40, rot_dim)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL6)
    got = tops.apply_rotary(_t(x), ts, tc,
                            positions=_t(pos) if with_pos else None,
                            layout=layout)
    want = jops.apply_rotary(jnp.asarray(x), js, jc,
                             positions=jnp.asarray(pos) if with_pos
                             else None, layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL6)


def test_attention_reference_end_aligned_causal():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    got = tops.attention_reference(_t(q), _t(k), _t(v), causal=True)
    want = jops.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)


def _paged_case(seed, B, C, H, KVH, D, bs, T, lens, starts):
    rng = np.random.default_rng(seed)
    n = 1 + B * T
    kc = rng.standard_normal((n, bs, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((n, bs, KVH, D)).astype(np.float32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    bt = (1 + rng.permutation(B * T)).astype(np.int32).reshape(B, T)
    pos = (np.asarray(starts, np.int32)[:, None]
           + np.arange(C, dtype=np.int32)[None, :])
    return q, kc, vc, bt, pos, np.asarray(lens, np.int32)


# name: (B, C, H, KVH, D, bs, T, lens, starts)
PAGED_CASES = {
    "decode": (3, 1, 4, 4, 16, 4, 6, [5, 13, 24], [4, 12, 23]),
    "decode_gqa_uneven": (3, 1, 4, 2, 16, 5, 5, [7, 11, 23], [6, 10, 22]),
    "prefill_chunk": (2, 8, 4, 4, 16, 4, 8, [13, 8], [5, 0]),
    "prefill_gqa_padded_tail": (2, 8, 4, 2, 8, 4, 6, [9, 21], [4, 16]),
    "lens_zero_idle_slot": (3, 1, 4, 2, 16, 4, 4, [0, 6, 16], [0, 5, 15]),
}


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_plain_matches_jax_kernel_and_reference(name):
    B, C, H, KVH, D, bs, T, lens, starts = PAGED_CASES[name]
    q, kc, vc, bt, pos, ln = _paged_case(5, B, C, H, KVH, D, bs, T, lens,
                                         starts)
    got = tops.paged_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos),
                               lens=_t(ln)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kc, vc, bt, pos)]
    want_k = np.asarray(jax_paged_kernel(*jargs, jnp.asarray(ln),
                                         interpret=True))
    want_r = np.asarray(jops.paged_attention(*jargs, impl="reference"))
    live = pos < ln[:, None]              # rows the caller keeps
    assert live.any()
    np.testing.assert_allclose(got[live], want_k[live], **TOL5)
    np.testing.assert_allclose(got[live], want_r[live], **TOL5)
    ref = tops.paged_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos),
                               impl="reference").numpy()
    np.testing.assert_allclose(ref, want_r, **TOL5)


def test_paged_lens_none_derives_bound_from_positions():
    q, kc, vc, bt, pos, _ = _paged_case(6, 2, 3, 4, 2, 16, 4, 5,
                                        [0, 0], [6, 13])
    got = tops.paged_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos))
    want = jops.paged_attention(*[jnp.asarray(a) for a in
                                  (q, kc, vc, bt, pos)], impl="kernel",
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)


def test_paged_wrapper_counts_no_launch_on_cpu():
    q, kc, vc, bt, pos, ln = _paged_case(7, 1, 1, 2, 2, 8, 4, 2, [3], [2])
    before = paged_flash_attention.kernel_launches
    paged_flash_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos), _t(ln))
    assert paged_flash_attention.kernel_launches == before


def test_paged_kernel_impl_on_cpu_raises():
    q, kc, vc, bt, pos, ln = _paged_case(8, 1, 1, 2, 2, 8, 4, 2, [3], [2])
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos),
                             lens=_t(ln), impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        tops.paged_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(pos),
                             impl="pallas")
