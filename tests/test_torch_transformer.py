"""The port's serving forward (chunked ``prefill`` then ``decode_step``)
against the JAX package's, on the CPU in f32.

Weights come from the JAX package's ``init_params`` and are carried over
with ``params_from_jax``; token ids and block tables come from
``numpy.random.default_rng``. Logits of the kept rows and the whole
written KV cache hold 1e-5 (f32 matmuls and softmax summed in another
order). The JAX side runs its gather reference (``paged_impl=
"reference"``); the port runs the kernel's plain version."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import registry as jreg
from ray_tpu.models import transformer as jtf
from ray_tpu_torch._bridge import params_from_jax, to_numpy
from ray_tpu_torch.models import registry as treg
from ray_tpu_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _models(name):
    jcfg = jreg.get_config(name, paged_impl="reference")
    tcfg = treg.get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_prefill_then_decode_matches_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(11)
    B, bs, T, C = 2, 4, 8, 4
    prompt_lens = [11, 6]
    n_blocks = 1 + B * T
    bt = (1 + rng.permutation(B * T)).astype(np.int32).reshape(B, T)
    prompts = [rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]
    jcache = jtf.init_kv_cache(jcfg, n_blocks, bs)
    tcache = ttf.init_kv_cache(tcfg, n_blocks, bs, device="cpu")

    last = np.zeros(B, np.int32)
    for start in range(0, max(prompt_lens), C):
        n = np.array([max(0, min(C, L - start)) for L in prompt_lens],
                     np.int32)
        toks = np.zeros((B, C), np.int32)
        for b in range(B):
            toks[b, :n[b]] = prompts[b][start:start + n[b]]
        st = np.full(B, start, np.int32)
        jl, jcache = jtf.prefill(jcfg, jparams, toks, jcache, bt, st, n)
        tl, tcache = ttf.prefill(tcfg, tparams, _t(toks), tcache, _t(bt),
                                 _t(st), _t(n))
        jl, tl = np.asarray(jl), tl.numpy()
        for b in range(B):
            np.testing.assert_allclose(tl[b, :n[b]], jl[b, :n[b]], **TOL)
            if n[b] and start + n[b] == prompt_lens[b]:
                last[b] = int(np.argmax(jl[b, n[b] - 1]))

    seq_lens = np.asarray(prompt_lens, np.int32)
    for _ in range(3):
        jl, jcache = jtf.decode_step(jcfg, jparams, last, jcache, bt,
                                     seq_lens)
        tl, tcache = ttf.decode_step(tcfg, tparams, _t(last), tcache,
                                     _t(bt), _t(seq_lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        last = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        seq_lens = seq_lens + 1

    got = to_numpy(tcache)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], np.asarray(jcache[key]), **TOL)


def test_padded_positions_past_window_are_dropped():
    """A chunk whose padded tail runs past the table window writes only
    its valid tokens (JAX drops the rest with an out-of-bounds scatter)."""
    jcfg, jparams, tcfg, tparams = _models("gptj-tiny")
    bs, T, C = 4, 2, 4
    bt = np.array([[2, 1]], np.int32)
    toks = np.array([[5, 6, 0, 0]], np.int32)
    st, n = np.array([6], np.int32), np.array([2], np.int32)
    jcache = jtf.init_kv_cache(jcfg, 3, bs)
    tcache = ttf.init_kv_cache(tcfg, 3, bs, device="cpu")
    jl, jcache = jtf.prefill(jcfg, jparams, toks, jcache, bt, st, n)
    tl, tcache = ttf.prefill(tcfg, tparams, _t(toks), tcache, _t(bt),
                             _t(st), _t(n))
    np.testing.assert_allclose(tl.numpy()[0, :2], np.asarray(jl)[0, :2],
                               **TOL)
    got = to_numpy(tcache)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], np.asarray(jcache[key]), **TOL)
    assert not got["k"][:, 0].any()           # trash block untouched


def test_params_bridge_round_trip_and_dtypes():
    _, jparams, tcfg, tparams = _models("llama2-tiny")
    tree = jax.tree.map(np.asarray, jparams)
    back = to_numpy(tparams)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = params_from_jax(tree, treg.get_config("llama2-tiny",
                                               dtype=torch.bfloat16), "cpu")
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    assert bf["layers"]["wq"].shape == tree["layers"]["wq"].shape
    assert bf["layers"]["attn_norm"].dtype == torch.float32
    assert bf["final_norm"]["scale"].dtype == torch.float32


def test_entry_points_need_cuda_unless_told_cpu():
    cfg = treg.get_config("gptj-tiny")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(cfg, 0)
    p = ttf.init_params(cfg, 0, device="cpu")
    assert p["layers"]["wq"].shape == (2, 64, 64)
    assert p["layers"]["ln_scale"].dtype == torch.float32
    moe = ttf.init_params(treg.get_config("moe-tiny"), 0, device="cpu")
    assert moe["layers"]["moe_wi"].shape == (2, 4, 64, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(treg.get_config("moe-tiny"), 0)
