"""The hand-written kernels (paged attention, the flash forward and
backward, bf16 on the wgmma kernels and f32 on the mma.sync ones)
against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernel is
built with nvcc at first use); without a card each skips. Run on the
card with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

Tolerances hold each kept (row, head) output vector: max |got - want|
over head_dim <= TOL x max |want| over that same vector, so a long row
(small outputs) is held as tightly as a short one. float32 holds 1e-5
(the kernel sums in another order than the plain version). bfloat16
holds 2e-2: the kernel rounds p to bf16 before P.V, as the TPU kernel
did, while the plain version stays in f32, and the output itself is
rounded to bf16 (2^-9 relative).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import (decode_step, get_config, init_kv_cache,
                                  init_params, prefill)
from ray_tpu_torch.ops import paged_attention
from ray_tpu_torch.ops.paged_flash import (
    paged_flash_attention, paged_flash_attention_plain,
    paged_flash_attention_split_plain)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, seed, B, C, H, KVH, D, bs, T, dtype, lens, starts=None):
    """A shuffled paged pool with block 0 as the engine's trash block.
    Decode (C=1) puts each row at lens-1; prefill puts row i at
    start+i with lens = start + C."""
    rng = np.random.default_rng(seed)
    n = 1 + B * T
    kc = rng.standard_normal((n, bs, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((n, bs, KVH, D)).astype(np.float32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    bt = (1 + rng.permutation(B * T)).astype(np.int32).reshape(B, T)
    lens = np.asarray(lens, np.int32)
    if starts is None:
        pos = np.maximum(lens - 1, 0)[:, None].astype(np.int32)
    else:
        pos = (np.asarray(starts, np.int32)[:, None]
               + np.arange(C, dtype=np.int32)[None, :])
    dev = dict(device=device)
    return (torch.tensor(q, **dev).to(dtype),
            torch.tensor(kc, **dev).to(dtype),
            torch.tensor(vc, **dev).to(dtype),
            torch.tensor(bt, **dev), torch.tensor(pos, **dev),
            torch.tensor(lens, **dev))


def _check(q, kc, vc, bt, pos, lens):
    before = paged_flash_attention.kernel_launches
    got = paged_flash_attention(q, kc, vc, bt, pos, lens)
    torch.cuda.synchronize()
    assert paged_flash_attention.kernel_launches == before + 1
    live = (pos < lens[:, None])                      # rows compared
    assert live.any()
    # the plain version, and the same computed split by split and merged
    # as the kernel's blocks and merge pass do
    for plain in (paged_flash_attention_plain,
                  paged_flash_attention_split_plain):
        want = plain(q, kc, vc, bt, pos, lens)
        g, w = got.float()[live], want.float()[live]       # [R, H, D]
        assert torch.isfinite(g).all()
        err = (g - w).abs().amax(-1)
        scale = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        worst = (err / scale).max().item()
        assert worst <= TOL[q.dtype], worst


_rng = np.random.default_rng(7)
_GPTJ_DECODE_LENS = np.concatenate([[0, 1, 1024, 31, 32, 33],
                                    _rng.integers(1, 1025, 26)])
# the speculative verify: decode's lens with 0-4 drafts a slot; a slot's
# rows past its drafts (and every row of the idle lens-0 slot) are
# padded, and the full slot's padded rows sit past the 1024-key window
_VERIFY_DRAFTS = np.concatenate([[4, 2, 1], _rng.integers(0, 5, 29)])
_GPTJ_VERIFY_STARTS = [max(int(n) - 1 - min(int(d), int(n) - 1), 0)
                       for n, d in zip(_GPTJ_DECODE_LENS, _VERIFY_DRAFTS)]
CASES = {
    # name: (B, C, H, KVH, D, bs, T, dtype, lens, starts)
    "gptj6b_decode": (32, 1, 16, 16, 256, 32, 32, torch.bfloat16,
                      _GPTJ_DECODE_LENS, None),
    "gptj6b_prefill": (1, 256, 16, 16, 256, 32, 32, torch.bfloat16,
                       [300 + 256], [300]),
    "gptj6b_verify": (32, 5, 16, 16, 256, 32, 32, torch.bfloat16,
                      _GPTJ_DECODE_LENS, _GPTJ_VERIFY_STARTS),
    "gqa_decode": (8, 1, 32, 8, 128, 16, 16, torch.bfloat16,
                   [1, 5, 16, 17, 100, 200, 255, 256], None),
    "gqa_prefill": (2, 64, 32, 8, 128, 16, 16, torch.bfloat16,
                    [77 + 64, 64], [77, 0]),
    "f32_decode": (4, 1, 8, 8, 64, 16, 8, torch.float32,
                   [0, 3, 64, 128], None),
    "f32_prefill": (2, 24, 8, 2, 64, 16, 8, torch.float32,
                    [40 + 24, 24], [40, 0]),
    "tiny_d8": (4, 8, 2, 2, 8, 4, 12, torch.float32,
                [8, 13, 30, 48], [0, 5, 22, 40]),
    "tiny_d16_gqa": (3, 1, 4, 2, 16, 4, 6, torch.float32,
                     [1, 9, 24], None),
    # odd block size: staged bf16 V rows start 8-byte aligned only
    "odd_block_bf16_prefill": (3, 5, 4, 2, 8, 5, 5, torch.bfloat16,
                               [7, 11, 23], [2, 6, 18]),
    "odd_block_f32_decode": (3, 1, 6, 3, 24, 7, 4, torch.float32,
                             [1, 15, 28], None),
    # split-K over keys (256 keys a split): a 1024-key window gives 4
    # splits; lens 0 (the trash page), 1, a split boundary and either
    # side of it, and a full window
    "split_decode": (8, 1, 16, 16, 128, 16, 64, torch.bfloat16,
                     [0, 1, 255, 256, 257, 512, 700, 1024], None),
    "split_decode_f32": (3, 1, 4, 2, 64, 32, 24, torch.float32,
                         [0, 256, 700], None),
    # GQA chunked prefill across two splits, 64-row tiles (384 rows)
    "split_gqa_prefill": (2, 96, 32, 8, 128, 16, 32, torch.bfloat16,
                          [200 + 96, 96], [200, 0]),
    # odd block size: a split boundary falls inside a page
    "split_odd_block_prefill": (2, 3, 6, 3, 24, 7, 60, torch.float32,
                                [263, 417], [260, 414]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    B, C, H, KVH, D, bs, T, dtype, lens, starts = CASES[name]
    _check(*_case(cuda, 0, B, C, H, KVH, D, bs, T, dtype, lens, starts))


@pytest.mark.parametrize("block_r", [4, 8, 32])
def test_kernel_row_blocks(cuda, block_r):
    """Every row-block size the wrapper takes gives the same answer."""
    q, kc, vc, bt, pos, lens = _case(cuda, 4, 2, 40, 8, 4, 32, 8, 8,
                                     torch.float32, [40 + 17, 40],
                                     [17, 0])
    got = paged_flash_attention(q, kc, vc, bt, pos, lens, block_r=block_r)
    want = paged_flash_attention_plain(q, kc, vc, bt, pos, lens)
    live = pos < lens[:, None]
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-5)


def test_auto_dispatch_launches_kernel(cuda):
    q, kc, vc, bt, pos, lens = _case(cuda, 1, 2, 1, 4, 2, 16, 4, 4,
                                     torch.float32, [3, 16])
    before = paged_flash_attention.kernel_launches
    got = paged_attention(q, kc, vc, bt, pos, lens=lens)
    ref = paged_attention(q, kc, vc, bt, pos, impl="reference")
    assert paged_flash_attention.kernel_launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["head_dim", "block_size", "dtype"])
def test_kernel_rejects_what_it_cannot_take(cuda, bad):
    D, bs, dtype = 16, 4, torch.float32
    if bad == "head_dim":
        D = 12
    elif bad == "block_size":
        bs = 64
    else:
        dtype = torch.float16
    q, kc, vc, bt, pos, lens = _case(cuda, 2, 1, 1, 2, 2, D, bs, 2,
                                     torch.float32, [3])
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    with pytest.raises((ValueError, TypeError)):
        paged_flash_attention(q, kc, vc, bt, pos, lens)


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_tiny_model_kernel_path_matches_reference(cuda, name):
    """Chunked prefill then decode steps of a tiny f32 model on the card:
    the kernel path's logits and cache hold 1e-5 against the
    whole-window reference path (only attention differs)."""
    rng = np.random.default_rng(3)
    B, C, bs, T = 2, 8, 4, 8
    params = init_params(get_config(name), 0, device=cuda)
    toks = torch.tensor(rng.integers(1, 512, (B, C)), dtype=torch.int32,
                        device=cuda)
    bt = torch.tensor(1 + rng.permutation(B * T).reshape(B, T),
                      dtype=torch.int32, device=cuda)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=cuda)
    step_toks = torch.tensor(rng.integers(1, 512, (3, B)),
                             dtype=torch.int32, device=cuda)
    runs = {}
    for impl in ("kernel", "reference"):
        cfg = get_config(name, paged_impl=impl)
        cache = init_kv_cache(cfg, 1 + B * T, bs, device=cuda)
        start = torch.zeros(B, dtype=torch.int32, device=cuda)
        logits, cache = prefill(cfg, params, toks, cache, bt, start, lens)
        keep = torch.arange(C, device=cuda)[None, :] < lens[:, None]
        outs = [logits[keep]]
        seq = lens.clone()
        for i in range(3):
            logits, cache = decode_step(cfg, params, step_toks[i], cache,
                                        bt, seq)
            outs.append(logits)
            seq = seq + 1
        runs[impl] = (outs, cache)
    for a, b in zip(runs["kernel"][0], runs["reference"][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(runs["kernel"][1][key],
                                   runs["reference"][1][key],
                                   rtol=1e-5, atol=1e-5)


def test_config_row_tiles_reach_the_kernel(cuda):
    """``paged_block_r`` (decode) and ``paged_block_r_prefill`` (chunks)
    pick the kernel's row tile, as in the JAX package; every tile gives
    the reference path's logits."""
    rng = np.random.default_rng(4)
    B, C, bs, T = 2, 8, 4, 8
    params = init_params(get_config("llama2-tiny"), 0, device=cuda)
    toks = torch.tensor(rng.integers(1, 512, (B, C)), dtype=torch.int32,
                        device=cuda)
    bt = torch.tensor(1 + rng.permutation(B * T).reshape(B, T),
                      dtype=torch.int32, device=cuda)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=cuda)
    outs = {}
    for impl, br, br_prefill in (("reference", 0, 0), ("kernel", 32, 64),
                                 ("kernel", 64, 16)):
        cfg = get_config("llama2-tiny", paged_impl=impl, paged_block_r=br,
                         paged_block_r_prefill=br_prefill)
        cache = init_kv_cache(cfg, 1 + B * T, bs, device=cuda)
        start = torch.zeros(B, dtype=torch.int32, device=cuda)
        logits, cache = prefill(cfg, params, toks, cache, bt, start, lens)
        keep = torch.arange(C, device=cuda)[None, :] < lens[:, None]
        step, _ = decode_step(cfg, params, toks[:, 0], cache, bt, lens)
        outs[(impl, br)] = (logits[keep], step)
    for key in (("kernel", 32), ("kernel", 64)):
        for got, want in zip(outs[key], outs[("reference", 0)]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("numel", [180, 256 * 1000 + 7])
def test_quantize_int8_on_the_card_matches_the_numpy_twin(cuda, numel):
    """The KV wire's int8 quantizer on a CUDA tensor: values and scales
    byte-identical to the numpy twin's (the CPU tests hold the twin to
    the JAX package's)."""
    from ray_tpu_torch.parallel.quantization import (quantize_int8,
                                                     quantize_int8_np)
    rng = np.random.default_rng(numel)
    x = (rng.standard_normal(numel) * 3).astype(np.float32)
    x[:7] = [0.5, 1.5, -2.5, 0, 0, 127, -127]
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.tensor(x, device=cuda).to(dtype)
        q, sc = quantize_int8(t)
        want_q, want_s = quantize_int8_np(t.float().cpu().numpy())
        assert q.device.type == "cuda"
        assert q.cpu().numpy().tobytes() == want_q.tobytes()
        assert sc.cpu().numpy().tobytes() == want_s.tobytes()


def test_engine_handoff_on_the_card(cuda):
    """A tiny f32 engine on the card: ``prefill_export`` on one engine
    and ``submit_adopt`` on another give the colocated stream on both
    wires' first token and, on the bit-exact wire, every token."""
    from ray_tpu_torch.serve import EngineConfig, LLMEngine
    cfg = get_config("gptj-tiny")
    params = init_params(cfg, 0, device=cuda, dtype=cfg.dtype)
    knobs = dict(decode_slots=4, kv_block_size=8, max_seq_len=128,
                 prefill_chunk=32, max_new_tokens=12)
    engines = [LLMEngine(cfg, EngineConfig(**dict(knobs, kv_wire=w)),
                         params=params, device=cuda)
               for w in ("bf16", "int8", "bf16")]
    try:
        ref, pre8, dec = engines
        prompt = list(range(3, 60))
        want = list(ref.generate_sync(prompt, 12))
        got = list(dec._items(dec.submit_adopt(ref.prefill_export(prompt),
                                               12), "adopt", 60))
        assert got == want
        got8 = list(dec._items(dec.submit_adopt(pre8.prefill_export(prompt),
                                                12), "adopt", 60))
        assert got8[0] == want[0]
        assert all(e.pool_audit() == [] for e in engines)
    finally:
        for e in engines:
            e.shutdown()


# ------------------------------------------------------ flash attention
# The four flash kernels against their plain versions. Each (row, head)
# vector of O, dQ, dK, dV is held on its own: max |got - want| <= TOL x
# max |want| of that vector (floored at 1% of the tensor's max). bf16
# holds 2e-2: the forward rounds P to bf16 before P.V (as the TPU kernel
# did), the backward rounds P and dS to bf16 for its tensor-core products
# (the TPU kernel kept them in f32), and outputs are rounded to bf16
# (2^-9). f32 runs exact f32 FMAs, in another order than the plain
# version where the forward rescales its running sums: 1e-5. LSE and
# delta are f32 sums of exact products: absolute 1e-4 (bf16 inputs) /
# 1e-5 (f32) x (1 + |want|).

from ray_tpu_torch.ops import multihead_attention  # noqa: E402
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bshd, flash_delta, flash_delta_plain, flash_dkdv,
    flash_dkdv_plain, flash_dq, flash_dq_plain, flash_fwd, flash_fwd_plain)

FLASH_CASES = {
    # name: (B, Sq, Sk, H, D, dtype, causal)
    "gptj_d256_causal_bf16": (1, 512, 512, 2, 256, torch.bfloat16, True),
    "entry_d128_bf16": (2, 256, 256, 4, 128, torch.bfloat16, False),
    "entry_d128_causal_bf16": (2, 256, 256, 4, 128, torch.bfloat16, True),
    "cross_len_causal_d128_bf16": (1, 128, 384, 2, 128, torch.bfloat16,
                                   True),
    "ragged_d64_f32": (2, 200, 200, 2, 64, torch.float32, False),
    "ragged_causal_d64_bf16": (1, 77, 77, 3, 64, torch.bfloat16, True),
    "ragged_cross_d256_f32": (1, 50, 131, 2, 256, torch.float32, True),
    "d40_f32": (1, 33, 70, 1, 40, torch.float32, False),
    "d8_bf16": (2, 19, 19, 2, 8, torch.bfloat16, True),
    # the bf16 forward's 128-row tiles: D in {64, 128, 256} with S not a
    # multiple of 128, cross-length causal, and more blocks than one wave
    # of 132 SMs (8 tiles x 9 heads x 2)
    "sm90_d64_s200_causal_bf16": (1, 200, 200, 2, 64, torch.bfloat16, True),
    "sm90_d128_s333_bf16": (1, 333, 333, 2, 128, torch.bfloat16, False),
    "sm90_d256_s129_causal_bf16": (2, 129, 129, 2, 256, torch.bfloat16,
                                   True),
    "sm90_cross_d256_bf16": (1, 100, 300, 2, 256, torch.bfloat16, True),
    "sm90_over_one_wave_bf16": (2, 1024, 1024, 9, 128, torch.bfloat16,
                                True),
    # the bf16 backward's tiles (dK/dV: 64 keys a block, 64-row q tiles;
    # dQ: 128 rows a block, 32-key tiles): D in {64, 128, 256} with S not
    # a multiple of 64, cross-length causal and non-causal at D = 256,
    # Sq < 64, head dims that TMA pads, and more blocks than one wave of
    # 132 SMs with causal tiles (16 key tiles x 9 heads x 2)
    "sm90_bwd_d64_s100_causal_bf16": (2, 100, 100, 2, 64, torch.bfloat16,
                                      True),
    "sm90_bwd_d128_s190_bf16": (1, 190, 190, 3, 128, torch.bfloat16, False),
    "sm90_bwd_d256_s161_causal_bf16": (1, 161, 161, 2, 256, torch.bfloat16,
                                       True),
    "sm90_bwd_cross_d256_bf16": (2, 77, 205, 2, 256, torch.bfloat16, True),
    "sm90_bwd_noncausal_d256_bf16": (1, 300, 200, 2, 256, torch.bfloat16,
                                     False),
    "sm90_bwd_sq40_d256_bf16": (2, 40, 100, 2, 256, torch.bfloat16, True),
    "sm90_bwd_d8_bf16": (1, 70, 70, 2, 8, torch.bfloat16, False),
    "sm90_bwd_d40_causal_bf16": (2, 90, 150, 2, 40, torch.bfloat16, True),
    "sm90_bwd_over_one_wave_bf16": (2, 1024, 1024, 9, 256, torch.bfloat16,
                                    True),
}
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_ABS = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def _flash_inputs(device, seed, B, Sq, Sk, H, D, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device).to(dtype)
    return t(B, Sq, H, D), t(B, Sk, H, D), t(B, Sk, H, D), t(B, Sq, H, D)


def _vec_rel(got, want):
    """Worst (row, head) error over max(that vector's max |want|, 1% of
    the tensor's): the floor keeps a vector that is zero in exact
    arithmetic (dQ of a causal row that sees one key) from dividing
    rounding noise by rounding noise."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert w.abs().max() > 0                 # no pass on all-zero outputs
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1).clamp_min(
        max(1e-2 * w.abs().max().item(), torch.finfo(torch.float32).tiny))
    return (err / scale).max().item()


def _abs_ok(got, want, tol):
    return bool(((got - want).abs() <= tol * (1 + want.abs())).all())


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    B, Sq, Sk, H, D, dtype, causal = FLASH_CASES[name]
    q, k, v, do = _flash_inputs(cuda, 5, B, Sq, Sk, H, D, dtype)
    tol, atol = FLASH_TOL[dtype], FLASH_ABS[dtype]
    launches = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                            flash_dkdv, flash_dq)]
    o, lse = flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _vec_rel(o, o_p) <= tol
    assert _abs_ok(lse, lse_p, atol)

    delta = flash_delta(o_p, do)
    delta_p = flash_delta_plain(o_p, do)
    torch.cuda.synchronize()
    assert _abs_ok(delta, delta_p, atol * max(D / 64, 1))

    dk, dv = flash_dkdv(q, k, v, do, lse_p, delta_p, causal=causal)
    dk_p, dv_p = flash_dkdv_plain(q, k, v, do, lse_p, delta_p, causal=causal)
    dq = flash_dq(q, k, v, do, lse_p, delta_p, causal=causal)
    dq_p = flash_dq_plain(q, k, v, do, lse_p, delta_p, causal=causal)
    torch.cuda.synchronize()
    for got, want in ((dk, dk_p), (dv, dv_p), (dq, dq_p)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _vec_rel(got, want) <= tol
    after = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                         flash_dkdv, flash_dq)]
    assert after == [n + 1 for n in launches]


def test_flash_autograd_launches_every_kernel(cuda):
    q, k, v, do = _flash_inputs(cuda, 6, 2, 96, 96, 2, 64, torch.float32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                          flash_dkdv, flash_dq)]
    o = multihead_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((o * do).sum(), (q, k, v))
    after = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                         flash_dkdv, flash_dq)]
    assert after == [n + 1 for n in before]
    ref = multihead_attention(q, k, v, causal=True, impl="reference")
    ref_grads = torch.autograd.grad((ref * do).sum(), (q, k, v))
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "strided", "causal"])
def test_flash_rejects_what_it_cannot_take(cuda, bad):
    D, dtype, Sq = 16, torch.float32, 32
    if bad == "head_dim":
        D = 12
    elif bad == "dtype":
        dtype = torch.float16
    elif bad == "causal":
        Sq = 48
    q, k, v, _ = _flash_inputs(cuda, 7, 1, Sq, 32, 2, D, torch.float32)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        flash_fwd(q, k, v, causal=True)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bshd(q, k, v, causal=True) if bad != "strided" \
            else flash_dq(q, k, v, q, torch.zeros(1, 2, Sq, device=cuda),
                          torch.zeros(1, 2, Sq, device=cuda), causal=True)


@pytest.mark.parametrize("d", [12, 264])
def test_flash_fwd_bf16_rejects_what_the_sm90_kernel_cannot_take(cuda, d):
    """A bf16 head dim the wgmma kernel cannot take raises; nothing
    falls back to another kernel or to the plain version."""
    q, k, v, _ = _flash_inputs(cuda, 8, 1, 64, 64, 2, d, torch.bfloat16)
    before = flash_fwd.kernel_launches
    with pytest.raises(ValueError):
        flash_fwd(q, k, v, causal=True)
    assert flash_fwd.kernel_launches == before


@pytest.mark.parametrize("d", [12, 264])
def test_flash_bwd_bf16_rejects_what_the_sm90_kernels_cannot_take(cuda, d):
    """A bf16 head dim the wgmma dK/dV and dQ kernels cannot take raises;
    nothing falls back to another kernel or to the plain version."""
    q, k, v, do = _flash_inputs(cuda, 10, 1, 64, 64, 2, d, torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    delta = torch.zeros(1, 2, 64, device=cuda)
    before = [flash_dkdv.kernel_launches, flash_dq.kernel_launches]
    with pytest.raises(ValueError):
        flash_dkdv(q, k, v, do, lse, delta, causal=True)
    with pytest.raises(ValueError):
        flash_dq(q, k, v, do, lse, delta, causal=True)
    assert [flash_dkdv.kernel_launches, flash_dq.kernel_launches] == before


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_tiny_model_train_path_matches_reference(cuda, name):
    """A tiny f32 model's loss and gradients on the card: the flash
    kernels (one forward launch per layer under "dots", one of each
    backward kernel) hold 1e-5 against the reference attention path."""
    import dataclasses

    from ray_tpu_torch.models import lm_loss
    cfg = get_config(name)
    params = init_params(cfg, 0, device=cuda)
    leaves = [t.requires_grad_() for grp in params.values()
              for t in (grp.values() if isinstance(grp, dict) else [grp])]
    ids = torch.tensor(np.random.default_rng(9).integers(0, 512, (2, 40)),
                       device=cuda)
    runs = {}
    for impl in ("auto", "reference"):
        c = dataclasses.replace(cfg, attn_impl=impl, remat=None,
                                remat_policy="dots")
        before = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                              flash_dkdv, flash_dq)]
        loss, _ = lm_loss(c, params, {"input_ids": ids})
        grads = torch.autograd.grad(loss, leaves)
        after = [f.kernel_launches for f in (flash_fwd, flash_delta,
                                             flash_dkdv, flash_dq)]
        runs[impl] = (loss, grads, [a - b for a, b in zip(after, before)])
    assert runs["auto"][2] == [cfg.n_layers] * 4
    assert runs["reference"][2] == [0] * 4
    torch.testing.assert_close(runs["auto"][0], runs["reference"][0],
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(runs["auto"][1], runs["reference"][1]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
