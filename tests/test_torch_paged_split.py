"""The paged kernel's split-K arithmetic in plain PyTorch, on the CPU.

The card's kernel splits each sequence's keys over blocks of
``split_keys`` keys, each writing f32 partials (``O / l`` and ``lse = m +
log l``, ``-inf`` where a row sees no key of the split), and a second
kernel merges them. ``paged_flash_attention_split_plain`` is that
computation in plain PyTorch (the function the card's kernels are held
against in ``tests/test_torch_kernels_gpu.py``). Here it holds 1e-6
(f32) against the unsplit plain version at the edge lengths of the card
cases (0, 1, split boundaries and either side, a full window, a boundary
inside a page), and 1e-5 against the JAX Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_flash import paged_flash_attention as jax_paged_kernel
from ray_tpu_torch.ops.paged_flash import (PAGED_SPLIT_KEYS,
                                           paged_combine_plain,
                                           paged_flash_attention_plain,
                                           paged_flash_attention_split_plain,
                                           paged_split_partials_plain,
                                           paged_split_plan, paged_row_tile,
                                           default_paged_block_r)

torch.set_num_threads(1)

TOL6 = dict(rtol=1e-6, atol=1e-6)
TOL5 = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B, C, H, KVH, D, bs, T, lens, starts):
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
    return q, kc, vc, bt, pos, lens


# name: (B, C, H, KVH, D, bs, T, lens, starts, split_keys); the window is
# T * bs keys, so small windows with 64-key splits give several splits
CASES = {
    "decode_edges": (8, 1, 4, 4, 16, 16, 16, [0, 1, 63, 64, 65, 128, 200, 256],
                     None, 64),
    "decode_gqa": (4, 1, 8, 2, 16, 8, 24, [0, 64, 129, 192], None, 64),
    "prefill_gqa_across_splits": (2, 24, 8, 2, 16, 8, 24, [100 + 24, 24],
                                  [100, 0], 64),
    "odd_block_boundary_in_page": (2, 3, 6, 3, 24, 7, 20, [67, 130],
                                   [64, 127], 64),
    "gptj_shape_small_d": (4, 1, 4, 4, 8, 32, 32, [0, 256, 257, 1024], None,
                           PAGED_SPLIT_KEYS),
    "one_split": (3, 2, 4, 2, 8, 4, 8, [3, 17, 32], [1, 15, 30], 64),
}


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_combine_matches_plain(name):
    B, C, H, KVH, D, bs, T, lens, starts, split_keys = CASES[name]
    q, kc, vc, bt, pos, ln = _torch(*_case(0, B, C, H, KVH, D, bs, T, lens,
                                           starts))
    want = paged_flash_attention_plain(q, kc, vc, bt, pos, ln)
    got = paged_flash_attention_split_plain(q, kc, vc, bt, pos, ln,
                                            split_keys=split_keys)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_combine_matches_jax_kernel(name):
    B, C, H, KVH, D, bs, T, lens, starts, split_keys = CASES[name]
    arrays = _case(1, B, C, H, KVH, D, bs, T, lens, starts)
    q, kc, vc, bt, pos, ln = _torch(*arrays)
    got = paged_flash_attention_split_plain(
        q, kc, vc, bt, pos, ln, split_keys=split_keys).numpy()
    want = np.asarray(jax_paged_kernel(*[jnp.asarray(a) for a in arrays],
                                       interpret=True))
    live = arrays[4] < arrays[5][:, None]      # rows the caller keeps
    assert live.any()
    np.testing.assert_allclose(got[live], want[live], **TOL5)


def test_partials_of_splits_no_row_sees_are_minus_inf():
    """A 1-token sequence sees keys of split 0 only: every later split
    carries lse = -inf and weighs nothing, and the merge makes no NaN."""
    q, kc, vc, bt, pos, ln = _torch(*_case(2, 2, 1, 2, 2, 8, 16, 16,
                                           [1, 256], None))
    part_o, part_lse = paged_split_partials_plain(q, kc, vc, bt, pos, ln,
                                                  split_keys=64)
    assert part_lse.shape == (4, 2, 1, 2)
    assert torch.isneginf(part_lse[1:, 0]).all()
    assert torch.isfinite(part_lse[:, 1]).all()
    assert (part_o[1:, 0] == 0).all()
    out = paged_combine_plain(part_o, part_lse)
    assert torch.isfinite(out).all()


def test_combine_of_rows_no_split_sees_is_zero():
    part_o = torch.zeros(3, 2, 4)
    part_lse = torch.full((3, 2), -float("inf"))
    part_lse[1, 1] = 0.5
    part_o[1, 1] = 2.0
    out = paged_combine_plain(part_o, part_lse)
    assert (out[0] == 0).all() and torch.isfinite(out).all()
    torch.testing.assert_close(out[1], torch.full((4,), 2.0))


@pytest.mark.parametrize("window,split,want",
                         [(1024, 256, 4), (256, 256, 1), (257, 256, 2),
                          (16, 256, 1), (420, 64, 7)])
def test_split_plan(window, split, want):
    assert paged_split_plan(window, split) == (want, split)


@pytest.mark.parametrize("block_r,tile", [(1, 16), (4, 16), (8, 16),
                                          (16, 16), (17, 32), (32, 32),
                                          (33, 64), (64, 64)])
def test_row_tile_rounds_up(block_r, tile):
    assert paged_row_tile(block_r) == tile


@pytest.mark.parametrize("block_r", [0, 65])
def test_row_tile_rejects(block_r):
    with pytest.raises(ValueError):
        paged_row_tile(block_r)


@pytest.mark.parametrize("rows,want", [(1, 16), (4, 16), (20, 32),
                                       (256, 64), (1024, 64)])
def test_default_block_r(rows, want):
    assert default_paged_block_r(rows) == want
