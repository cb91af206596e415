"""Paged attention of new-token queries against a paged KV pool: the
serving path's one kernel.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_flash.py::
_paged_kernel`` (launched by that module's ``paged_flash_attention``)
with the hand-written CUDA kernel in ``csrc/paged_attention.cu``, built
for Hopper (``sm_90a``) at first use and bound with :mod:`ctypes`.

What bounds it on the H100: bytes. Decode reads every live K/V page once
per (sequence, kv head) and does about two flops per byte read, far
below the ~295 flops per byte at which bf16 tensor cores become the
limit. The kernel therefore reads only live pages (``paged_work_pages``)
and, within a block, stages each page once in shared memory for all of
the block's query rows; it also stops at the last page any of its rows
may see (causal skip for chunked prefill). See the source for the
layout.

:func:`paged_flash_attention` launches the kernel for a CUDA tensor and
raises if it cannot; for a CPU tensor it runs
:func:`paged_flash_attention_plain`, the same function in plain PyTorch
(the port has no interpret mode). ``paged_flash_attention.
kernel_launches`` counts launches, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_NEG_INF = -1e30
_SOURCE = "paged_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_BLOCK_SIZE = 32
_MAX_BLOCK_R = 32


def paged_work_pages(lens, block_size: int):
    """Pages a length-aware kernel touches per sequence:
    ``max(ceil(lens / block_size), 1)`` (an idle ``lens = 0`` slot still
    reads its one trash page). Works on numpy arrays, tensors and ints."""
    if hasattr(lens, "clip"):
        return ((lens + block_size - 1) // block_size).clip(min=1)
    return max(-(-lens // block_size), 1)


def default_paged_block_r(rows: int) -> int:
    """Query rows per CUDA block on the H100: a warp scores four rows
    together against a staged page, and up to four row warps share it.
    Decode has ``rows = H / KVH`` (1 for GPT-J, 4 for 32/8 GQA), so one
    warp; chunked prefill has ``C * H / KVH`` rows, so 16 rows per block.
    At D = 256 that keeps the f32 query tile (16 KB) and a staged bf16
    K/V page pair (2 x 32 x 260 x 2 B, 33 KB) near 50 KB, which leaves
    room for four blocks per SM."""
    return min(-(-rows // 4) * 4, 16)


def _library():
    from ray_tpu_torch._build import load_library
    lib = load_library(_SOURCE)
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p,          # q k v bt pos lens out
                       i, i, i, i, i, i, i, i,       # B C H KVH D bs T N
                       ctypes.c_float, i, i, p]      # scale block_r dtype stream
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_cache, v_cache, block_tables, q_positions, lens,
           block_r: int) -> None:
    b, c, h, d = q.shape
    n, bs, g, dk = k_cache.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k_cache and v_cache must share one dtype")
    if v_cache.shape != k_cache.shape or dk != d:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    if h % g:
        raise ValueError(f"n_heads {h} not divisible by kv_heads {g}")
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"paged kernel takes head_dim a multiple of 8 up "
                         f"to {_MAX_HEAD_DIM}, got {d}")
    if bs > _MAX_BLOCK_SIZE:
        raise ValueError(f"paged kernel takes kv_block_size up to "
                         f"{_MAX_BLOCK_SIZE}, got {bs}")
    if block_r % 4 or not 4 <= block_r <= _MAX_BLOCK_R:
        raise ValueError(f"block_r must be a multiple of 4 in "
                         f"[4, {_MAX_BLOCK_R}], got {block_r}")
    if block_tables.shape[0] != b or q_positions.shape != (b, c) \
            or lens.shape != (b,):
        raise ValueError("block_tables [B, T], q_positions [B, C] and "
                         "lens [B] must match q's batch and chunk")
    for name, t in (("block_tables", block_tables),
                    ("q_positions", q_positions), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables),
                    ("q_positions", q_positions), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          block_tables: torch.Tensor,
                          q_positions: torch.Tensor,
                          lens: torch.Tensor, *,
                          sm_scale: Optional[float] = None,
                          block_r: Optional[int] = None) -> torch.Tensor:
    """Paged attention of new-token queries against the block pool.

    ``q`` is ``[B, C, H, D]`` at absolute ``q_positions [B, C]``; the
    caches are one layer's ``[N, bs, KVH, D]``; ``block_tables [B, T]``;
    ``lens [B]`` is each sequence's live token count after this step's
    writes, and table slots past ``ceil(lens / bs)`` are never read.
    Rows whose position is ``>= lens[b]`` (a padded prefill tail) see
    only live keys; their outputs are the caller's to discard. Returns
    ``[B, C, H, D]`` in q's dtype.

    A CUDA tensor goes to the kernel, and any failure to launch raises;
    a CPU tensor goes to :func:`paged_flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return paged_flash_attention_plain(
            q, k_cache, v_cache, block_tables, q_positions, lens,
            sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged kernel runs on cuda, got {q.device}")
    b, c, h, d = q.shape
    n, bs, g, _ = k_cache.shape
    t = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if not block_r:
        block_r = default_paged_block_r(c * (h // max(g, 1)))
    _check(q, k_cache, v_cache, block_tables, q_positions, lens, block_r)
    out = torch.empty_like(q)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 block_tables.data_ptr(), q_positions.data_ptr(),
                 lens.data_ptr(), out.data_ptr(),
                 b, c, h, g, d, bs, t, n, float(sm_scale), int(block_r),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_flash_attention.kernel_launches += 1
    return out


paged_flash_attention.kernel_launches = 0


def paged_flash_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                block_tables: torch.Tensor,
                                q_positions: torch.Tensor,
                                lens: torch.Tensor, *,
                                sm_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each sequence's
    live pages, f32 scores masked to ``key_pos <= row_pos`` and an f32
    softmax. Same inputs and outputs as :func:`paged_flash_attention`.
    Keys past the live pages are excluded, as the kernel never reads
    them. Runs on any device."""
    b, c, h, d = q.shape
    n, bs, g, _ = k_cache.shape
    t = block_tables.shape[1]
    rep = h // g
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_cache[bt].reshape(b, t * bs, g, d).float()
    v = v_cache[bt].reshape(b, t * bs, g, d).float()
    key_pos = torch.arange(t * bs, device=q.device)
    pages = paged_work_pages(lens.long(), bs)
    live = key_pos[None, :] < (pages * bs)[:, None]                 # [B, K]
    mask = (key_pos[None, None, :] <= q_positions.long()[:, :, None]) \
        & live[:, None, :]                                          # [B, C, K]
    qg = q.reshape(b, c, g, rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * sm_scale
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return o.reshape(b, c, h, d).to(q.dtype)
