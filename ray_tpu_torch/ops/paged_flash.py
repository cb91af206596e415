"""Paged attention of new-token queries against a paged KV pool: the
serving path's one kernel.

Replaces the Pallas TPU kernel ``ray_tpu/ops/paged_flash.py::
_paged_kernel`` (launched by that module's ``paged_flash_attention``)
with the hand-written CUDA kernel in ``csrc/paged_attention.cu``, built
for Hopper (``sm_90a``) at first use and bound with :mod:`ctypes`.

What bounds it on the H100: bytes at decode, which reads every live K/V
row once per (sequence, kv head) and does about two flops per byte read,
far below the ~295 flops per byte at which bf16 tensor cores become the
limit; the tensor cores at chunked prefill. The kernel reads only live
pages (``paged_work_pages``) and keys some row of its block may see,
stages 64-key tiles with ``cp.async`` in a ring of shared-memory stages
for every row of the block, runs both products on the tensor cores
(``mma.sync``), and splits each sequence's keys over blocks of
:data:`PAGED_SPLIT_KEYS` keys (:func:`paged_split_plan`), whose f32
partials a second kernel merges (:func:`paged_combine_plain` is that
merge in plain PyTorch). See the source for the layout.

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
#: the wrapper's contract on kv_block_size (the engine's block sizes); the
#: key-tile kernel itself has no limit of its own
_MAX_BLOCK_SIZE = 32
_ROW_TILES = (16, 32, 64)
#: keys one block of the kernel covers: a sequence's keys are split over
#: ``ceil(T * bs / PAGED_SPLIT_KEYS)`` blocks (a multiple of the kernel's
#: 64-key tile, at most 256). Smaller splits mean more blocks but more f32
#: partials to write and merge, which at prefill's many rows cost more
#: than the parallelism gains beyond a few splits.
PAGED_SPLIT_KEYS = 256


def paged_work_pages(lens, block_size: int):
    """Pages a length-aware kernel touches per sequence:
    ``max(ceil(lens / block_size), 1)`` (an idle ``lens = 0`` slot still
    reads its one trash page). Works on numpy arrays, tensors and ints."""
    if hasattr(lens, "clip"):
        return ((lens + block_size - 1) // block_size).clip(min=1)
    return max(-(-lens // block_size), 1)


def paged_row_tile(block_r: int) -> int:
    """The kernel's row tile for a ``block_r``: rounded up to the 16-row
    mma tile, then to 32 or 64 (a block's 4 warps are ``tile / 16`` row
    tiles x ``64 / tile`` key slices)."""
    for tile in _ROW_TILES:
        if 1 <= block_r <= tile:
            return tile
    raise ValueError(f"block_r must be in [1, {_ROW_TILES[-1]}], got "
                     f"{block_r}")


def default_paged_block_r(rows: int) -> int:
    """Query rows per CUDA block on the H100, for ``rows = C * H / KVH``
    rows per (sequence, kv head). Decode has 1 (GPT-J) or 4 (32/8 GQA)
    rows: one 16-row tile, so the 4 warps take 16 keys each of every
    staged 64-key tile and every warp loads and computes. Chunked prefill
    has hundreds: 64-row tiles, so each staged key serves 64 rows (4 row
    warps), which quarters the K/V re-reads of 16-row tiles."""
    return paged_row_tile(min(max(rows, 1), _ROW_TILES[-1]))


def paged_split_plan(window_keys: int,
                     split_keys: int = PAGED_SPLIT_KEYS):
    """``(n_splits, split_keys)`` for a table window of ``window_keys =
    T * bs`` keys: split ``i`` covers keys ``[i * split_keys, (i + 1) *
    split_keys)``; a split past a sequence's live keys does nothing."""
    return max(-(-window_keys // split_keys), 1), split_keys


def _library():
    from ray_tpu_torch._build import load_library
    lib = load_library(_SOURCE)
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p,          # q k v bt pos lens out
                       p, p, p,                      # part_o part_lse part_n
                       i, i, i, i, i, i, i, i,       # B C H KVH D bs T N
                       ctypes.c_float, i, i, i,      # scale block_r splits keys
                       i, p]                         # dtype stream
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
    paged_row_tile(block_r)   # raises outside [1, 64]
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
    rows = c * (h // max(g, 1))
    if not block_r:
        block_r = default_paged_block_r(rows)
    _check(q, k_cache, v_cache, block_tables, q_positions, lens, block_r)
    tile = paged_row_tile(block_r)
    n_splits, split_keys = paged_split_plan(t * bs)
    out = torch.empty_like(q)
    parts = (0, 0, 0)
    if n_splits > 1:   # f32 partials of each split, merged by a 2nd kernel
        part_o = torch.empty((n_splits, b, g, rows, d), dtype=torch.float32,
                             device=q.device)
        part_lse = torch.empty((n_splits, b, g, rows), dtype=torch.float32,
                               device=q.device)
        part_n = torch.empty((b, g, -(-rows // tile)), dtype=torch.int32,
                             device=q.device)
        parts = (part_o.data_ptr(), part_lse.data_ptr(), part_n.data_ptr())
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 block_tables.data_ptr(), q_positions.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), *parts,
                 b, c, h, g, d, bs, t, n, float(sm_scale), tile, n_splits,
                 split_keys, _DTYPE_CODES[q.dtype], stream)
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


def paged_split_partials_plain(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               block_tables: torch.Tensor,
                               q_positions: torch.Tensor,
                               lens: torch.Tensor, *,
                               sm_scale: Optional[float] = None,
                               split_keys: int = PAGED_SPLIT_KEYS):
    """Each split's f32 partials, as the kernel's blocks leave them:
    ``part_o [S, B, C, H, D]`` (that split's softmax-weighted V, already
    divided by its own denominator) and ``part_lse [S, B, C, H]`` (``m +
    log l`` over the split's keys; ``-inf`` where the row sees none of
    them). ``S`` is :func:`paged_split_plan` of the table window."""
    b, c, h, d = q.shape
    n, bs, g, _ = k_cache.shape
    t = block_tables.shape[1]
    rep = h // g
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n_splits, split_keys = paged_split_plan(t * bs, split_keys)
    bt = block_tables.long()
    k = k_cache[bt].reshape(b, t * bs, g, d).float()
    v = v_cache[bt].reshape(b, t * bs, g, d).float()
    key_pos = torch.arange(t * bs, device=q.device)
    pages = paged_work_pages(lens.long(), bs)
    live = key_pos[None, :] < (pages * bs)[:, None]
    mask = (key_pos[None, None, :] <= q_positions.long()[:, :, None]) \
        & live[:, None, :]
    qg = q.reshape(b, c, g, rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * sm_scale
    s = s.masked_fill(~mask[:, None, None], -math.inf)
    outs, lses = [], []
    for i in range(n_splits):
        keys = slice(i * split_keys, (i + 1) * split_keys)
        si = s[..., keys]
        m = si.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(si - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, v[:, keys])
        l_q = l.squeeze(-1).permute(0, 3, 1, 2)[..., None]   # [B, C, G, R, 1]
        outs.append((o / torch.where(l_q > 0, l_q, torch.ones_like(l_q)))
                    .reshape(b, c, h, d))
        lse = torch.where(l > 0, m + torch.log(l),
                          torch.full_like(l, -math.inf))
        lses.append(lse.squeeze(-1).permute(0, 3, 1, 2).reshape(b, c, h))
    return torch.stack(outs), torch.stack(lses)


def paged_combine_plain(part_o: torch.Tensor,
                        part_lse: torch.Tensor) -> torch.Tensor:
    """Merge split partials (leading axis) into f32 outputs: weights
    ``exp(lse_s - max_s lse)``, a split with ``lse = -inf`` weighs 0, and
    a row no split saw is 0 (never NaN). The function the card's merge
    kernel computes."""
    top = part_lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(part_lse - top)              # exp(-inf) = 0
    total = w.sum(dim=0)
    o = (w[..., None] * part_o).sum(dim=0)
    return o / torch.where(total > 0, total, torch.ones_like(total))[..., None]


def paged_flash_attention_split_plain(q, k_cache, v_cache, block_tables,
                                      q_positions, lens, *,
                                      sm_scale: Optional[float] = None,
                                      split_keys: int = PAGED_SPLIT_KEYS
                                      ) -> torch.Tensor:
    """:func:`paged_flash_attention_plain` computed as the kernel splits
    it: per-split partials, then :func:`paged_combine_plain`. Same inputs
    and output."""
    part_o, part_lse = paged_split_partials_plain(
        q, k_cache, v_cache, block_tables, q_positions, lens,
        sm_scale=sm_scale, split_keys=split_keys)
    return paged_combine_plain(part_o, part_lse).to(q.dtype)
