"""Model-facing attention API, layout (batch, seq, heads, head_dim) as
in ``ray_tpu/ops/attention.py``.

Dispatch: a CUDA tensor goes to the hand-written kernels (paged
attention, :mod:`ray_tpu_torch.ops.paged_flash`; flash attention,
:mod:`ray_tpu_torch.ops.flash_attention`), a CPU tensor to their plain
PyTorch versions. There is no fallback from a kernel on the card: what
the kernel cannot take raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (check_flash_blocks,
                                               flash_attention_bshd)
from ray_tpu_torch.ops.paged_flash import (paged_flash_attention,
                                           paged_flash_attention_plain)

_NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain masked-softmax attention in f32, layout (B, S, H, D).
    Causality is end-aligned: query i sees keys ``<= i + sk - sq``."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~keep[None, None], _NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, block_tables: torch.Tensor,
                    q_positions: torch.Tensor, *,
                    lens: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    impl: str = "auto",
                    block_r: Optional[int] = None) -> torch.Tensor:
    """Attention of new-token queries against a paged KV cache.

    ``q [B, C, H, D]`` at absolute ``q_positions [B, C]`` attends every
    cached position ``<= q_positions[b, i]`` of its sequence; the caches
    are one layer's ``[num_blocks, block_size, kv_heads, head_dim]``
    pool and ``block_tables[b, t]`` holds the block storing positions
    ``t*bs .. t*bs+bs-1`` of sequence b. GQA queries are grouped onto
    their kv head at read time; the cache is never repeated.

    ``impl``:
    - ``"auto"``: the kernel for a CUDA tensor, the plain version of the
      kernel for a CPU tensor;
    - ``"kernel"``: the CUDA kernel; raises for a CPU tensor (the port
      has no interpret mode);
    - ``"reference"``: the gather over the whole table window with an
      f32 softmax, on any device.

    ``lens [B]`` is each sequence's live token count; ``None`` derives
    the bound ``max(q_positions) + 1`` as the JAX package does.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if impl in ("auto", "kernel"):
        if impl == "kernel" and q.device.type != "cuda":
            raise ValueError(
                f"impl='kernel' needs a CUDA tensor, got {q.device}: the "
                f"port's kernel has no interpret mode (use impl='auto' or "
                f"'reference' on the CPU)")
        if lens is None:
            lens = (q_positions.max(dim=1).values + 1).to(torch.int32)
        # a CPU tensor runs the kernel's plain version inside the wrapper
        return paged_flash_attention(
            q, k_cache, v_cache, block_tables, q_positions, lens,
            sm_scale=sm_scale, block_r=block_r)
    if impl != "reference":
        raise ValueError(f"unknown paged attention impl: {impl!r}")
    # the plain gather with every slot of the table window counted live
    window = block_tables.shape[1] * k_cache.shape[1]
    return paged_flash_attention_plain(
        q, k_cache, v_cache, block_tables, q_positions,
        torch.full((q.shape[0],), window, dtype=torch.int32,
                   device=q.device), sm_scale=sm_scale)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        mask: Optional[torch.Tensor] = None,
                        impl: str = "auto",
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None) -> torch.Tensor:
    """Attention over (batch, seq, heads, head_dim), differentiable.

    ``impl``:
    - ``"auto"``: the flash kernels for a CUDA tensor (forward, and delta,
      dK/dV, dQ in the backward), their plain versions for a CPU tensor;
      what the kernels cannot take raises (head_dim a multiple of 8 up to
      256; a causal call needs ``sq <= sk``); any sequence length;
    - ``"kernel"`` (or the JAX package's ``"flash"``): the kernels; raises
      for a CPU tensor (the port has no interpret mode);
    - ``"reference"``: :func:`attention_reference`, on any device.
    An explicit ``mask`` always takes the reference path (the kernels
    handle only the causal structure). ``block_q``/``block_k`` of
    ``None`` (or 0) take the kernels' fixed tiles.
    """
    if impl == "reference" or mask is not None:
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                   mask=mask)
    if impl not in ("auto", "kernel", "flash"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    if impl != "auto" and q.device.type != "cuda":
        raise ValueError(
            f"impl={impl!r} needs a CUDA tensor, got {q.device}: the "
            f"port's kernels have no interpret mode (use impl='auto' or "
            f"'reference' on the CPU)")
    check_flash_blocks(block_q, block_k)
    return flash_attention_bshd(q, k, v, causal=causal, sm_scale=sm_scale)
