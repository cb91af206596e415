"""Ring attention: sequence-parallel causal attention over an ``sp``
group, the port of ``ray_tpu/ops/ring_attention.py``.

The sequence is split over the ranks of the group, contiguously by ring
rank: rank ``i`` holds global positions ``[i*sl, (i+1)*sl)`` of Q, K and
V. The K/V chunks rotate around the ring (``collective.ppermute``, rank
``i`` sending to ``i+1``) while each rank streams them through a
flash-style ``(m, l, acc)`` accumulator in f32, so no rank holds the
whole sequence. Each block step is pure local compute and runs under
``torch.utils.checkpoint``, as JAX checkpoints its ``_block_step``; the
exchanges stay outside it, so a recompute in the backward repeats no
collective. Reverse-mode through ``ppermute`` runs the reverse ring.

Every rank computes every ring step, as JAX's scan does, also a block
that causal masking leaves wholly out (it came from a later rank and
adds nothing): a rank that left such a step out would leave the block it
received without a gradient, never run that exchange's backward, and
its neighbour would wait in it for good.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.collective import ppermute

_NEG_INF = -1e30


def _block_step(q, kb, vb, q_off: int, k_off: int, m_prev, l_prev, acc,
                causal: bool):
    """One ring step: the local queries ``q (b, sq, h, d)`` (f32, scaled)
    against one rotating K/V block ``(b, sk, h, d)``; ``q_off``/``k_off``
    are the chunks' global offsets; returns the new ``(m, l, acc)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb)
    if causal:
        rows = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        cols = k_off + torch.arange(kb.shape[1], device=q.device)[None, :]
        s = s.masked_fill(cols > rows, _NEG_INF)
    m_next = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_next)
    p = torch.exp(s - m_next[..., None])
    l_next = alpha * l_prev + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, vb)
    return m_next, l_next, acc * alpha[..., None] + pv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``group`` (a mesh
    ``AxisGroup``); layout ``(batch, local_seq, heads, dim)``. Returns
    this rank's output chunk in ``q``'s dtype."""
    n, me = group.size, group.rank
    b, sl, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q32 = q.float() * sm_scale
    kv = torch.stack([k.float(), v.float()])
    q_off = me * sl
    m = torch.full((b, h, sl), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    ring = [(i, (i + 1) % n) for i in range(n)]
    for step in range(n):
        # the block now held came from rank (me - step) mod n
        src = (me - step) % n
        m, l, acc = checkpoint(_block_step, q32, kv[0], kv[1], q_off,
                               src * sl, m, l, acc, causal,
                               use_reentrant=False)
        if step + 1 < n:
            kv = ppermute(kv, group, ring)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l[..., None]
    return o.transpose(1, 2).to(q.dtype)
