"""Stable softmax cross entropy for language-model heads, as in
``ray_tpu/ops/cross_entropy.py``.

- :func:`cross_entropy_loss`: the reference, on materialized logits, in
  f32 with log-sum-exp, optional z-loss and a validity mask.
- :func:`fused_lm_head_loss`: the memory-lean path the trainer takes. It
  projects the final hidden states to logits one sequence chunk at a
  time, reduces each chunk to its log-sum-exp and label logit, and keeps
  only the per-token LSE; the backward recomputes each chunk's logits to
  form dX, dW and db. The full ``[batch, seq, vocab]`` logits tensor is
  never resident.

Logits stay f32: a chunk's projection accumulates the compute-dtype
products in f32 and returns them in f32 (``torch.mm(..., out_dtype=
torch.float32)`` on the card), as the JAX package's
``preferred_element_type=jnp.float32`` does, so they are not rounded to
bf16 before the log-sum-exp.

Vocab-parallel (``tp_group``, the group the head's vocab dim is split
over): each rank projects its vocab slice, and per chunk the row max,
the sum of exponentials and the target's logit are all-reduced over the
group, so that every rank holds the full log-sum-exp and loss; the
backward is the local softmax minus the one-hot of targets in this
rank's slice, and its ``dx`` is this slice's share (the caller sums it
over the group, ``collective.copy_to_region``). The head is never
gathered. ``normalizer`` divides the masked sum by a count the caller
gives (the global batch's, under data parallelism) instead of the local
one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.parallel.collective import _all_reduce


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result. On the card a bf16 product runs on
    the tensor cores with f32 accumulation and an f32 output; elsewhere
    (and for f32 inputs) the operands are upcast, which gives the same
    f32 sums of exact products."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0,
                       normalizer: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross entropy. ``logits (..., vocab)``, ``labels (...)``
    int, ``mask (...)`` of valid positions. Returns ``(loss,
    n_valid_tokens)``; with ``normalizer`` the masked sum over it and
    ``normalizer`` as the count."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if z_loss_coeff:
        nll = nll + z_loss_coeff * lse.square()
    if mask is None:
        n = torch.tensor(float(nll.numel()), device=nll.device)
        total = nll.sum()
    else:
        mask = mask.float()
        n = mask.sum().clamp_min(1.0)
        total = (nll * mask).sum()
    if normalizer is not None:
        n = normalizer
    return total / n, n


class _FusedLMHeadLoss(torch.autograd.Function):
    """Chunked LM-head projection + cross entropy with a recomputing
    backward (the JAX package's ``_fused_ce`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, bias, labels, mask, chunk: int, z: float, tp,
                normalizer):
        b, s, e = x.shape
        wd = w.to(x.dtype)
        # this rank's vocab slice [lo, lo + vl) of the labels' index space
        labels = labels.long() - (tp.rank * w.shape[-1] if tp else 0)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = torch.empty((b, s), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            j = min(i + chunk, s)
            logits = _mm_f32(x[:, i:j].reshape(-1, e), wd)
            if bias is not None:
                logits = logits + bias.float()
            lab = labels[:, i:j].reshape(-1, 1)
            if tp is None:
                lse = torch.logsumexp(logits, dim=-1)
                ll = logits.gather(1, lab)[:, 0]
            else:
                inside = (lab >= 0) & (lab < logits.shape[1])
                m = _all_reduce(logits.amax(dim=-1), tp, "max")
                se = _all_reduce(torch.exp(logits - m[:, None]).sum(-1), tp)
                lse = m + torch.log(se)
                ll = _all_reduce((logits.gather(
                    1, lab.clamp(0, logits.shape[1] - 1)) * inside)[:, 0], tp)
            nll = lse - ll
            if z:
                nll = nll + z * lse.square()
            loss_sum = loss_sum + (nll * mask[:, i:j].reshape(-1)).sum()
            lses[:, i:j] = lse.view(b, j - i)
        n = mask.sum().clamp_min(1.0) if normalizer is None else normalizer
        ctx.save_for_backward(x, w, bias, labels, mask, lses, n)
        ctx.chunk, ctx.z, ctx.tp = chunk, z, tp
        ctx.mark_non_differentiable(n)
        return loss_sum / n, n

    @staticmethod
    def backward(ctx, g_loss, _g_n):
        x, w, bias, labels, mask, lses, n = ctx.saved_tensors
        chunk, z = ctx.chunk, ctx.z
        b, s, e = x.shape
        wd = w.to(x.dtype)
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device)
        scale = g_loss.float() / n
        for i in range(0, s, chunk):
            j = min(i + chunk, s)
            xi = x[:, i:j].reshape(-1, e)
            logits = _mm_f32(xi, wd)
            if bias is not None:
                logits = logits + bias.float()
            lse = lses[:, i:j].reshape(-1)
            coef = scale * mask[:, i:j].reshape(-1)
            zf = coef * (1.0 + 2.0 * z * lse) if z else coef
            dl = torch.exp(logits - lse[:, None]).mul_(zf[:, None])
            lab = labels[:, i:j].reshape(-1)
            if ctx.tp is None:
                rows = torch.arange(dl.shape[0], device=dl.device)
                dl[rows, lab] -= coef
            else:       # the one-hot of the targets in this vocab slice
                inside = (lab >= 0) & (lab < dl.shape[1])
                dl.scatter_add_(1, lab.clamp(0, dl.shape[1] - 1)[:, None],
                                (-coef * inside)[:, None])
            db += dl.sum(dim=0)
            dlc = dl.to(x.dtype)
            dx[:, i:j] = (dlc @ wd.t()).view(b, j - i, e)
            dw += _mm_f32(xi.t(), dlc)
        return (dx, dw.to(w.dtype),
                db.to(bias.dtype) if bias is not None else None,
                None, None, None, None, None, None)


def fused_lm_head_loss(x: torch.Tensor, head_w: torch.Tensor,
                       labels: torch.Tensor, *,
                       head_bias: Optional[torch.Tensor] = None,
                       mask: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0,
                       chunk_size: int = 512, tp_group=None,
                       normalizer: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked fused LM-head projection + cross entropy.

    ``x (b, s, e)`` final hidden states in the compute dtype; ``head_w
    (e, v)`` master weights (cast to ``x.dtype`` for the product, f32
    accumulation and f32 logits); ``labels (b, s)``; ``mask (b, s)``
    valid positions (data: it gets no gradient). ``chunk_size`` tokens of
    each sequence are projected at a time (``0`` or ``>= s``: one chunk).
    Returns ``(mean_loss, n_valid_tokens)`` like
    :func:`cross_entropy_loss`. ``tp_group`` (an ``AxisGroup``) makes
    ``head_w (e, v / tp)`` and ``head_bias`` this rank's vocab slice and
    the loss vocab-parallel; ``normalizer`` replaces the local count.
    """
    b, s, _ = x.shape
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    chunk = chunk_size if chunk_size and chunk_size > 0 else s
    tp = tp_group if tp_group is not None and tp_group.size > 1 else None
    return _FusedLMHeadLoss.apply(x, head_w, head_bias, labels, mask,
                                  int(chunk), float(z_loss_coeff), tp,
                                  normalizer)
