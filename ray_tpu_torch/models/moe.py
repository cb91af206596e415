"""Mixture-of-experts MLP with capacity-based top-1 (Switch) routing: the
port of ``ray_tpu/models/moe.py``.

Each token goes to the expert of its largest router probability
(``gate``); an expert takes at most ``capacity = max(1,
int(capacity_factor * N / E))`` tokens, filled in ``(batch, seq)`` order
over all ``N`` tokens of the global batch, and the overflow is dropped:
it adds zero and the residual carries it. A kept token's output is its
expert's ``gelu(x @ moe_wi[e]) @ moe_wo[e]`` (tanh GELU, ``jax.nn.gelu``'s
default) times its gate. JAX dispatches through a one-hot ``[tokens,
experts, capacity]`` einsum; here each expert gathers its kept tokens by
index and adds its output back by index, which computes the same sums
(each token has one nonzero dispatch entry).

Over a mesh (:func:`moe_layer` with a ``models.transformer.ModelLayout``)
the tokens stay split over the data axes and are never split over
``ep``: every rank of an ep group routes the same tokens, runs only its
own experts (``moe_wi``/``moe_wo`` are sharded on their expert dim) and
the expert outputs are summed over ``ep``. The capacity and each token's
slot count every token of the global batch: the per-row, per-expert
counts are gathered over the data axes, and a rank's slots start after
the tokens of the rows (and sequence chunks) before its own, as JAX's
``cumsum`` over the global array does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.collective import (_all_gather, copy_to_region,
                                               reduce_from_region)


def moe_param_shapes(c) -> Dict[str, Tuple[int, ...]]:
    """(name -> shape) for one layer's MoE parameters."""
    return {
        "moe_wg": (c.d_model, c.n_experts),
        "moe_wi": (c.n_experts, c.d_model, c.d_ff),
        "moe_wo": (c.n_experts, c.d_ff, c.d_model),
    }


def moe_logical_axes() -> Dict[str, Tuple]:
    return {
        "moe_wg": ("layers", "embed", None),
        "moe_wi": ("layers", "expert", "embed", "mlp"),
        "moe_wo": ("layers", "expert", "mlp", "embed"),
    }


def _route(c, wg: torch.Tensor, x: torch.Tensor):
    """Router of tokens ``x [N, D]`` (compute dtype): f32 softmax
    probabilities ``[N, E]``, the top-1 gate ``[N]`` and expert ``[N]``
    (the first index on ties, as ``jnp.argmax``)."""
    probs = torch.softmax((x @ wg.to(c.dtype)).float(), dim=-1)
    expert = probs.argmax(dim=-1)
    return probs, probs.gather(1, expert[:, None])[:, 0], expert


def _expert_outputs(c, wi: torch.Tensor, wo: torch.Tensor,
                    x: torch.Tensor, gate: torch.Tensor,
                    expert: torch.Tensor, keep: torch.Tensor,
                    first: int = 0) -> torch.Tensor:
    """``[N, D]``: each kept token's output from its expert among experts
    ``first .. first + wi.shape[0] - 1`` (the rows of ``wi``/``wo``)
    weighted by its gate, zero for every other token. Under tensor
    parallelism ``wi``/``wo`` are this rank's ``mlp`` slices and the
    result is its share of the sum."""
    dt = c.dtype
    y = torch.zeros_like(x)
    g = gate.to(dt)
    for j in range(wi.shape[0]):
        idx = ((expert == first + j) & keep).nonzero().squeeze(1)
        h = F.gelu(x[idx] @ wi[j].to(dt), approximate="tanh")
        y = y.index_add(0, idx, (h @ wo[j].to(dt)) * g[idx, None])
    return y


def moe_layer(c, lp: Dict[str, torch.Tensor], h: torch.Tensor, lay=None,
              h_split: Optional[torch.Tensor] = None):
    """One MoE MLP on the normed block input ``h [b, s, D]``.

    Returns ``(out, aux, stats)``: ``out [b, s, D]`` in the compute dtype,
    ``aux`` the Switch load-balancing term as this rank adds it to its
    loss (on one device the whole term; over a mesh this rank's share of
    it, whose sum over the data axes is the term), and ``stats`` a
    detached ``[2]`` tensor of the whole term's value and the share of
    the global batch's tokens dropped for capacity.

    Over a mesh (``lay``, a ``models.transformer.ModelLayout``) ``h`` is
    this rank's rows and sequence chunk, replicated over the heads and
    expert groups, and ``h_split`` is ``h`` entered into the heads'
    region (:func:`~ray_tpu_torch.parallel.collective.copy_to_region`):
    the router reads ``h``, so its gradient is whole on every rank; the
    experts read ``h_split`` and the gate entered into the expert group,
    and ``out`` is summed over the experts (``ep``) but is this rank's
    share over the heads axis, which the caller sums."""
    dt = c.dtype
    b, s, d = h.shape
    E = c.n_experts
    x = h.reshape(b * s, d).to(dt)
    probs, gate, expert = _route(c, lp["moe_wg"], x)
    onehot = F.one_hot(expert, E).view(b, s, E)
    # per-row counts of each expert and the probabilities' sums, gathered
    # over the data axes (ranks ordered batch-major, then sequence chunk)
    mine = torch.cat([onehot.sum(1).reshape(-1).float(),
                      probs.detach().sum(0)])
    n_seq, me = 1, 0
    if lay is not None:
        n_seq, me = lay.seq.size, lay.data.rank
        every = _all_gather(mine, lay.data)
    else:
        every = mine[None]
    n_ranks = every.shape[0]
    counts = every[:, :b * E].reshape(n_ranks // n_seq, n_seq, b, E) \
        .transpose(1, 2).reshape(-1, E)        # global (row, chunk) order
    before = counts.cumsum(0) - counts
    b_rank, s_rank = divmod(me, n_seq)
    rows = (b_rank * b + torch.arange(b, device=h.device)) * n_seq + s_rank
    start = before[rows].long()                  # [b, E]
    n = n_ranks * b * s
    capacity = max(1, int(c.capacity_factor * n / E))
    slot = ((onehot.cumsum(1) + start[:, None]) * onehot).sum(-1) - 1
    keep = (slot < capacity).reshape(-1)

    total = counts.sum(0)                        # tokens routed to each
    frac = total / n
    aux = E * (frac * probs.sum(0) / n).sum()
    whole = E * (frac * every[:, b * E:].sum(0) / n).sum()
    dropped = 1.0 - total.clamp(max=capacity).sum() / n
    stats = torch.stack([whole, dropped]).detach()

    if lay is None:
        out = _expert_outputs(c, lp["moe_wi"], lp["moe_wo"], x, gate,
                              expert, keep)
    else:
        ep = lay.experts
        xe = copy_to_region(h_split.reshape(b * s, d).to(dt), ep)
        ge = copy_to_region(copy_to_region(gate, lay.heads), ep)
        out = reduce_from_region(_expert_outputs(
            c, lp["moe_wi"], lp["moe_wo"], xe, ge, expert, keep,
            first=ep.rank * (E // ep.size)), ep)
    return out.view(b, s, d), aux, stats


def moe_mlp(c, lp: Dict[str, torch.Tensor], h: torch.Tensor):
    """h: ``[batch, seq, d_model]`` (compute dtype). Returns ``(out,
    aux_loss)``, the JAX function's pair, on one device.

    ``lp`` carries ``moe_wg [D, E]``, ``moe_wi [E, D, F]``, ``moe_wo [E,
    F, D]``. ``aux_loss`` is the Switch load-balancing term, ``E *
    sum_e frac_e * mean_prob_e`` (encourages uniform routing; weight it
    into the training loss)."""
    out, aux, _ = moe_layer(c, lp, h)
    return out, aux
