"""Pipeline parallelism as one SPMD program over the ``pp`` axis of a mesh:
the port of ``ray_tpu/ops/pipeline.py`` (the GPipe schedule).

Every rank of a ``pp`` group runs the same tick loop:

- layer parameters are stacked ``[n_stages, ...]`` and split on ``pp``:
  each rank holds its stage's slice (leading dim 1), as
  ``parallel.shard_params`` places a leaf whose spec is ``P("pp")``;
- the loop runs the GPipe schedule over ``M + S - 1`` ticks: at tick t,
  stage s computes microbatch ``t - s``, and the output hops to the next
  stage with one differentiable ``collective.ppermute`` a tick;
- autograd through the loop and the exchanges runs the backward
  schedule, the exchanges' backward the reverse ring.

Every tick computes on every rank. Stage 0 recomputes ``xs[M-1]`` at late
ticks and later stages compute on zeros at early ticks: those outputs
enter the microbatch buffer through ``torch.where`` with a false mask,
so their cotangents are zeros and every rank runs the same ticks forward
and backward, its exchanges in the same order (an exchange one rank
skipped would leave its neighbour waiting). The last stage's outputs are
summed over ``pp`` forward and taken as they are backward
(``collective.reduce_from_region``): each rank backpropagates its own
copy of the replicated output, so an all-reduce backward would multiply
every stage's gradient by S.

Bubble fraction is the GPipe ``(S-1)/(M+S-1)``; choose microbatches >>
stages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ray_tpu_torch.parallel.collective import ppermute, reduce_from_region
from ray_tpu_torch.parallel.mesh import axis_group


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(layer_params_list: List[Dict]) -> Dict:
    """Stack per-stage parameter trees into ``[n_stages, ...]`` leaves
    (split the leading axis on ``pp``)."""
    return _tree_map(lambda *xs: torch.stack(xs), *layer_params_list)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params, x: torch.Tensor, mesh,
                   n_microbatches: int, axis: str = "pp") -> torch.Tensor:
    """Run ``stage_fn`` as an ``S``-stage GPipe pipeline over ``axis`` of
    ``mesh`` (a ``build_mesh`` DeviceMesh; this rank's stage is its
    coordinate on ``axis``).

    stage_params: this rank's slice of the stacked tree, leaves ``[1,
    ...]``. x: ``[batch, ...]``, the same on every rank of the group;
    split into ``n_microbatches``. ``stage_fn(params, h)`` keeps the
    microbatch's shape. Returns ``[batch, ...]``, the same on every rank.
    """
    group = axis_group(mesh, axis)
    S, s, M = group.size, group.rank, n_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{M} microbatches")
    xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
    params = _tree_map(lambda a: a[0], stage_params)
    perm = [(i, (i + 1) % S) for i in range(S)]
    dev = x.device
    first = torch.tensor(s == 0, device=dev)
    zeros = torch.zeros_like(xs[0])
    h = zeros
    ys = [zeros] * M
    for t in range(M + S - 1):
        m = t - s                   # the microbatch this stage works on
        inp = torch.where(first, xs[min(max(t, 0), M - 1)], h)
        out = stage_fn(params, inp)
        idx = min(max(m, 0), M - 1)
        write = torch.tensor(0 <= m < M and s == S - 1, device=dev)
        ys[idx] = torch.where(write, out, ys[idx])
        h = ppermute(out, group, perm)
    # only the last stage wrote real outputs; every rank gets them
    last = torch.tensor(s == S - 1, device=dev)
    out = torch.where(last, torch.stack(ys), torch.zeros_like(xs))
    out = reduce_from_region(out, group)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
