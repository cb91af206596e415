"""Sharding rules: logical axis names -> mesh axes, the port of
``ray_tpu/parallel/sharding.py``.

Parameters carry *logical* axis names ("embed", "mlp", "heads", ...); a
rule table maps each to zero or more mesh axes. A spec (the port's
``PartitionSpec``) is a tuple with one entry per dim: ``None``
(replicated), a mesh axis, or a tuple of mesh axes. Where JAX compiles a
``NamedSharding`` into collectives, the port's layouts are explicit:
:func:`shard_params` hands each rank its slice of each leaf, exactly the
data of the addressable shard ``NamedSharding`` places on JAX device
``i`` for port rank ``i``, and the model and the train step issue the
collectives themselves. :func:`constrain` checks a layout and moves
nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.mesh import (axis_sizes, mesh_coordinate)

AxisTarget = Union[None, str, Tuple[str, ...]]


class ShardingRules(dict):
    """logical axis name -> mesh axis (or tuple, or None=replicate)."""

    def spec_for(self, logical_axes: Sequence[Optional[str]]
                 ) -> Tuple[AxisTarget, ...]:
        return tuple(self.get(a) if a is not None else None
                     for a in logical_axes)


# The JAX package's rule tables. "embed"/"mlp"/"heads"/"kv"/"vocab" are
# the model-side logical names of ray_tpu_torch.models.
FSDP_RULES = ShardingRules(
    batch=("dp", "fsdp"),
    sequence="sp",
    embed="fsdp",       # shard params along embed dim (ZeRO-3-like)
    mlp="tp",
    heads="tp",
    kv=None,
    vocab="tp",
    expert="ep",
    stage="pp",
)

DDP_RULES = ShardingRules(
    batch=("dp", "fsdp"),
    sequence="sp",
    embed=None,          # params fully replicated
    mlp="tp",
    heads="tp",
    kv=None,
    vocab="tp",
    expert="ep",
    stage="pp",
)


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules: ShardingRules) -> Tuple[AxisTarget, ...]:
    return rules.spec_for(logical_axes)


def spec_axes(entry: AxisTarget) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in its own (major-to-minor)
    order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(shape: Sequence[int], spec: Sequence[AxisTarget],
                 sizes: Dict[str, int], coord: Dict[str, int]
                 ) -> Tuple[slice, ...]:
    """The slice of a ``shape`` array that the rank at ``coord`` holds
    under ``spec``: each dim is cut into as many equal chunks as its
    axes' sizes multiply to, and the chunk index ravels the axes'
    coordinates in the entry's order (as ``NamedSharding`` does). A dim
    its axes do not divide raises."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    out = []
    seen = set()
    for d, n in enumerate(shape):
        axes = spec_axes(spec[d]) if d < len(spec) else ()
        if seen & set(axes):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        seen |= set(axes)
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(
                f"dim {d} of {tuple(shape)} ({n}) is not divisible by the "
                f"{parts} shards of {axes}")
        k = n // parts
        out.append(slice(idx * k, (idx + 1) * k))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence[AxisTarget],
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of each rank's shard of a ``shape`` array under
    ``spec``."""
    zero = {a: 0 for a in sizes}
    return tuple(s.stop - s.start for s in
                 local_slices(shape, spec, sizes, zero))


def shard_leaf(x: torch.Tensor, spec: Sequence[AxisTarget],
               mesh) -> torch.Tensor:
    """This rank's shard of the global tensor ``x``, a contiguous copy
    (so the global tensor can be freed)."""
    sl = local_slices(x.shape, spec, axis_sizes(mesh),
                      mesh_coordinate(mesh))
    return x[sl].clone(memory_format=torch.contiguous_format)


def _is_axes(x) -> bool:
    return x is None or isinstance(x, tuple)


def tree_map_axes(fn, params, logical_axes_tree):
    """``fn(leaf, logical_axes)`` over a params tree and its logical-axes
    tree of the same structure (an axes entry of None replicates)."""
    if isinstance(params, dict):
        return {k: tree_map_axes(fn, v, logical_axes_tree[k])
                for k, v in params.items()}
    if not _is_axes(logical_axes_tree):
        raise ValueError(f"no logical axes for a leaf: {logical_axes_tree!r}")
    return fn(params, logical_axes_tree)


def param_specs(logical_axes_tree, rules: ShardingRules):
    """The spec of every leaf of a logical-axes tree (``()`` for a
    replicated leaf): the port's ``state_shardings``."""
    if isinstance(logical_axes_tree, dict):
        return {k: param_specs(v, rules)
                for k, v in logical_axes_tree.items()}
    if logical_axes_tree is None:
        return ()
    return rules.spec_for(logical_axes_tree)


def shard_params(params, logical_axes_tree, rules: ShardingRules, mesh):
    """This rank's slice of every leaf of ``params`` (global tensors, any
    device), as ``NamedSharding(mesh, rules.spec_for(axes))`` places it
    on JAX device ``rank``. A logical-axes entry of None replicates."""
    def one(x, axes):
        return shard_leaf(x, () if axes is None else rules.spec_for(axes),
                          mesh)
    return tree_map_axes(one, params, logical_axes_tree)


def batch_sharding(mesh, rules: ShardingRules,
                   batch_axes: Sequence[Optional[str]] = ("batch",)
                   ) -> Tuple[AxisTarget, ...]:
    """Spec of an input batch (leading batch dim over dp/fsdp)."""
    del mesh
    return rules.spec_for(list(batch_axes))


def replicated(mesh) -> Tuple[AxisTarget, ...]:
    del mesh
    return ()


def constrain(x: torch.Tensor, mesh, rules: ShardingRules,
              logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Check that ``x`` (this rank's shard) can carry ``logical_axes``
    under ``rules`` on ``mesh``: one name per dim, mesh axes that exist,
    none used twice. Returns ``x`` unmoved: the port's layouts are
    explicit, where ``with_sharding_constraint`` asks XLA for one."""
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes for a "
                         f"{x.dim()}-dim tensor")
    sizes = axis_sizes(mesh)
    seen = set()
    for entry in rules.spec_for(logical_axes):
        axes = spec_axes(entry)
        if set(axes) - set(sizes) or seen & set(axes):
            raise ValueError(f"layout {rules.spec_for(logical_axes)} does "
                             f"not fit mesh axes {tuple(sizes)}")
        seen |= set(axes)
    return x


def infer_param_logical_axes(params) -> object:
    """Fallback heuristic for unannotated params: shard the largest dim of
    big (>=2D, >=2^16 elements) tensors on "embed", replicate the rest."""
    if isinstance(params, dict):
        return {k: infer_param_logical_axes(v) for k, v in params.items()}
    p = params
    if p.dim() >= 2 and p.numel() >= (1 << 16):
        axes: list = [None] * p.dim()
        axes[int(max(range(p.dim()), key=lambda i: p.shape[i]))] = "embed"
        return tuple(axes)
    return None


# ----------------------------------------------- flat 1/N update shards
# Cross-replica sharded weight update (arXiv:2004.13336): gradients and
# master-param working copies flatten to 1-D, pad to n_shards * k quant
# blocks (so int8 transport and the flat layout share block boundaries),
# and shard over the data axes: each rank updates only its 1/N chunk of
# the flat optimizer state, then the fresh params all-gather back.

def flat_pad_len(n: int, n_shards: int, block_size: int) -> int:
    """Padded flat length: the smallest multiple of ``n_shards`` whole
    quant blocks that holds ``n`` elements."""
    chunk = -(-n // n_shards)
    chunk = -(-chunk // block_size) * block_size
    return chunk * n_shards


def flatten_leaf(x: torch.Tensor, n_shards: int,
                 block_size: int) -> torch.Tensor:
    """1-D zero-padded flat copy of one leaf (see :func:`flat_pad_len`)."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, flat_pad_len(flat.numel(), n_shards, block_size)
                        - flat.numel()))


def flatten_tree(tree, n_shards: int, block_size: int):
    """:func:`flatten_leaf` of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: flatten_tree(v, n_shards, block_size)
                for k, v in tree.items()}
    return flatten_leaf(tree, n_shards, block_size)


def unflatten_like(template, flat_tree):
    """Invert :func:`flatten_tree`: cut each padded flat leaf back to its
    template leaf's size and shape."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat_tree[k])
                for k, v in template.items()}
    n = math.prod(template.shape)
    return flat_tree[:n].reshape(template.shape)
