"""Carry weights between the JAX package's parameter trees and the port's.

Both trees have the same keys and the same stacked ``[n_layers, ...]``
layer leaves, and the bridge keeps them so. It takes numpy arrays (a
test converts JAX arrays with ``np.asarray``), so the port never imports
JAX. For serving, matrices are cast to the compute dtype once: the JAX
model keeps f32 masters and casts at each use (``.astype(dt)``), which
gives the same numbers. For training (``masters=True``) every leaf stays
f32, as the JAX trainer holds it. Norm scales and biases stay f32 either
way. :func:`train_state_from_jax` carries a whole JAX train state (params
and the optax ``clip -> adamw`` moments) into the port's, and
:func:`policy_state_from_jax` an RLHF ``PolicyLearner``'s (params and the
optax ``clip -> adam`` moments).

Over a mesh: :func:`shard_params_from_jax` and
:func:`shard_train_state_from_jax` give this rank its shards of a JAX
tree or train state (the moments in the flat layout of
``shard_weight_update`` when it is on), and :func:`gather_to_numpy`
joins every rank's shards back into global numpy arrays (a collective:
every rank calls it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: leaves read in f32 by the model (norm scales, biases)
F32_LEAVES = frozenset({"ln_scale", "ln_bias", "fc_in_b", "fc_out_b",
                        "attn_norm", "mlp_norm", "scale", "bias", "b"})


def params_from_jax(tree: Dict[str, Any], config, device,
                    masters: bool = False) -> Dict[str, Any]:
    """Numpy parameter tree (JAX layout) -> tensors on ``device``:
    matrices in ``config.dtype`` (f32 with ``masters=True``), norm scales
    and biases in f32."""
    dev = torch.device(device)

    def convert(name: str, value):
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)   # bf16 (ml_dtypes) and others
        dt = torch.float32 if masters or name in F32_LEAVES \
            else config.dtype
        return torch.tensor(arr).to(device=dev, dtype=dt)   # a copy

    return {k: convert(k, v) for k, v in tree.items()}


def to_numpy(tree):
    """Tensor tree (or tensor) -> numpy f32 arrays of the same tree, each a
    copy (never a view of a CPU tensor that may change later)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32, copy=True).numpy()


def _find_adam_state(opt_state):
    """The optax ``ScaleByAdamState`` (the node with ``count``, ``mu`` and
    ``nu``) inside a numpy-converted optax state of nested tuples."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def _adam_from_jax(opt_state, config, dev) -> Dict[str, Any]:
    """The optax adam moments of a numpy-converted chain state as the
    port's ``{"count", "mu", "nu"}`` (f32, on ``dev``)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the opt_state")
    return {"count": torch.tensor(int(np.asarray(adam.count)),
                                  dtype=torch.int32, device=dev),
            "mu": params_from_jax(adam.mu, config, dev, masters=True),
            "nu": params_from_jax(adam.nu, config, dev, masters=True)}


def policy_state_from_jax(state: Dict[str, Any], config,
                          device) -> Dict[str, Any]:
    """A JAX RLHF ``PolicyLearner``'s state (``{"params", "opt_state"}``
    with an optax ``clip_by_global_norm -> adam`` chain state, leaves as
    numpy arrays) -> the port's ``PolicyLearner`` state (f32 params and
    ``{"count", "mu", "nu"}`` on ``device``), which its ``load_state``
    takes, so a learner resumes where the JAX one stopped."""
    dev = torch.device(device)
    return {"params": params_from_jax(state["params"], config, dev,
                                      masters=True),
            "opt_state": _adam_from_jax(state["opt_state"], config, dev)}


def train_state_from_jax(state: Dict[str, Any], config,
                         device) -> Dict[str, Any]:
    """A JAX train state (``{"params", "opt_state", "step"}`` with an optax
    ``clip_by_global_norm -> adamw`` state, leaves as numpy arrays) ->
    the port's train state: f32 params, ``{"count", "mu", "nu"}`` and
    ``step`` on ``device``, so a run resumes where the JAX one stopped."""
    dev = torch.device(device)
    return {
        "params": params_from_jax(state["params"], config, dev, masters=True),
        "opt_state": _adam_from_jax(state["opt_state"], config, dev),
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=dev)}


def _sharding(config, mesh, rules):
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel.sharding import FSDP_RULES, param_specs
    rules = FSDP_RULES if rules is None else rules
    return param_specs(logical_axes(config), rules)


def _shard_tree(tree, specs, mesh, dev):
    from ray_tpu_torch.parallel.mesh import axis_sizes, mesh_coordinate
    from ray_tpu_torch.parallel.sharding import local_slices
    sizes, coord = axis_sizes(mesh), mesh_coordinate(mesh)

    def one(value, spec):
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        return torch.tensor(arr[local_slices(arr.shape, spec, sizes,
                                             coord)]).to(dev)

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        return one(t, sp)
    return walk(tree, specs)


def shard_params_from_jax(tree: Dict[str, Any], config, mesh, rules=None, *,
                          device) -> Dict[str, Any]:
    """A numpy parameter tree (JAX layout, global arrays) -> this rank's
    f32 shards on ``device`` under ``(mesh, rules)`` (default
    ``FSDP_RULES``): the data JAX device ``rank`` holds."""
    return _shard_tree(tree, _sharding(config, mesh, rules), mesh,
                       torch.device(device))


def shard_train_state_from_jax(state: Dict[str, Any], config, mesh,
                               rules=None, *, device,
                               shard_weight_update: bool = False,
                               quant_block_size: int = 256
                               ) -> Dict[str, Any]:
    """A JAX train state (numpy leaves; with ``shard_weight_update`` its
    moments in the JAX flat layout) -> this rank's train state of
    ``make_train_step(config, mesh, rules, shard_weight_update=...,
    quant_block_size=...)``: param and moment shards, and in the flat
    layout each moment as this rank's chunk of its flattened shard."""
    from ray_tpu_torch.models.training import (_flat_chunk, _get, _paths,
                                               leaf_plans)
    from ray_tpu_torch.models.transformer import param_shapes, set_leaf
    dev = torch.device(device)
    specs = _sharding(config, mesh, rules)
    adam = _find_adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the opt_state")
    if shard_weight_update:
        shapes = param_shapes(config)
        plans = leaf_plans(config, mesh, rules, True)
        moments = {}
        for name in ("mu", "nu"):
            out: Dict = {}
            tree = getattr(adam, name)
            for path in _paths(state["params"]):    # the params' order
                shape = _get(shapes, path)
                n = int(np.prod(shape))
                full = np.asarray(_get(tree, path),
                                  np.float32)[:n].reshape(shape)
                local = _shard_tree(full, plans[path].spec, mesh, dev)
                set_leaf(out, path, _flat_chunk(
                    local, plans[path].replicated, quant_block_size).clone())
            moments[name] = out
    else:
        moments = {n: _shard_tree(getattr(adam, n), specs, mesh, dev)
                   for n in ("mu", "nu")}
    return {"params": _shard_tree(state["params"], specs, mesh, dev),
            "opt_state": {"count": torch.tensor(
                int(np.asarray(adam.count)), dtype=torch.int32, device=dev),
                **moments},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def gather_to_numpy(tree, config, mesh, rules=None) -> Dict[str, Any]:
    """Every rank's shards of a params-shaped tree (params, gradients,
    moments in the param layout) joined into global f32 numpy arrays;
    every rank of the mesh calls it and gets the whole tree."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.collective import _all_gather
    from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, axis_group,
                                             axis_sizes, mesh_coordinate)
    from ray_tpu_torch.parallel.sharding import local_slices, spec_axes
    world = axis_group(mesh, AXIS_ORDER)
    sizes = axis_sizes(mesh)

    def one(t, spec):
        t = t.detach().float().contiguous()
        shards = _all_gather(t, world).cpu().numpy()
        parts = [int(np.prod([sizes[a] for a in spec_axes(spec[d])]))
                 if d < len(spec) else 1 for d in range(t.dim())]
        glob = tuple(n * k for n, k in zip(t.shape, parts))
        out = np.empty(glob, np.float32)
        for r in range(world.size):
            rank = r if world.pg is None else dist.get_global_rank(
                world.pg, r)
            out[local_slices(glob, spec, sizes,
                             mesh_coordinate(mesh, rank))] = shards[r]
        return out

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        return one(t, sp)
    return walk(tree, _sharding(config, mesh, rules))
