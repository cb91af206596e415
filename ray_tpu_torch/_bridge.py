"""Carry weights between the JAX package's parameter trees and the port's.

Both trees have the same keys and the same stacked ``[n_layers, ...]``
layer leaves, and the bridge keeps them so. It takes numpy arrays (a
test converts JAX arrays with ``np.asarray``), so the port never imports
JAX. For serving, matrices are cast to the compute dtype once: the JAX
model keeps f32 masters and casts at each use (``.astype(dt)``), which
gives the same numbers. For training (``masters=True``) every leaf stays
f32, as the JAX trainer holds it. Norm scales and biases stay f32 either
way. :func:`train_state_from_jax` carries a whole JAX train state (params
and the optax ``clip -> adamw`` moments) into the port's,
:func:`policy_state_from_jax` an RLHF ``PolicyLearner``'s (params and the
optax ``clip -> adam`` moments), :func:`rl_params_from_jax` an rllib
``RLModule``'s params, and :func:`rllib_state_from_jax` an rllib
``Learner``'s (a tree of lists of ``{"w", "b"}`` layers under
``"pi"`` and ``"vf"``, and the ``clip -> adam`` moments).

Over a mesh: :func:`shard_params_from_jax` and
:func:`shard_train_state_from_jax` give this rank its shards of a JAX
tree or train state (the moments in the flat layout of
``shard_weight_update`` when it is on), and :func:`gather_to_numpy`
joins every rank's shards back into global numpy arrays (a collective:
every rank calls it).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

#: leaves read in f32 by the model (norm scales, biases)
F32_LEAVES = frozenset({"ln_scale", "ln_bias", "fc_in_b", "fc_out_b",
                        "attn_norm", "mlp_norm", "scale", "bias", "b"})


def params_from_jax(tree: Dict[str, Any], config, device,
                    masters: bool = False) -> Dict[str, Any]:
    """Numpy parameter tree (JAX layout; a leaf may also be a tensor)
    -> tensors on ``device``: matrices in ``config.dtype`` (f32 with
    ``masters=True``), norm scales and biases in f32."""
    dev = torch.device(device)

    def convert(name: str, value):
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        dt = torch.float32 if masters or name in F32_LEAVES \
            else config.dtype
        if isinstance(value, torch.Tensor):
            return value.to(device=dev, dtype=dt, copy=True)
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)   # bf16 (ml_dtypes) and others
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
    ``nu``) inside a numpy-converted optax state of nested tuples, or a
    dict with those keys (the one-device checkpoint layout, as a
    checkpoint file holds it)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, dict) and \
            {"count", "mu", "nu"} <= set(opt_state):
        return SimpleNamespace(**opt_state)
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


def rl_params_from_jax(params, device):
    """JAX RLModule params given as numpy arrays (a tree of lists of
    ``{"w": [in, out], "b"}`` layers under ``"pi"`` and ``"vf"``) -> the
    port's: the same tree of f32 tensors on ``device``, each a copy."""
    from ray_tpu_torch.rllib.models import tree_to_tensors
    return tree_to_tensors(params, torch.device(device))


def rllib_state_from_jax(state: Dict[str, Any], device) -> Dict[str, Any]:
    """A JAX rllib ``Learner``'s state (``{"params", "opt_state"}``: the
    params tree and an optax ``clip_by_global_norm -> adam`` chain state,
    or ``adam`` alone, leaves as numpy arrays) -> the port's ``Learner``
    state (f32 params and ``{"count", "mu", "nu"}`` on ``device``), which
    its ``load_state`` takes."""
    from ray_tpu_torch.rllib.models import tree_to_tensors
    dev = torch.device(device)
    adam = _find_adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the opt_state")
    return {"params": rl_params_from_jax(state["params"], dev),
            "opt_state": {"count": torch.tensor(int(np.asarray(adam.count)),
                                                dtype=torch.int32,
                                                device=dev),
                          "mu": tree_to_tensors(adam.mu, dev),
                          "nu": tree_to_tensors(adam.nu, dev)}}


def offpolicy_state_from_jax(state: Dict[str, Any], device
                             ) -> Dict[str, Any]:
    """A JAX off-policy learner's ``_state`` (DQN, SAC, DDPG/TD3, CQL;
    leaves as numpy arrays) -> the port's learner state, which its
    ``load_state`` takes: the networks (params, targets, ``log_alpha``) as
    f32 tensors on ``device``, each optimizer (``opt_state`` or
    ``*_opt``: an optax ``clip_by_global_norm -> adam`` chain state, or
    ``adam`` alone) as ``{"count", "mu", "nu"}`` in
    :func:`rllib_state_from_jax`'s layout, and the step count. The JAX
    ``key`` is dropped: the port's learners draw from a
    ``torch.Generator``."""
    from ray_tpu_torch.rllib.models import tree_to_tensors
    dev = torch.device(device)
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k == "key":
            continue
        if k == "steps":
            out[k] = torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                                  device=dev)
        elif k == "opt_state" or k.endswith("_opt"):
            adam = _find_adam_state(v)
            if adam is None:
                raise ValueError(f"no adam state (count, mu, nu) in {k}")
            out[k] = {"count": torch.tensor(int(np.asarray(adam.count)),
                                            dtype=torch.int32, device=dev),
                      "mu": tree_to_tensors(adam.mu, dev),
                      "nu": tree_to_tensors(adam.nu, dev)}
        else:
            out[k] = tree_to_tensors(v, dev)
    return out


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
    # gloo stages a CUDA tensor through host memory both ways: gather the
    # host copy instead, which is where the result goes
    on_host = world.pg is not None and dist.get_backend(world.pg) == "gloo"

    def one(t, spec):
        t = t.detach().float()
        parts = [int(np.prod([sizes[a] for a in spec_axes(spec[d])]))
                 if d < len(spec) else 1 for d in range(t.dim())]
        if all(k == 1 for k in parts):
            # no axis of the mesh splits it: every rank holds it whole
            # (replicas on the data axes), and every rank skips alike
            return t.to("cpu", copy=True).numpy()
        if on_host:
            t = t.cpu()
        shards = _all_gather(t.contiguous(), world).cpu().numpy()
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
