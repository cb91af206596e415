"""Train-step assembly: model + mesh + rules + optimizer -> ``init`` and
``step``, the port of ``ray_tpu/models/training.py``.

With ``mesh=None`` the step runs on one device. Over a mesh from
``parallel.build_mesh`` every rank (one process each) builds the same
bundle and runs the same steps: its state holds its shards (as
``parallel.shard_params`` places them; ``state_shardings`` gives each
leaf's spec), it takes the global batch and keeps its rows (split over
the rules' batch axes, ``batch_spec``), and the model's collectives
(``models.transformer.lm_loss_sharded``) gather the fsdp shards and sum
the tensor-parallel partials; over ``sp`` the ranks hold sequence
chunks and attend through the ring, over ``ep`` an MoE config's experts
are split. After the backward the step sums each gradient over the data
axes its leaf is replicated over (the batch axes and ``sp``, never
``ep``, which splits the model and not the tokens), the global norm of
the gradients clips them, and ``ClipAdamW`` updates the local shards.
``shard_weight_update`` (arXiv:2004.13336) reduce-scatters those
gradients flat instead and updates a 1/N flat optimizer shard,
then all-gathers the params; ``grad_transport="int8"`` carries every
gradient reduction over the data axes (the fsdp reduce-scatters too) as
real int8 through ``collective.quantized_psum``.

The optimizer is the JAX package's ``clip_by_global_norm -> adamw``
chain: the clip is a foreach scale with no host sync, the update one
pass of PyTorch's fused AdamW over every leaf (in JAX it is XLA, not a
Pallas kernel). The step updates the state in place and returns it (the
JAX step donates its input state; a caller that keeps the old state
clones it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (TransformerConfig, init_leaves,
                                              init_params, lm_loss,
                                              lm_loss_sharded, model_layout,
                                              param_shapes, remat_policy_fn,
                                              resolve_device, set_leaf)
from ray_tpu_torch.parallel.collective import (GradTransport, _all_gather,
                                               _all_reduce, _reduce_scatter,
                                               quantized_psum,
                                               rank_generator)
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, axis_group,
                                         axis_sizes, mesh_coordinate)
from ray_tpu_torch.parallel.quantization import DEFAULT_BLOCK_SIZE
from ray_tpu_torch.parallel.sharding import (FSDP_RULES, flat_pad_len,
                                             flatten_leaf, local_shape,
                                             local_slices, shard_leaf,
                                             spec_axes)

GRAD_TRANSPORTS = ("fp32", "int8")


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``), in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class ClipAdamW:
    """optax's ``chain(clip_by_global_norm(clip_norm), adamw(lr, b1, b2,
    eps, weight_decay))``: gradients whose global norm is at least
    ``clip_norm`` are scaled by ``clip_norm / norm`` (no epsilon in the
    divisor, unlike ``torch.nn.utils.clip_grad_norm_``); then AdamW with
    bias correction and decoupled weight decay, ``p -= lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)``, which ``torch._fused_adamw_``
    computes in one pass (as ``p * (1 - lr * wd) - lr / bc1 * m /
    (sqrt(v) / sqrt(bc2) + eps)``). State: ``{"count", "mu", "nu"}``,
    moments f32 and shaped like the params."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params: Dict) -> Dict:
        first = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt_state: Dict,
               params: List[torch.Tensor], grad_norm: torch.Tensor,
               paths: Optional[List[Tuple[str, ...]]] = None) -> None:
        """Apply one step in place to ``params`` and ``opt_state``, given
        the gradients' global norm; ``grads`` may be scaled in place by
        the clip. The moments are taken at ``paths`` (the params' own
        leaf paths, so that a state whose trees list their keys in
        another order still pairs each moment with its param), or in
        ``tree_leaves`` order."""
        if self.clip_norm is not None:
            torch._foreach_mul_(
                grads, torch.clamp(self.clip_norm / grad_norm, max=1.0))
        if paths is None:
            mu, nu = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        else:
            mu = [_get(opt_state["mu"], p) for p in paths]
            nu = [_get(opt_state["nu"], p) for p in paths]
        if [m.shape for m in mu] != [p.shape for p in params]:
            raise ValueError("the optimizer moments do not match the params")
        opt_state["count"] += 1
        step = opt_state["count"].float()     # read, not advanced, by the op
        torch._fused_adamw_(params, grads, mu, nu, [],
                            [step] * len(params), lr=self.learning_rate,
                            beta1=self.b1, beta2=self.b2,
                            weight_decay=self.weight_decay, eps=self.eps,
                            amsgrad=False, maximize=False)


def default_optimizer(learning_rate: float, weight_decay: float = 0.0,
                      clip_norm: Optional[float] = 1.0) -> ClipAdamW:
    """The standard training optimizer: global-norm clip (when
    ``clip_norm`` is set) chained onto AdamW(b1=0.9, b2=0.95, eps=1e-8)."""
    return ClipAdamW(learning_rate, weight_decay=weight_decay,
                     clip_norm=clip_norm)


@dataclasses.dataclass
class TrainStepBundle:
    """What a caller (each rank, over a mesh) needs to run training
    steps."""
    config: TransformerConfig
    mesh: Any
    rules: Any
    init_fn: Callable[[int], Dict]                      # seed -> state
    step_fn: Callable[[Dict, Dict], Tuple[Dict, Dict]]  # (state, batch)
    #: spec of every state leaf (None without a mesh); in the flat layout
    #: of ``shard_weight_update`` a moment is a 1-D chunk of this rank's
    #: flattened shard, split over the axes its spec entry names
    state_shardings: Optional[Dict] = None
    #: spec of the batch's (rows, tokens); rows split over the data axes
    batch_spec: Any = None
    grad_transport: str = "fp32"
    shard_weight_update: bool = False
    #: accepted for the JAX signature; unused: the step records no
    #: telemetry yet (the metrics plane is ported, the reporting is not)
    telemetry_interval_s: float = 0.5
    device: Optional[torch.device] = None

    def init(self, seed: int = 0) -> Dict:
        return self.init_fn(seed)

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch (all of it without a
        mesh), on the device, with a ``loss_mask`` of ones if absent."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.mesh is not None:
                t = t[local_slices(t.shape, self.batch_spec,
                                   axis_sizes(self.mesh),
                                   mesh_coordinate(self.mesh))]
            out[k] = t.to(self.device)
        if "loss_mask" not in out:
            out["loss_mask"] = torch.ones(out["input_ids"].shape,
                                          dtype=torch.float32,
                                          device=self.device)
        return out

    def step(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """One step on the global ``batch`` (``input_ids`` (b, s), optional
        ``loss_mask``; tensors or numpy arrays): every rank passes the same
        batch and keeps its rows."""
        return self.step_fn(state, self.local_batch(batch))


@dataclasses.dataclass
class LeafPlan:
    """One param leaf's place in the sharded step: its spec, the group
    of the data axes it is replicated over (its gradient is summed
    there), the flat chunk it updates under ``shard_weight_update``, and
    whether this rank counts it in the global norm (the first replica
    over every axis that neither its spec nor its flat chunk splits)."""
    path: Tuple[str, ...]
    spec: Tuple
    replicated: Any        # AxisGroup
    counts: bool


def leaf_plans(config: TransformerConfig, mesh, rules,
               shard_weight_update: bool) -> Dict[Tuple[str, ...], LeafPlan]:
    """The :class:`LeafPlan` of every param leaf, by path."""
    lay = model_layout(config, mesh, rules)
    sizes, coord = axis_sizes(mesh), mesh_coordinate(mesh)
    data = set(lay.data.axes)
    plans = {}
    for path in _paths(lay.specs):
        spec = _get(lay.specs, path)
        owned = {a for e in spec for a in spec_axes(e)}
        rep = tuple(a for a in AXIS_ORDER if a in data - owned)
        if shard_weight_update:
            owned |= set(rep)
        counts = all(coord[a] == 0 for a in AXIS_ORDER
                     if sizes[a] > 1 and a not in owned)
        plans[path] = LeafPlan(path, spec, axis_group(mesh, rep), counts)
    return plans


def int8_wire_lengths(config: TransformerConfig, mesh, rules=None,
                      shard_weight_update: bool = False,
                      quant_block_size: int = DEFAULT_BLOCK_SIZE
                      ) -> List[int]:
    """The padded lengths of the int8 payloads one step of
    ``grad_transport="int8"`` quantizes on this rank, one per reduction
    that leaves the rank: each fsdp reduce-scatter of a gathered leaf's
    gradient (in the model's backward) and each sum over the data axes a
    leaf is replicated over. ``quantization.tree_wire_bytes`` of them is
    the bytes the step's scatter legs send."""
    rules = FSDP_RULES if rules is None else rules
    lay = model_layout(config, mesh, rules)
    sizes = axis_sizes(mesh)
    shapes = param_shapes(config)
    out = []
    for plan in leaf_plans(config, mesh, rules,
                           shard_weight_update).values():
        shape = _get(shapes, plan.path)
        local = local_shape(shape, plan.spec, sizes)
        store = [e for e in plan.spec if spec_axes(e)
                 and set(spec_axes(e)) <= set(lay.storage)]
        if store:
            g = axis_group(mesh, store[0])
            if g.size > 1:
                full = int(torch.Size(local).numel()) * g.size
                out.append(flat_pad_len(full, g.size, quant_block_size))
        n = plan.replicated.size
        if n > 1:
            out.append(flat_pad_len(int(torch.Size(local).numel()), n,
                                    quant_block_size))
    return out


def sharded_global_norm(grads: List[torch.Tensor], plans: List[LeafPlan],
                        world) -> torch.Tensor:
    """optax's ``global_norm`` of the global gradient from this rank's
    shards: the squares of the leaves it counts (each replica once),
    summed over every rank."""
    mine = [g for g, p in zip(grads, plans) if p.counts]
    dev = grads[0].device
    total = torch.zeros(1, dtype=torch.float32, device=dev)
    if mine:
        norms = torch._foreach_norm([g.float() for g in mine])
        total += torch.stack(norms).square().sum()
    return _all_reduce(total, world)[0].sqrt()


def make_train_step(config: TransformerConfig, mesh=None, rules=None,
                    optimizer=None,
                    learning_rate: float = 1e-5,
                    weight_decay: float = 0.0,
                    remat_policy: Optional[str] = None,
                    ce_chunk_size: Optional[int] = None,
                    grad_transport: str = "fp32",
                    shard_weight_update: bool = False,
                    quant_block_size: int = DEFAULT_BLOCK_SIZE,
                    quant_stochastic: bool = False,
                    telemetry_interval_s: float = 0.5,
                    device=None) -> TrainStepBundle:
    """Build ``init`` and ``step`` (CUDA unless ``device`` names another;
    raises without a CUDA device when none is named), on one device or,
    over ``mesh`` with ``rules`` (default ``FSDP_RULES``), on every rank.

    ``remat_policy`` / ``ce_chunk_size`` override the config's
    rematerialization policy (``"none"``, ``"full"``, ``"dots"``) and
    fused-CE chunking for this step. The state is ``{"params" (f32
    masters; this rank's shards), "opt_state", "step"}``; ``step``
    updates it in place and returns it with ``{"loss", "n_tokens",
    "grad_norm"}`` (the global norm of the unclipped gradients), and for
    an MoE config ``"moe_aux"`` (the Switch aux term the loss includes
    with weight ``moe_aux_weight``) and ``"moe_dropped"`` (each layer's
    share of the batch's tokens dropped for capacity).

    Communication knobs (need a mesh; its data axes, the batch axes and
    ``sp``, carry them):

    - ``grad_transport``: ``"fp32"`` (exact) or ``"int8"``: every
      gradient reduction over the data axes moves real int8 values and
      f32 block scales through ``collective.quantized_psum`` (two legs,
      ``quant_block_size`` elements a block, stochastic rounding with
      ``quant_stochastic``). The JAX step instead adds one leg's error
      with ``fake_quant``, because XLA compiles its reduction (ROADMAP
      Queue 3 lists this divergence).
    - ``shard_weight_update``: each gradient, flattened and padded to
      ``flat_pad_len``, is reduce-scattered over the data axes its leaf
      is replicated over; ``ClipAdamW`` updates that 1/N flat chunk of
      the optimizer state and the masters, and the params all-gather
      back. ``state["params"]`` keeps its layout.

    ``pp`` > 1 (ROADMAP Queue 1 item 9) and a JAX ``Mesh`` (TypeError)
    raise. ``telemetry_interval_s`` is accepted and unused.
    """
    if grad_transport not in GRAD_TRANSPORTS:
        raise ValueError(f"grad_transport must be one of "
                         f"{GRAD_TRANSPORTS}, got {grad_transport!r}")
    if mesh is None and (grad_transport != "fp32" or shard_weight_update):
        raise ValueError(
            "grad_transport='int8' and shard_weight_update act on the "
            "reductions over a mesh's data axes: pass a mesh")
    if remat_policy is not None:
        config = dataclasses.replace(config, remat=None,
                                     remat_policy=remat_policy)
    if ce_chunk_size is not None:
        config = dataclasses.replace(config, ce_chunk_size=ce_chunk_size)
    if config.resolved_remat_policy != "none":
        remat_policy_fn(config.resolved_remat_policy)   # raises if unknown
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = default_optimizer(learning_rate, weight_decay)
    if mesh is not None:
        return _sharded_train_step(
            config, mesh, FSDP_RULES if rules is None else rules, optimizer,
            grad_transport, shard_weight_update, quant_block_size,
            quant_stochastic, telemetry_interval_s, dev)

    def init_fn(seed: int) -> Dict:
        params = init_params(config, seed, dev)
        return {"params": params, "opt_state": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = lm_loss(config, params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            grad_norm = global_norm(grads)
            optimizer.update(grads, state["opt_state"], leaves, grad_norm,
                             _paths(params))
            state["step"] += 1
        return state, _metrics(loss, aux, grad_norm)

    return TrainStepBundle(config=config, mesh=None, rules=rules,
                           init_fn=init_fn, step_fn=step_fn,
                           grad_transport=grad_transport,
                           shard_weight_update=shard_weight_update,
                           telemetry_interval_s=telemetry_interval_s,
                           device=dev)


def _metrics(loss, aux: Dict, grad_norm) -> Dict:
    out = {"loss": loss.detach(), "n_tokens": aux["n_tokens"],
           "grad_norm": grad_norm}
    for k in ("moe_aux", "moe_dropped"):
        if k in aux:
            out[k] = aux[k]
    return out


def _flat_chunk(x: torch.Tensor, group, block: int) -> torch.Tensor:
    """This rank's chunk of ``x`` flattened and padded over ``group``."""
    flat = flatten_leaf(x, group.size, block)
    n = flat.numel() // group.size
    return flat[group.rank * n:(group.rank + 1) * n]


def _sharded_train_step(config, mesh, rules, optimizer, grad_transport,
                        shard_weight_update, block, stochastic,
                        telemetry_interval_s, dev) -> TrainStepBundle:
    transport = GradTransport(grad_transport, block, stochastic,
                              seed=0x5EED)
    lay = model_layout(config, mesh, rules, transport)
    plans = leaf_plans(config, mesh, rules, shard_weight_update)
    world = axis_group(mesh, AXIS_ORDER)
    me = torch.distributed.get_rank()
    flat_specs = {}
    for p in plans.values():
        set_leaf(flat_specs, p.path, (p.replicated.axes,)
                 if shard_weight_update else p.spec)
    state_sh = {"params": lay.specs,
                "opt_state": {"count": (), "mu": flat_specs,
                              "nu": flat_specs},
                "step": ()}

    def init_fn(seed: int) -> Dict:
        # each leaf drawn whole from the one-device init's generator, this
        # rank's slice kept and the rest freed before the next leaf: the
        # sharded init is a slice of init_params(config, seed)
        params: Dict = {"embed": None}
        for path, full in init_leaves(config, seed, dev):
            set_leaf(params, path, shard_leaf(full, _get(lay.specs, path),
                                              mesh))
            del full
        if shard_weight_update:
            slots: Dict = {"embed": None}
            for path in _paths(params):
                set_leaf(slots, path, _flat_chunk(
                    _get(params, path), plans[path].replicated, block))
        else:
            slots = params
        return {"params": params, "opt_state": optimizer.init(slots),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def reduce(g: torch.Tensor, plan: LeafPlan, i: int,
               step: int) -> torch.Tensor:
        """The gradient summed over the data axes the leaf is replicated
        over (its flat chunk of the sum under shard_weight_update)."""
        group = plan.replicated
        if shard_weight_update:
            g = flatten_leaf(g, group.size, block)
        if group.size == 1:
            return g
        if grad_transport == "fp32":
            return _reduce_scatter(g, group) if shard_weight_update \
                else _all_reduce(g.contiguous(), group)
        gen = rank_generator(g.device, step, i, me) if stochastic else None
        full = quantized_psum(g, group, block_size=block,
                              stochastic_rounding=stochastic, generator=gen)
        if shard_weight_update:
            return full.view(group.size, -1)[group.rank].clone()
        return full

    def step_fn(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        # the state's own leaf order (a tree from the JAX package sorts its
        # keys); its moments share it
        paths = _paths(params)
        order = [plans[path] for path in paths]
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = lm_loss_sharded(config, params, batch, lay)
        grads = list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            step = int(state["step"]) if stochastic else 0
            grads = [reduce(g, p, i, step)
                     for i, (g, p) in enumerate(zip(grads, order))]
            grad_norm = sharded_global_norm(grads, order, world)
            if shard_weight_update:
                chunks = [_flat_chunk(p, pl.replicated, block).clone()
                          for p, pl in zip(leaves, order)]
                optimizer.update(grads, state["opt_state"], chunks,
                                 grad_norm, paths)
                for p, pl, c in zip(leaves, order, chunks):
                    full = _all_gather(c, pl.replicated).reshape(-1)
                    p.copy_(full[:p.numel()].view(p.shape))
            else:
                optimizer.update(grads, state["opt_state"], leaves,
                                 grad_norm, paths)
            state["step"] += 1
        return state, _metrics(loss, aux, grad_norm)

    return TrainStepBundle(
        config=config, mesh=mesh, rules=rules, init_fn=init_fn,
        step_fn=step_fn, state_shardings=state_sh,
        batch_spec=rules.spec_for(("batch", "sequence")),
        grad_transport=grad_transport,
        shard_weight_update=shard_weight_update,
        telemetry_interval_s=telemetry_interval_s, device=dev)


def make_eval_step(config: TransformerConfig, mesh=None, rules=None,
                   state_shardings=None, device=None):
    """Forward-only loss: ``eval_step(params, batch) -> {"loss",
    "n_tokens"}`` (no remat, no graph kept). Over ``mesh`` ``params`` are
    this rank's shards (the train step's layout) and ``batch`` the
    global batch, of which each rank keeps its rows."""
    del state_shardings
    dev = resolve_device(device)
    config = dataclasses.replace(config, remat=None, remat_policy="none")
    rules = FSDP_RULES if rules is None and mesh is not None else rules
    lay = model_layout(config, mesh, rules) if mesh is not None else None
    rows = TrainStepBundle(config, mesh, rules, None, None,
                           batch_spec=rules.spec_for(("batch", "sequence"))
                           if mesh is not None else None, device=dev)

    @torch.no_grad()
    def eval_step(params: Dict, batch: Dict) -> Dict:
        batch = rows.local_batch(batch)
        if lay is not None:
            loss, aux = lm_loss_sharded(config, params, batch, lay)
        else:
            loss, aux = lm_loss(config, params, batch)
        return {"loss": loss, "n_tokens": aux["n_tokens"]}
    return eval_step
