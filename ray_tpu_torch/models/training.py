"""Train-step assembly on one device: model + optimizer -> ``init`` and
``step``, as ``ray_tpu/models/training.py`` builds them over a mesh.

One device only: ``mesh`` is ``None`` (or a one-device mesh). The JAX
package's sharded paths (a mesh of more than one device, int8 gradient
transport, the cross-replica sharded weight update) need the port's
``parallel/`` layer and raise ``NotImplementedError`` until it exists.

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

from ray_tpu_torch.models.transformer import (TransformerConfig, init_params,
                                              lm_loss, remat_policy_fn,
                                              resolve_device)

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
               params: List[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """Apply one step in place to ``params`` (leaves in the order of
        ``tree_leaves``) and ``opt_state``, given the gradients' global
        norm; ``grads`` may be scaled in place by the clip."""
        if self.clip_norm is not None:
            torch._foreach_mul_(
                grads, torch.clamp(self.clip_norm / grad_norm, max=1.0))
        opt_state["count"] += 1
        step = opt_state["count"].float()     # read, not advanced, by the op
        torch._fused_adamw_(params, grads, tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"]), [],
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


def _mesh_devices(mesh) -> int:
    size = getattr(mesh, "size", None)
    if callable(size):
        size = size()
    if size is None:
        raise TypeError(f"mesh {mesh!r} has no size")
    return int(size)


@dataclasses.dataclass
class TrainStepBundle:
    """What a caller needs to run training steps on one device."""
    config: TransformerConfig
    mesh: Any
    rules: Any
    init_fn: Callable[[int], Dict]                      # seed -> state
    step_fn: Callable[[Dict, Dict], Tuple[Dict, Dict]]  # (state, batch)
    grad_transport: str = "fp32"
    shard_weight_update: bool = False
    #: accepted for the JAX signature; unused: the step records no
    #: telemetry yet (the metrics plane is ported, the reporting is not)
    telemetry_interval_s: float = 0.5
    device: Optional[torch.device] = None

    def init(self, seed: int = 0) -> Dict:
        return self.init_fn(seed)

    def step(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """One step on ``batch`` (``input_ids`` (b, s), optional
        ``loss_mask``; tensors or numpy arrays, moved to the device)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        if "loss_mask" not in batch:
            batch["loss_mask"] = torch.ones(batch["input_ids"].shape,
                                            dtype=torch.float32,
                                            device=self.device)
        return self.step_fn(state, batch)


def make_train_step(config: TransformerConfig, mesh=None, rules=None,
                    optimizer=None,
                    learning_rate: float = 1e-5,
                    weight_decay: float = 0.0,
                    remat_policy: Optional[str] = None,
                    ce_chunk_size: Optional[int] = None,
                    grad_transport: str = "fp32",
                    shard_weight_update: bool = False,
                    telemetry_interval_s: float = 0.5,
                    device=None) -> TrainStepBundle:
    """Build ``init`` and ``step`` for one device (CUDA unless ``device``
    names another; raises without a CUDA device when none is named).

    ``remat_policy`` / ``ce_chunk_size`` override the config's
    rematerialization policy (``"none"``, ``"full"``, ``"dots"``) and
    fused-CE chunking for this step. The state is ``{"params" (f32
    masters), "opt_state", "step"}``; ``step`` updates it in place and
    returns it with ``{"loss", "n_tokens", "grad_norm"}`` (the global
    norm of the unclipped gradients).

    Not ported yet, each raising ``NotImplementedError``: a mesh of more
    than one device, ``grad_transport="int8"``, ``shard_weight_update``,
    MoE configs. ``telemetry_interval_s`` is accepted and unused: the
    step does not report through the runtime's metrics plane yet
    (``core/metrics_plane.py``, copied with the core runtime), as the JAX
    trainer does.
    """
    if grad_transport not in GRAD_TRANSPORTS:
        raise ValueError(f"grad_transport must be one of "
                         f"{GRAD_TRANSPORTS}, got {grad_transport!r}")
    if grad_transport == "int8":
        raise NotImplementedError(
            "int8 gradient transport needs the port's parallel/ layer")
    if shard_weight_update:
        raise NotImplementedError(
            "the sharded weight update needs the port's parallel/ layer")
    if mesh is not None and _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "training over a mesh of more than one device needs the port's "
            "parallel/ layer; pass mesh=None")
    if config.n_experts:
        raise NotImplementedError("the port does not train MoE configs yet")
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
            optimizer.update(grads, state["opt_state"], leaves, grad_norm)
            state["step"] += 1
        metrics = {"loss": loss.detach(), "n_tokens": aux["n_tokens"],
                   "grad_norm": grad_norm}
        return state, metrics

    return TrainStepBundle(config=config, mesh=mesh, rules=rules,
                           init_fn=init_fn, step_fn=step_fn,
                           grad_transport=grad_transport,
                           shard_weight_update=shard_weight_update,
                           telemetry_interval_s=telemetry_interval_s,
                           device=dev)


def make_eval_step(config: TransformerConfig, mesh=None, rules=None,
                   state_shardings=None, device=None):
    """Forward-only loss on one device: ``eval_step(params, batch) ->
    {"loss", "n_tokens"}`` (no remat, no graph kept)."""
    del rules, state_shardings
    if mesh is not None and _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "evaluation over a mesh of more than one device needs the "
            "port's parallel/ layer; pass mesh=None")
    dev = resolve_device(device)
    config = dataclasses.replace(config, remat=None, remat_policy="none")

    @torch.no_grad()
    def eval_step(params: Dict, batch: Dict) -> Dict:
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, aux = lm_loss(config, params, batch)
        return {"loss": loss, "n_tokens": aux["n_tokens"]}
    return eval_step
