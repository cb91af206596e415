"""ParallelPlan: one config, every parallelism. The port of
``ray_tpu/parallel/plan.py``.

A declarative grid

    ParallelPlan(pp=S, virtual=v, dp=D, fsdp=F,
                 grad_transport="fp32"/"int8",
                 shard_weight_update=..., slice_strategy=...)

**lowers** to the runtime shape the grid implies, behind one
``TrainProgram`` interface (``step`` / ``save_checkpoint`` /
``load_checkpoint`` / ``shutdown``):

- ``pp == 1`` -> **SPMD**: ``models.training.make_train_step``. At
  ``dp * fsdp == 1`` the one-device step in the caller's process; above
  it the sharded step over a ``MeshSpec(dp, fsdp)`` mesh on rank actors
  of the runtime (``parallel.dryrun.start_ranks``), one process a rank,
  with int8 transport and the flat 1/N update as the step has them;
- ``pp >= 2, dp == fsdp == 1`` -> **MPMD**: the interleaved pipeline
  (``parallel.mpmd_pipeline.MPMDPipeline(train=True)``: stage actors,
  streamed activations, a per-stage optimizer step);
- ``pp >= 2, dp * fsdp >= 2`` -> **mpmd3d**, both nested (the
  Megatron-LM 3D recipe, arXiv:1909.08053, with EQuARX int8 collectives,
  arXiv:2506.17615): the same pipeline with a dp x fsdp mesh inside
  every stage, ``dp * fsdp`` rank actors a stage in a collective group
  of their own, the stage's gradient reduction carrying real int8 bytes
  when ``grad_transport="int8"`` and the flat 1/N update under
  ``shard_weight_update``.

``grad_transport``, ``shard_weight_update`` and ``quant_*`` are passed
to every lowering, as in the JAX package (a pipeline without a stage
mesh has no stage reduction for them to change).

``slice_strategy`` ("SLICE_SPREAD"/"SLICE_PACK") reserves a gang
placement group, one bundle a pipeline stage actor (``pp * dp * fsdp``
of them) on the hosts of one slice (``util/placement_group.py``), and
places each actor on its bundle; when no slice has the capacity (or no
runtime is up) within ``placement_timeout_s`` the plan falls back to the
local devices, so the same script runs anywhere.

Checkpoints are **lowering-independent**: every program saves and loads
the one-device train state of ``make_train_step``, ``{"params",
"opt_state": {"count", "mu", "nu"}, "step"}`` with numpy leaves, so a
state saved under ``(pp=2, v=2, dp=2)`` reloads under ``pp=1`` and under
``(pp=2, v=1)``, and back.

Entry points run on the card: ``device=None`` is CUDA and raises without
one; pass ``device="cpu"`` on the CPU. The rank and stage actors take
the card (a share of it where there are fewer cards than actors); they
run on the CPU only for ``device="cpu"`` or in workers of the CPU
platform (``RAY_TPU_TORCH_PLATFORM=cpu``), and ``build`` raises where
the runtime counts no GPU otherwise.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
import types
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.training import GRAD_TRANSPORTS

logger = logging.getLogger(__name__)

__all__ = ["ParallelPlan", "PlanStepResult", "TrainProgram",
           "SLICE_STRATEGIES"]

SLICE_STRATEGIES = ("SLICE_PACK", "SLICE_SPREAD")


@dataclasses.dataclass
class PlanStepResult:
    """Uniform per-step result across lowerings."""
    loss: float
    grad_norm: Optional[float]
    step: Optional[int]
    wall_s: float
    n_tokens: Optional[float] = None
    #: measured pipeline bubble (MPMD lowerings; None for SPMD)
    bubble_fraction: Optional[float] = None
    #: the native result object (PipelineStepResult / metrics dict)
    detail: Any = None


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Declarative parallelism grid; ``build()`` lowers it.

    ``pp`` pipeline stages × ``virtual`` interleaved chunks per stage,
    each stage running a ``dp`` × ``fsdp`` data-parallel program on its
    own devices. ``n_microbatches`` is the 1F1B microbatch count
    (ignored by the SPMD lowering). ``grad_transport`` /
    ``shard_weight_update`` / ``quant_*`` pick the gradient byte path,
    honoured by every lowering. ``slice_strategy`` asks for a gang
    placement group over one slice's hosts."""
    pp: int = 1
    virtual: int = 1
    dp: int = 1
    fsdp: int = 1
    n_microbatches: int = 4
    grad_transport: str = "fp32"
    shard_weight_update: bool = False
    slice_strategy: Optional[str] = None
    quant_block_size: Optional[int] = None
    quant_stochastic: bool = False

    def __post_init__(self):
        if min(self.pp, self.virtual, self.dp, self.fsdp,
               self.n_microbatches) < 1:
            raise ValueError(
                f"every ParallelPlan axis must be >= 1, got {self}")
        if self.virtual > 1 and self.pp < 2:
            raise ValueError(
                f"virtual={self.virtual} needs pp >= 2 (interleaved "
                f"chunks are a pipeline concept)")
        if self.grad_transport not in GRAD_TRANSPORTS:
            raise ValueError(
                f"grad_transport must be one of {GRAD_TRANSPORTS}, "
                f"got {self.grad_transport!r}")
        if self.slice_strategy is not None and \
                self.slice_strategy not in SLICE_STRATEGIES:
            raise ValueError(
                f"slice_strategy must be one of {SLICE_STRATEGIES} "
                f"or None, got {self.slice_strategy!r}")

    # ------------------------------------------------------- queries
    @property
    def lowering(self) -> str:
        """"spmd" (pp=1), "mpmd" (pp>=2, dp=fsdp=1) or "mpmd3d"."""
        if self.pp == 1:
            return "spmd"
        return "mpmd" if self.dp * self.fsdp == 1 else "mpmd3d"

    @property
    def stage_world(self) -> int:
        """Devices per pipeline stage (dp × fsdp)."""
        return self.dp * self.fsdp

    @property
    def world_size(self) -> int:
        """Total devices the plan wants (pp × dp × fsdp)."""
        return self.pp * self.stage_world

    def describe(self) -> str:
        bits = []
        if self.pp > 1:
            bits.append(f"pp={self.pp}" + (f"(v={self.virtual})"
                                           if self.virtual > 1 else "")
                        + f" M={self.n_microbatches}")
        if self.dp > 1:
            bits.append(f"dp={self.dp}")
        if self.fsdp > 1:
            bits.append(f"fsdp={self.fsdp}")
        if not bits:
            bits.append("single-device")
        bits.append(self.grad_transport)
        if self.shard_weight_update:
            bits.append("sharded-update")
        if self.slice_strategy:
            bits.append(self.slice_strategy)
        return f"{self.lowering}[" + " ".join(bits) + "]"

    def validate_batch(self, batch_rows: int) -> None:
        """Fail fast on a batch the grid cannot split evenly."""
        per_mb = batch_rows
        if self.pp > 1:
            if batch_rows % self.n_microbatches:
                raise ValueError(
                    f"batch {batch_rows} not divisible by "
                    f"{self.n_microbatches} microbatches")
            per_mb = batch_rows // self.n_microbatches
        if per_mb % self.stage_world:
            raise ValueError(
                f"{'microbatch' if self.pp > 1 else 'batch'} rows "
                f"({per_mb}) not divisible by dp*fsdp = "
                f"{self.stage_world}")

    def validate_config(self, config) -> None:
        if self.pp > 1 and self.pp * self.virtual > config.n_layers:
            raise ValueError(
                f"pp*virtual = {self.pp * self.virtual} chunks need at "
                f"least that many layers, model has {config.n_layers}")

    # -------------------------------------------------------- lowering
    def build(self, config, *,
              learning_rate: float = 1e-5,
              weight_decay: float = 0.0,
              clip_norm: Optional[float] = 1.0,
              seed: int = 0,
              device=None,
              step_timeout_s: float = 300.0,
              placement_timeout_s: float = 60.0,
              stage_mesh: Optional[bool] = None,
              telemetry_interval_s: float = 0.5) -> "TrainProgram":
        """Lower the plan against ``config`` into a live
        :class:`TrainProgram`. The one-device SPMD step runs in this
        process on ``device``; the sharded SPMD step and the MPMD
        pipelines (with or without stage meshes) start actors (they need
        a running runtime) where
        :func:`~ray_tpu_torch.parallel.mpmd_pipeline.actor_device` puts
        them for ``device``, the pipeline's gang-placed on a slice
        placement group when ``slice_strategy`` is set and capacity
        exists. ``stage_mesh=True`` runs a pipeline's stage-mesh path at
        ``dp * fsdp == 1`` too."""
        self.validate_config(config)
        if self.pp == 1:
            return _SPMDProgram(
                self, config, learning_rate=learning_rate,
                weight_decay=weight_decay, clip_norm=clip_norm,
                seed=seed, device=device,
                telemetry_interval_s=telemetry_interval_s)
        return _PipelineProgram(
            self, config, learning_rate=learning_rate,
            weight_decay=weight_decay, clip_norm=clip_norm, seed=seed,
            device=device, step_timeout_s=step_timeout_s,
            placement_timeout_s=placement_timeout_s,
            stage_mesh=stage_mesh)


# ------------------------------------------------------------ programs
class TrainProgram:
    """What every lowering exposes: step / checkpoint / shutdown."""

    plan: ParallelPlan
    config: Any

    @property
    def lowering(self) -> str:
        return self.plan.lowering

    def step(self, batch: Dict[str, Any]) -> PlanStepResult:
        raise NotImplementedError

    def save_checkpoint(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


def _canonical(state: Dict[str, Any]) -> Dict[str, Any]:
    """A one-device train state (tensors) as the canonical numpy one."""
    from ray_tpu_torch._bridge import to_numpy
    opt = state["opt_state"]
    return {"params": to_numpy(state["params"]),
            "opt_state": {"count": int(opt["count"]),
                          "mu": to_numpy(opt["mu"]),
                          "nu": to_numpy(opt["nu"])},
            "step": int(state["step"])}


def _loadable(state: Dict[str, Any], flat: bool = False) -> Dict[str, Any]:
    """A canonical state in the form ``_bridge``'s loaders read (its
    moments as attributes, as in an optax state; flattened for the flat
    layout of the sharded update, as the JAX package keeps them)."""
    opt = state["opt_state"]
    mom = {n: opt[n] for n in ("mu", "nu")}
    if flat:
        from ray_tpu_torch.models.training import tree_map
        mom = {n: tree_map(lambda a: np.asarray(a).reshape(-1), t)
               for n, t in mom.items()}
    return {"params": state["params"],
            "opt_state": types.SimpleNamespace(count=opt["count"], **mom),
            "step": state.get("step", 0)}


class _SPMDProgram(TrainProgram):
    """pp=1: ``make_train_step`` on one device in this process, or over a
    dp×fsdp mesh on rank actors; state held in the program so the
    interface matches the pipeline lowering."""

    def __init__(self, plan: ParallelPlan, config, *, learning_rate,
                 weight_decay, clip_norm, seed, device,
                 telemetry_interval_s):
        from ray_tpu_torch.parallel.quantization import DEFAULT_BLOCK_SIZE

        self.plan = plan
        self.config = config
        self.actors = []
        opt = dict(learning_rate=learning_rate, weight_decay=weight_decay,
                   clip_norm=clip_norm)
        knobs = dict(grad_transport=plan.grad_transport,
                     shard_weight_update=plan.shard_weight_update,
                     quant_block_size=plan.quant_block_size
                     or DEFAULT_BLOCK_SIZE,
                     quant_stochastic=plan.quant_stochastic,
                     telemetry_interval_s=telemetry_interval_s)
        if plan.stage_world == 1:
            from ray_tpu_torch.models.training import (default_optimizer,
                                                       make_train_step)
            self.bundle = make_train_step(
                config, optimizer=default_optimizer(**opt), device=device,
                **knobs)
            self.state = self.bundle.init(seed=seed)
            return
        from ray_tpu_torch.parallel.dryrun import run_on_ranks, start_ranks
        from ray_tpu_torch.parallel.mpmd_pipeline import actor_device
        n = plan.stage_world
        where, gpus = actor_device(device, n)
        backend = "nccl" if where == "cuda" and gpus == 1.0 else "gloo"
        self.actors = start_ranks(n, backend, group_name="plan",
                                  num_gpus=gpus)
        try:
            run_on_ranks(self.actors, _rank_build, config,
                         {"dp": plan.dp, "fsdp": plan.fsdp}, opt, knobs,
                         seed, where)
        except BaseException:
            self.shutdown()
            raise

    def step(self, batch: Dict[str, Any]) -> PlanStepResult:
        self.plan.validate_batch(
            int(np.asarray(batch["input_ids"]).shape[0]))
        t0 = time.perf_counter()
        if self.actors:
            from ray_tpu_torch.parallel.dryrun import run_on_ranks
            m = run_on_ranks(self.actors, _rank_step, batch)[0]
            step = m["step"]
        else:
            self.state, m = self.bundle.step(self.state, batch)
            m = {k: (v.item() if isinstance(v, torch.Tensor)
                     and v.numel() == 1 else v) for k, v in m.items()}
            step = int(self.state["step"])
        return PlanStepResult(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            step=step, wall_s=time.perf_counter() - t0,
            n_tokens=float(m["n_tokens"]), detail=m)

    # ------------------------------------------------------ checkpoint
    def save_checkpoint(self) -> Dict[str, Any]:
        if self.actors:
            import ray_tpu_torch
            from ray_tpu_torch.models.training import tree_map
            from ray_tpu_torch.parallel.dryrun import RANK_TIMEOUT_S
            # every rank gathers (a collective) and rank 0 returns the
            # state; its arrays view the store's memory, so they are
            # copied while the refs live
            refs = [a.__ray_call__.remote(_rank_save) for a in self.actors]
            out = ray_tpu_torch.get(refs, timeout=RANK_TIMEOUT_S)[0]
            out = dict(out, params=tree_map(np.copy, out["params"]),
                       opt_state=tree_map(lambda x: np.copy(x)
                                          if isinstance(x, np.ndarray)
                                          else x, out["opt_state"]))
            del refs
            return out
        return _canonical(self.state)

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        if self.actors:
            import ray_tpu_torch
            from ray_tpu_torch.parallel.dryrun import run_on_ranks
            # into the store once, read there by every rank
            run_on_ranks(self.actors, _rank_load, ray_tpu_torch.put(
                _loadable(state, self.plan.shard_weight_update)))
            return
        from ray_tpu_torch._bridge import train_state_from_jax
        self.state = train_state_from_jax(
            _loadable(state), self.config, self.bundle.device)

    def shutdown(self) -> None:
        if self.actors:
            from ray_tpu_torch.parallel.dryrun import stop_ranks
            stop_ranks(self.actors)
            self.actors = []


# ---------------------------------------------- the SPMD step on ranks
def _rank_build(rank, config, mesh_kw, opt, knobs, seed: int,
                device_type: str) -> None:
    """Build the sharded step over ``MeshSpec(**mesh_kw)`` on this rank
    and init its state from ``seed`` (a slice of the one-device init)."""
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_train_step)
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a plan rank that asked for the card finds no "
                           "CUDA device")
    mesh = build_mesh(MeshSpec(**mesh_kw), device_type=device_type)
    bundle = make_train_step(config, mesh, FSDP_RULES,
                             optimizer=default_optimizer(**opt),
                             device=device_type, **knobs)
    rank.state["plan"] = {"bundle": bundle, "mesh": mesh,
                          "block": knobs["quant_block_size"],
                          "state": bundle.init(seed=seed)}


def _rank_step(rank, batch) -> Dict[str, float]:
    p = rank.state["plan"]
    p["state"], m = p["bundle"].step(p["state"], batch)
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "n_tokens": float(m["n_tokens"]),
            "step": int(p["state"]["step"])}


def _rank_save(rank) -> Optional[Dict[str, Any]]:
    """The canonical state gathered from every rank's shards (a
    collective: every rank calls it), returned by rank 0 (None on the
    others); the flat moments of the sharded update are first joined
    back into this rank's param shards."""
    import torch.distributed as dist

    from ray_tpu_torch._bridge import gather_to_numpy
    from ray_tpu_torch.models.training import (_get, _paths, leaf_plans)
    from ray_tpu_torch.models.transformer import set_leaf
    from ray_tpu_torch.parallel.collective import _all_gather
    p = rank.state["plan"]
    b, st, mesh = p["bundle"], p["state"], p["mesh"]
    params, opt = st["params"], st["opt_state"]
    moments = {n: opt[n] for n in ("mu", "nu")}
    if b.shard_weight_update:
        plans = leaf_plans(b.config, mesh, b.rules, True)
        for name, tree in moments.items():
            shards: Dict = {}
            for path in _paths(params):
                local = _get(params, path)
                flat = _all_gather(_get(tree, path),
                                   plans[path].replicated).reshape(-1)
                set_leaf(shards, path,
                         flat[:local.numel()].view(local.shape))
            moments[name] = shards
    out = {"params": gather_to_numpy(params, b.config, mesh, b.rules),
           "opt_state": {"count": int(opt["count"]), **{
               n: gather_to_numpy(t, b.config, mesh, b.rules)
               for n, t in moments.items()}},
           "step": int(st["step"])}
    # the other ranks' copies would only cross the store to be dropped
    return out if dist.get_rank() == 0 else None


def _rank_load(rank, state) -> None:
    from ray_tpu_torch._bridge import shard_train_state_from_jax
    p = rank.state["plan"]
    b = p["bundle"]
    p["state"] = None
    gc.collect()
    p["state"] = shard_train_state_from_jax(
        state, b.config, p["mesh"], b.rules, device=b.device,
        shard_weight_update=b.shard_weight_update,
        quant_block_size=p["block"])


class _PipelineProgram(TrainProgram):
    """pp>=2: the MPMD pipeline, with dp x fsdp stage meshes (nested 3D)
    where the plan has them, on a slice-gang placement group when
    ``slice_strategy`` is set and a slice admits it."""

    def __init__(self, plan: ParallelPlan, config, *, learning_rate,
                 weight_decay, clip_norm, seed, device,
                 step_timeout_s, placement_timeout_s, stage_mesh=None):
        from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

        self.plan = plan
        self.config = config
        self.pg = None
        n_ranks = plan.stage_world if (
            plan.stage_world > 1 if stage_mesh is None else stage_mesh) \
            else 1
        if plan.slice_strategy is not None:
            self.pg = self._reserve_gang(plan.pp * n_ranks,
                                         placement_timeout_s)
        try:
            self.pipeline = MPMDPipeline(
                config, n_stages=plan.pp,
                n_microbatches=plan.n_microbatches, seed=seed,
                n_virtual=plan.virtual, train=True,
                learning_rate=learning_rate, weight_decay=weight_decay,
                clip_norm=clip_norm, step_timeout_s=step_timeout_s,
                device=device, dp=plan.dp, fsdp=plan.fsdp,
                grad_transport=plan.grad_transport,
                shard_weight_update=plan.shard_weight_update,
                quant_block_size=plan.quant_block_size,
                quant_stochastic=plan.quant_stochastic,
                stage_mesh=stage_mesh, placement_group=self.pg)
        except BaseException:
            self._remove_gang()
            raise

    def _reserve_gang(self, n_bundles: int, timeout_s):
        """One bundle (one CPU) per pipeline stage actor (``pp * dp *
        fsdp`` of them on a stage mesh) on a single slice's hosts — the
        gang → mesh hand-off. Falls back to local devices (None) when no
        runtime is up or no slice admits the gang in time, so the plan
        stays runnable anywhere."""
        try:
            import ray_tpu_torch
            from ray_tpu_torch.util.placement_group import (
                placement_group, remove_placement_group)
            if not ray_tpu_torch.is_initialized():
                logger.warning(
                    "plan %s: no runtime for slice_strategy=%s — "
                    "falling back to local devices",
                    self.plan.describe(), self.plan.slice_strategy)
                return None
            pg = placement_group([{"CPU": 1} for _ in range(n_bundles)],
                                 strategy=self.plan.slice_strategy)
            if pg.ready(timeout=timeout_s):
                logger.info("plan %s: gang placed on slice %s",
                            self.plan.describe(), pg.slice_id())
                return pg
            remove_placement_group(pg)
            logger.warning(
                "plan %s: no slice admitted the %d-bundle %s gang "
                "within %.0fs — falling back to local devices",
                self.plan.describe(), n_bundles,
                self.plan.slice_strategy, timeout_s)
            return None
        except Exception:
            logger.exception("plan %s: gang reservation failed — "
                             "falling back to local devices",
                             self.plan.describe())
            return None

    def step(self, batch: Dict[str, Any]) -> PlanStepResult:
        res = self.pipeline.step(batch)
        return PlanStepResult(
            loss=res.loss, grad_norm=res.grad_norm, step=res.step,
            wall_s=res.wall_s, n_tokens=res.n_tokens,
            bubble_fraction=res.bubble_fraction, detail=res)

    def save_checkpoint(self) -> Dict[str, Any]:
        return self.pipeline.save_checkpoint()

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        self.pipeline.load_checkpoint(state)

    def shutdown(self) -> None:
        self.pipeline.shutdown()
        self._remove_gang()

    def _remove_gang(self) -> None:
        if self.pg is not None:
            try:
                from ray_tpu_torch.util.placement_group import (
                    remove_placement_group)
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
