"""MPMD pipeline parallelism: actor-hosted stages, streamed activations,
interleaved virtual stages, a per-stage optimizer step, and a dp x fsdp
mesh inside each stage. The port of ``ray_tpu/parallel/mpmd_pipeline.py``.

``ops/pipeline.py`` runs every stage in one SPMD program (GPipe). This
module is the MPMD alternative the task/actor runtime makes possible
(arXiv:2412.14374; the decoupled-actor split of Podracer's sebulba,
arXiv:2104.06272):

- each pipeline stage is a :class:`PipelineStage` **actor** on its own
  device, holding ``n_virtual`` chunks of the model: actor ``s`` hosts
  global chunks ``s, s+S, s+2S, ...`` of ``K = S*v``, each
  ``models.transformer.stage_slice_params`` of the one-device
  ``init_params(seed)``, bit for bit. A forward keeps the autograd graph
  of its ``(chunk, microbatch)`` until the matching backward, which runs
  ``torch.autograd.backward`` from the downstream gradient and returns
  the input's gradient; parameter gradients accumulate in f32 in the
  actor across microbatches. With ``train=True`` the stage holds
  ``ClipAdamW`` state and applies one update from the driver's global
  gradient norm: gradients, parameters and optimizer state never leave
  the actor; the driver sees one f32 scalar a stage.
- a driver-side **interleaved 1F1B scheduler** (:class:`MPMDPipeline`)
  streams activations chunk to chunk: each stage's step is one
  ``num_returns="streaming"`` actor call whose items are its ops' outputs
  in the stage's deterministic :func:`one_f_one_b_order`; the driver
  waits on whichever stage produces next (``streaming.wait_any``) and
  routes the item's *ref*, never its bytes, into the next chunk's
  mailbox. With ``n_virtual > 1`` the warm-up and cool-down bubble
  shrinks: analytic ``(S-1)/(v*M+S-1)`` against GPipe's
  ``(S-1)/(M+S-1)``.
- a **stage mesh** (the JAX ``mpmd3d`` lowering, ``dp * fsdp > 1`` or
  ``stage_mesh=True``): where JAX drives a stage's dp x fsdp devices as
  one ``shard_map`` program, the port runs ``N = dp * fsdp`` rank actors
  a stage, one a mesh coordinate, joined in a collective group of their
  own (one a stage; stages share none). Params are replicated in the
  stage (JAX's ``P()``); each microbatch is split by rows over the ranks
  in ``P(("dp", "fsdp"))`` order, and rank ``r`` of chunk ``c`` sends to
  rank ``r`` of chunk ``c + 1``. The last chunk's loss is
  ``psum(loss * n) / psum(n)`` over the group and a rank seeds its
  backward with ``seed * n_loc / n_mb``. Each rank accumulates its
  gradients in f32 with no reduction in the backward; they are reduced
  once a step by ``collective.psum_tree`` over the group (f32, or the
  two-leg int8 ``quantized_psum`` with ``grad_transport="int8"``), and
  the squared norm is taken of the reduced gradients, one value a stage.
  ``shard_weight_update`` keeps the Adam moments as flat 1/N chunks on
  each rank (the flat layout of ``models.training``) and gathers the
  updated params back, so they stay replicated.

Activations and their gradients cross stages in the compute dtype
(``config.dtype``), as the JAX ``stage_forward`` returns them; on the
card a tensor crosses through the object store (a copy to the host, the
shared-memory write, a copy to the receiving stage's device, done on its
compute thread).

Every forward, backward, optimizer and idle interval is a
``STAGE_TICK`` flight-recorder event labelled with its phase and chunk,
and :meth:`PipelineStage.step_stats` returns the measured busy/idle split,
the hops' bytes and seconds and the stage reduction's bytes and seconds.

Checkpoints: :meth:`PipelineStage.stage_checkpoint` returns the stage's
params and Adam moments keyed by global chunk id (numpy, param-shaped:
flat moments are gathered first; a stage's part comes from its rank 0);
:func:`merge_stage_checkpoints` reassembles the canonical one-device
train state of ``models.training.make_train_step``, ``{"params",
"opt_state": {"count", "mu", "nu"}, "step"}``, and
:func:`split_train_state` slices it for any ``(n_stages, n_virtual)``: a
checkpoint saved at v=2 or dp=2 reloads at v=1 or dp=1, and into the
one-device step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._bridge import to_numpy
from ray_tpu_torch.models.training import (ClipAdamW, _flat_chunk, _get,
                                           _paths, tree_leaves, tree_map)
from ray_tpu_torch.models.transformer import (init_leaves,
                                              merge_stage_params, set_leaf,
                                              stage_forward,
                                              stage_layer_ranges, stage_loss,
                                              stage_slice_params)
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.mesh import AxisGroup
from ray_tpu_torch.parallel.quantization import (DEFAULT_BLOCK_SIZE,
                                                 tree_wire_bytes)
from ray_tpu_torch.parallel.sharding import flat_pad_len

__all__ = [
    "one_f_one_b_order",
    "interleaved_orders",
    "stage_virtual_chunks",
    "analytic_gpipe_bubble",
    "analytic_bubble",
    "PipelineStage",
    "MPMDPipeline",
    "PipelineStepResult",
    "merge_stage_checkpoints",
    "split_train_state",
]


def stage_virtual_chunks(stage: int, n_stages: int,
                         n_virtual: int = 1) -> Tuple[int, ...]:
    """Global chunk ids hosted by one stage actor: round-robin slabs
    ``stage, stage+S, stage+2S, ...`` of the ``K = S*v`` virtual
    stages (Megatron-style interleaving: chunk ``c`` lives on actor
    ``c % S``, so chunk ``c``'s output always feeds the NEXT actor)."""
    return tuple(range(stage, n_stages * n_virtual, n_stages))


def _classic_1f1b(stage: int, n_stages: int, n_microbatches: int
                  ) -> List[Tuple[str, int, int]]:
    """The v=1 1F1B schedule as seen by one stage (chunk == stage):
    warmup forwards fill the pipe (``n_stages - 1 - stage`` of them —
    the last stage has none), then the steady state alternates one
    forward with one backward, then the cooldown drains the remaining
    backwards."""
    m = n_microbatches
    warmup = min(n_stages - 1 - stage, m)
    order = [("F", i, stage) for i in range(warmup)]
    b = 0
    for f in range(warmup, m):
        order.append(("F", f, stage))
        order.append(("B", b, stage))
        b += 1
    order.extend(("B", i, stage) for i in range(b, m))
    return order


@functools.lru_cache(maxsize=256)
def interleaved_orders(n_stages: int, n_microbatches: int,
                       n_virtual: int
                       ) -> Tuple[Tuple[Tuple[str, int, int], ...], ...]:
    """Per-stage interleaved-1F1B op orders for a ``S x M x v`` grid,
    as a tuple (stage-indexed) of op tuples ``(op, microbatch, chunk)``.

    Built by a deterministic greedy tick simulation: at each tick every
    stage runs at most one *runnable* op (an op whose producers
    finished at a strictly earlier tick — one tick of transport
    latency), preferring backwards over forwards (1F1B steady state)
    and breaking ties with the Megatron-style group key ``(mb // S,
    chunk, mb % S)`` so forwards sweep chunk groups of S microbatches.
    The result is valid for ANY grid (no ``M % S`` constraint): the
    simulation only ever schedules dependency-satisfied ops, and a
    stage executing its list in order while blocking on mailboxes can
    never deadlock (every op's producers appear at earlier ticks).
    Deterministic in (S, M, v): the driver and every stage actor derive
    the same lists, so stream item *j* of stage *s* IS operation
    ``orders[s][j]`` — no tags ride the wire."""
    S, M, v = n_stages, n_microbatches, n_virtual
    K = S * v
    done_f: Dict[Tuple[int, int], int] = {}
    done_b: Dict[Tuple[int, int], int] = {}
    orders: List[List[Tuple[str, int, int]]] = [[] for _ in range(S)]
    total = 2 * M * K
    scheduled, t = 0, 0
    while scheduled < total:
        picks = []
        for s in range(S):
            chunks = stage_virtual_chunks(s, S, v)
            best = None
            # backwards first: B(c, i) needs F(c, i) and B(c+1, i)
            for c in chunks:
                for i in range(M):
                    if (c, i) in done_b:
                        continue
                    if done_f.get((c, i), t) >= t:
                        continue
                    if c < K - 1 and done_b.get((c + 1, i), t) >= t:
                        continue
                    key = ("B", i // S, K - 1 - c, i % S)
                    if best is None or key < best[0]:
                        best = (key, ("B", i, c))
            if best is None:
                # forwards: F(c, i) needs F(c-1, i)
                for c in chunks:
                    for i in range(M):
                        if (c, i) in done_f:
                            continue
                        if c > 0 and done_f.get((c - 1, i), t) >= t:
                            continue
                        key = ("F", i // S, c, i % S)
                        if best is None or key < best[0]:
                            best = (key, ("F", i, c))
            if best is not None:
                picks.append((s, best[1]))
        for s, (op, i, c) in picks:
            orders[s].append((op, i, c))
            (done_f if op == "F" else done_b)[(c, i)] = t
            scheduled += 1
        t += 1
    return tuple(tuple(o) for o in orders)


def one_f_one_b_order(stage: int, n_stages: int, n_microbatches: int,
                      n_virtual: int = 1) -> List[Tuple[str, int, int]]:
    """One stage's pipeline-step op order: ``[(op, microbatch, chunk),
    ...]`` with op "F"/"B" and ``chunk`` the global virtual-stage id.

    ``n_virtual == 1`` is the classic 1F1B schedule (chunk == stage);
    ``n_virtual > 1`` interleaves the stage's round-robin chunks via
    the deterministic greedy simulation in :func:`interleaved_orders`,
    cutting warmup/cooldown idle by the virtual-stage factor."""
    if n_virtual <= 1:
        return _classic_1f1b(stage, n_stages, n_microbatches)
    return list(interleaved_orders(n_stages, n_microbatches,
                                   n_virtual)[stage])


def analytic_bubble(n_stages: int, n_microbatches: int,
                    n_virtual: int = 1) -> float:
    """The analytic pipeline-bubble fraction with interleaved virtual
    stages, ``(S-1)/(v*M+S-1)``: warmup and cooldown are paid in
    CHUNK-sized quanta (1/v of a full stage visit), so the idle share
    of each device's timeline shrinks by the virtual-stage factor
    (arXiv:2412.14374; Megatron interleaved 1F1B)."""
    s, m, v = n_stages, n_microbatches, n_virtual
    return (s - 1) / (v * m + s - 1)


def analytic_gpipe_bubble(n_stages: int, n_microbatches: int) -> float:
    """The GPipe pipeline-bubble fraction ``(S-1)/(M+S-1)``: the share
    of each device's timeline spent idle when M microbatches flow
    through S stages with a full flush between steps. 1F1B has the
    same bubble in steady state; its win is activation memory."""
    return analytic_bubble(n_stages, n_microbatches, 1)


def _recorder():
    """This process's flight recorder (None outside a runtime)."""
    try:
        from ray_tpu_torch.core.global_state import try_global_worker
        w = try_global_worker()
        return w.recorder if w is not None else None
    except Exception:
        return None


def _in_worker() -> bool:
    """Whether this process is a runtime worker (an actor's process)."""
    from ray_tpu_torch.core.global_state import try_global_worker
    return getattr(try_global_worker(), "kind", None) == "worker"


def _check_stage_grid(dp: int, fsdp: int, grad_transport: str) -> None:
    if dp < 1 or fsdp < 1:
        raise ValueError(f"dp/fsdp must be >= 1, got {dp}/{fsdp}")
    if grad_transport not in ("fp32", "int8"):
        raise ValueError(f"grad_transport must be 'fp32' or 'int8', "
                         f"got {grad_transport!r}")


def _to_tensors(tree, device):
    """Numpy (or tensor) tree -> f32 tensors of their own on ``device``,
    each copied once from where it lies (a numpy leaf may view the object
    store's shared memory: on the card it goes straight to the device)."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            with warnings.catch_warnings():     # read-only: copied below
                warnings.simplefilter("ignore", UserWarning)
                x = torch.from_numpy(np.asarray(x, np.float32))
        return x.detach().to(device=device, dtype=torch.float32,
                             copy=True).contiguous()
    return tree_map(one, tree)


# --------------------------------------------------------- checkpoints
def merge_stage_checkpoints(config, parts: Sequence[Dict]) -> Dict:
    """Reassemble per-stage checkpoints (from
    :meth:`PipelineStage.stage_checkpoint`) into the canonical one-device
    train state ``{"params", "opt_state": {"count", "mu", "nu"},
    "step"}`` (numpy leaves), the layout of ``make_train_step``'s state:
    params and moments merged chunk-wise; the count and step from stage
    0 (the same on every stage by construction). Every leaf is an array
    of its own: none views the parts, which may live in the object
    store's shared memory."""
    parts = sorted(parts, key=lambda p: p["stage"])

    def merged(name):
        union: Dict[int, Any] = {}
        for p in parts:
            union.update(p["chunks"] if name is None
                         else p["opt_state"][name])
        return tree_map(lambda a: a if a.base is None else a.copy(),
                        merge_stage_params(config, union))

    out: Dict[str, Any] = {"params": merged(None),
                           "step": parts[0].get("step", 0)}
    if parts[0].get("opt_state") is not None:
        out["opt_state"] = {"count": parts[0]["opt_state"]["count"],
                            "mu": merged("mu"), "nu": merged("nu")}
    return out


def split_train_state(config, state: Dict, n_stages: int,
                      n_virtual: int = 1) -> List[Dict]:
    """Slice a canonical train state into per-stage load parts for any
    ``(n_stages, n_virtual)`` — the reload target need not match the
    layout the checkpoint was saved under. Inverse of
    :func:`merge_stage_checkpoints` (chunk slices are views of the
    state's leaves; :meth:`PipelineStage.load_state` copies them)."""
    K = n_stages * n_virtual

    def slice_for(s):
        chs = stage_virtual_chunks(s, n_stages, n_virtual)
        part: Dict[str, Any] = {
            "params": {c: stage_slice_params(config, state["params"], c, K)
                       for c in chs},
            "step": state.get("step", 0),
        }
        opt = state.get("opt_state")
        if opt is not None:
            part["opt_state"] = {"count": opt["count"], **{
                name: {c: stage_slice_params(config, opt[name], c, K)
                       for c in chs} for name in ("mu", "nu")}}
        return part

    return [slice_for(s) for s in range(n_stages)]


class PipelineStage:
    """One pipeline stage, or one rank of a stage's mesh: in-process, or
    hosted in its own actor.

    Holds the stage's ``n_virtual`` parameter chunks (f32 masters) on its
    device, the autograd graphs of the forwards whose backwards have not
    run, the accumulated parameter gradients and, with ``train=True``,
    its ``ClipAdamW`` state. Activations and gradients arrive through
    mailboxes keyed by ``(chunk, microbatch)`` (:meth:`feed`,
    :meth:`put_activation`, :meth:`put_grad`, :meth:`put_targets`), and
    one streaming :meth:`run` call a step yields the stage's per-op
    outputs in its deterministic interleaved-1F1B order.

    On a stage mesh (``dp * fsdp > 1``, or ``stage_mesh=True``) the
    object is rank ``rank`` of the stage's ``dp * fsdp`` ranks, which
    joined the collective group ``group_name`` (looked up at first use;
    at one rank no group is needed): it takes its rows of each
    microbatch, and its loss, gradient reduction, flat update and
    checkpoint gather run over that group, in the same order on every
    rank.

    Run as an actor with ``max_concurrency >= 2``: ``run`` blocks on the
    mailboxes while the feed calls execute on other threads; received
    tensors move to the device on ``run``'s thread.

    ``device=None`` is the card and raises without one, except in a
    runtime worker on the CPU platform, where it is the CPU.
    """

    def __init__(self, config, stage: int, n_stages: int, seed: int = 0,
                 device=None,
                 remat_policy: Optional[str] = None,
                 n_virtual: int = 1,
                 train: bool = False,
                 learning_rate: float = 1e-5,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = 1.0,
                 mailbox_deadline_s: Optional[float] = None,
                 dp: int = 1,
                 fsdp: int = 1,
                 grad_transport: str = "fp32",
                 shard_weight_update: bool = False,
                 quant_block_size: Optional[int] = None,
                 quant_stochastic: bool = False,
                 stage_mesh: Optional[bool] = None,
                 rank: int = 0,
                 group_name: Optional[str] = None):
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.serve.llm_engine import _server_device

        _check_stage_grid(dp, fsdp, grad_transport)
        if remat_policy is not None:
            config = dataclasses.replace(config, remat=None,
                                         remat_policy=remat_policy)
        self.config = config
        self.stage = stage
        self.n_stages = n_stages
        self.n_virtual = n_virtual
        self.n_chunks = n_stages * n_virtual
        self.chunks = stage_virtual_chunks(stage, n_stages, n_virtual)
        #: the stage's own data-parallel grid: each microbatch is split
        #: by rows over its dp x fsdp ranks (3D = pp x dp x fsdp)
        self.dp = int(dp)
        self.fsdp = int(fsdp)
        self.n_model = self.dp * self.fsdp
        self.grad_transport = grad_transport
        self.shard_weight_update = bool(shard_weight_update)
        self.quant_block_size = int(quant_block_size or DEFAULT_BLOCK_SIZE)
        self.quant_stochastic = bool(quant_stochastic)
        #: the mesh path: automatic when the stage grid is nontrivial;
        #: ``stage_mesh=True`` runs it on one rank (the clusterless tests)
        self.use_mesh = (self.n_model > 1 if stage_mesh is None
                         else bool(stage_mesh))
        n_ranks = self.n_model if self.use_mesh else 1
        if not 0 <= rank < n_ranks:
            raise ValueError(f"rank {rank} of a stage of {n_ranks} ranks")
        if n_ranks > 1 and group_name is None:
            raise ValueError(
                f"stage {stage}'s dp={self.dp} x fsdp={self.fsdp} mesh "
                f"needs its ranks' collective group (group_name)")
        self.rank = rank
        self.group_name = group_name
        self._axis: Optional[AxisGroup] = None
        #: flat 1/N optimizer chunks only make sense on a stage mesh
        self._opt_flat = self.use_mesh and self.shard_weight_update
        #: seconds a mailbox take may starve before the stage fails
        #: typed (a dead neighbour must surface as an error, never a
        #: hang) — config.pipeline_mailbox_deadline_s unless overridden
        self.mailbox_deadline_s = float(
            mailbox_deadline_s if mailbox_deadline_s is not None
            else get_config().pipeline_mailbox_deadline_s)
        self.device = _server_device(device)
        self.cuda = self.device.type == "cuda"
        if not self.cuda and _in_worker():
            # one torch thread a rank process on the CPU, as
            # parallel.dryrun's ranks: stages sharing a host must not
            # oversubscribe it
            torch.set_num_threads(1)
        self.params = self._init_chunks(seed)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.optimizer = None
        self.opt_state = None
        self.clip_norm = clip_norm
        if train:
            self.optimizer = ClipAdamW(learning_rate,
                                       weight_decay=weight_decay,
                                       clip_norm=clip_norm)
            self.opt_state = self.optimizer.init(
                tree_map(self._flat_slice, self.params) if self._opt_flat
                else self.params)
        self._step_count = 0
        self._cond = threading.Condition()
        self._acts: Dict[Tuple[int, int], Any] = {}
        self._grads_in: Dict[Tuple[int, int], Any] = {}
        self._targets: Dict[int, Any] = {}
        self._abort = False
        #: (chunk, microbatch) -> (output, received input[, local and
        #: stage token counts]) of a forward whose backward has not run:
        #: the graph JAX keeps as a vjp
        self._saved: Dict[Tuple[int, int], Any] = {}
        #: the step's gradients reduced over the stage mesh (cached until
        #: the next backward or step)
        self._red: Optional[List[torch.Tensor]] = None
        self._stats = self._fresh_stats()
        # live mailbox-depth gauge (fleet metrics plane): how many
        # microbatches are parked waiting for this stage
        self._mbx_gauge = None
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            self._mbx_gauge = runtime_metrics().pipeline_mailbox_depth
        except Exception:
            pass
        self._mbx_tags = {"stage": str(stage)}

    # ------------------------------------------------ the stage mesh
    def _group(self) -> AxisGroup:
        """The stage's ranks (a group of one off the mesh or at N=1)."""
        if self._axis is None:
            n = self.n_model if self.use_mesh else 1
            if n == 1:
                self._axis = AxisGroup(("dp", "fsdp"), None, 1, 0)
            else:
                g = collective.get_group(self.group_name)
                if (g.world_size, g.rank) != (n, self.rank):
                    raise ValueError(
                        f"group {self.group_name!r} holds rank {g.rank} of "
                        f"{g.world_size}; stage {self.stage} wants rank "
                        f"{self.rank} of {n}")
                self._axis = g.axis
        return self._axis

    def _flat_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``x`` flattened and padded to whole quant
        blocks over the stage's ranks (``models.training``'s flat layout;
        JAX's ``flatten_tree`` sharded over ``("dp", "fsdp")``)."""
        ranks = AxisGroup(("dp", "fsdp"), None, self.n_model, self.rank)
        return _flat_chunk(x.detach(), ranks, self.quant_block_size).clone()

    def _unflat(self, tree, like) -> Dict:
        """Flat chunks gathered over the stage's ranks back into the
        shapes of ``like`` (a collective: every rank calls it)."""
        out: Dict = {}
        for path in _paths(like):
            full = collective._all_gather(_get(tree, path),
                                          self._group()).reshape(-1)
            ref = _get(like, path)
            set_leaf(out, path, full[:ref.numel()].view(ref.shape))
        return out

    def _init_chunks(self, seed: int) -> Dict[int, Dict]:
        """``stage_slice_params(init_params(seed), chunk)`` for each of
        this stage's chunks, drawn leaf by leaf from the one-device
        generator: each chunk keeps its slice (a copy) of a leaf and the
        rest of the leaf is freed before the next is drawn, so the stage
        never holds the whole tree."""
        c, K = self.config, self.n_chunks
        ranges = stage_layer_ranges(c.n_layers, K)
        out: Dict[int, Dict] = {ch: {} for ch in self.chunks}
        for path, full in init_leaves(c, seed, self.device):
            for ch in self.chunks:
                if path[0] == "layers":
                    lo, hi = ranges[ch]
                    set_leaf(out[ch], path, full[lo:hi].clone())
                elif (path[0] == "embed" and ch == 0) or (
                        path[0] in ("final_norm", "lm_head")
                        and ch == K - 1):
                    set_leaf(out[ch], path, full)
            del full
        return out

    def _mbx_report_locked(self) -> None:
        """Refresh the mailbox-depth gauge (``self._cond`` held)."""
        if self._mbx_gauge is None:
            return
        try:
            self._mbx_gauge.set(
                len(self._acts) + len(self._grads_in) +
                len(self._targets), tags=self._mbx_tags)
        except Exception:
            pass

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        return {"busy_s": 0.0, "idle_s": 0.0, "fwd_s": 0.0,
                "bwd_s": 0.0, "opt_s": 0.0, "ops": 0, "span_s": 0.0,
                "sent_bytes": 0, "sent_s": 0.0, "recv_bytes": 0,
                "to_device_s": 0.0, "reduce_s": 0.0, "reduce_bytes": 0}

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _on_device(self, x, dtype=None) -> torch.Tensor:
        """A received payload (numpy ids, a host tensor) on this stage's
        device, on the calling (compute) thread; its bytes and the copy's
        seconds count as the hop's receive side."""
        t0 = time.perf_counter()
        # token ids and masks come as numpy (read-only from the store)
        t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) \
            else torch.as_tensor(x)
        out = t.to(self.device, dtype or t.dtype)
        self._sync()
        st = self._stats
        st["to_device_s"] += time.perf_counter() - t0
        st["recv_bytes"] += t.numel() * t.element_size()
        return out

    # ------------------------------------------------------- mailboxes
    def feed(self, acts=None, grads=None, targets=None) -> None:
        """Batched mailbox fill: the driver front-loads a whole step's
        token microbatches, targets and loss seeds in ONE actor call
        per stage (``acts``/``grads`` keyed ``(chunk, mb)``,
        ``targets`` keyed ``mb``) instead of 3M unary puts."""
        with self._cond:
            if acts:
                self._acts.update(acts)
            if grads:
                self._grads_in.update(grads)
            if targets:
                self._targets.update(targets)
            self._mbx_report_locked()
            self._cond.notify_all()

    def put_activation(self, chunk: int, i: int, x) -> None:
        with self._cond:
            self._acts[(chunk, i)] = x
            self._mbx_report_locked()
            self._cond.notify_all()

    def put_grad(self, chunk: int, i: int, g) -> None:
        with self._cond:
            self._grads_in[(chunk, i)] = g
            self._mbx_report_locked()
            self._cond.notify_all()

    def put_targets(self, i: int, input_ids, loss_mask=None) -> None:
        """Last stage only: the labels (and mask) microbatch the loss
        needs — fed by the driver alongside stage 0's token feed."""
        with self._cond:
            self._targets[i] = (input_ids, loss_mask)
            self._cond.notify_all()

    def abort(self) -> None:
        """Unblock any pending mailbox take with a typed error (driver
        cleanup after a neighbour stage died) AND drain every queued
        mailbox item. Mailbox keys are ``(chunk, microbatch)`` and
        repeat every step, so an item stranded by an aborted step would
        otherwise be consumed by the NEXT step's matching op. Draining
        here makes an aborted stage immediately reusable."""
        with self._cond:
            self._abort = True
            self._acts.clear()
            self._grads_in.clear()
            self._targets.clear()
            self._saved.clear()
            self._zero_grads()
            self._mbx_report_locked()
            self._cond.notify_all()

    def _take(self, box: Dict, key):
        deadline = time.monotonic() + self.mailbox_deadline_s
        with self._cond:
            while key not in box:
                if self._abort:
                    raise RuntimeError(
                        f"stage {self.stage} aborted waiting for "
                        f"{key}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"stage {self.stage} starved waiting for "
                        f"{key} beyond pipeline_mailbox_deadline_s="
                        f"{self.mailbox_deadline_s} (neighbor stage "
                        f"dead?)")
                self._cond.wait(0.1)
            out = box.pop(key)
            self._mbx_report_locked()
            return out

    # ----------------------------------------------------- op helpers
    def _fwd_op(self, ch: int, i: int, x, tgt):
        """One forward op: returns the yieldable output (the activation,
        detached, in the compute dtype, or ``{"loss", "n_tokens"}`` on
        the last chunk) and keeps the graph the matching backward
        needs. On a stage mesh the last chunk's loss and token count are
        the stage's: ``psum(loss * n) / max(psum(n), 1)`` and
        ``psum(n)`` over its ranks."""
        c, K = self.config, self.n_chunks
        p = self.params[ch]
        if ch == 0:
            xin = None
            h = stage_forward(c, ch, K, p, self._on_device(x))
        else:
            xin = self._on_device(x, c.dtype).detach().requires_grad_()
            h = stage_forward(c, ch, K, p, xin)
        if ch == K - 1:
            ids, mask = tgt
            ids = self._on_device(ids)
            mask = torch.ones(ids.shape, dtype=torch.float32,
                              device=self.device) if mask is None \
                else self._on_device(mask, torch.float32)
            loss, n = stage_loss(c, p, h, ids, mask)
            if not self.use_mesh:
                self._saved[(ch, i)] = (loss, xin)
                return {"loss": loss.item(), "n_tokens": float(n)}
            n = torch.as_tensor(n, dtype=torch.float32, device=self.device)
            tot = collective._all_reduce(torch.stack(
                [loss.detach().float() * n, n]), self._group())
            self._saved[(ch, i)] = (loss, xin, n, tot[1])
            return {"loss": (tot[0] / tot[1].clamp(min=1.0)).item(),
                    "n_tokens": tot[1].item()}
        self._saved[(ch, i)] = (h, xin)
        self._sync()
        return h.detach()

    def _bwd_op(self, ch: int, i: int, g):
        """One backward op: accumulates this chunk's parameter gradients
        (f32, in the params' ``.grad``, with no reduction over the stage
        mesh) and returns the upstream input gradient in the compute
        dtype (None on chunk 0). The last chunk's ``g`` is its loss seed,
        ``n_i / N``; a mesh rank scales it by ``n_loc / n_mb``, its share
        of the microbatch's tokens, so the ranks' summed gradients are
        the microbatch's."""
        saved = self._saved.pop((ch, i))
        out, xin = saved[0], saved[1]
        if ch == self.n_chunks - 1:
            g = torch.tensor(float(g), dtype=torch.float32)
            if self.use_mesh:
                n_loc, n_mb = (t.to("cpu") for t in saved[2:])
                g = g * n_loc / n_mb.clamp(min=1.0)
            g = g.to(device=self.device, dtype=out.dtype)
        else:
            g = self._on_device(g, out.dtype)
        torch.autograd.backward(out, g)
        self._red = None
        self._sync()
        return xin.grad.detach() if xin is not None else None

    def _yield_item(self, out):
        """Count a tensor item's bytes as the hop's send side."""
        if isinstance(out, torch.Tensor):
            self._stats["sent_bytes"] += out.numel() * out.element_size()
        return out

    # ------------------------------------------------------------ step
    def run(self, n_microbatches: int):
        """One pipeline step as a streaming generator: walks this
        stage's (interleaved) 1F1B order, blocking on the mailbox each
        op needs, and yields the op's output as its own stream item —
        the activation (F, non-last chunk), the (loss, n_tokens) dict
        (F, last chunk), the upstream input-gradient (B, chunk > 0) or
        the op duration (B, chunk 0). Records a ``STAGE_TICK`` span
        per compute AND per idle interval, labelled with phase and
        virtual-stage index: the timeline shows the bubbles. The time
        the runtime takes to store a yielded item (on the card, its copy
        to the host and the shared-memory write) is ``sent_s``."""
        rec = _recorder()
        K = self.n_chunks
        self._stats = self._fresh_stats()
        with self._cond:
            self._abort = False
        self._saved.clear()
        self._zero_grads()
        t_start = time.perf_counter()
        for op, i, ch in one_f_one_b_order(
                self.stage, self.n_stages, n_microbatches,
                self.n_virtual):
            t_wait = time.perf_counter()
            if op == "F":
                x = self._take(self._acts, (ch, i))
                tgt = self._take(self._targets, i) if ch == K - 1 \
                    else None
            else:
                g = self._take(self._grads_in, (ch, i))
            idle = time.perf_counter() - t_wait
            if rec is not None and idle > 1e-4:
                rec.record("STAGE_TICK", stage=self.stage, mb=i, vs=ch,
                           phase="idle", dur_s=round(idle, 6))
            t0 = time.perf_counter()
            if op == "F":
                out = self._fwd_op(ch, i, x, tgt)
            else:
                out = self._bwd_op(ch, i, g)
            dur = time.perf_counter() - t0
            st = self._stats
            st["busy_s"] += dur
            st["idle_s"] += idle
            st["fwd_s" if op == "F" else "bwd_s"] += dur
            st["ops"] += 1
            if rec is not None:
                rec.record("STAGE_TICK", stage=self.stage, mb=i, vs=ch,
                           phase="forward" if op == "F" else "backward",
                           dur_s=round(dur, 6))
                rec.maybe_flush()
            t_send = time.perf_counter()
            yield self._yield_item(out) if out is not None \
                else {"dur_s": dur}
            self._stats["sent_s"] += time.perf_counter() - t_send
        self._stats["span_s"] = time.perf_counter() - t_start

    # ---------------------------------------------------- optimizer step
    def _chunk_grads(self) -> List[torch.Tensor]:
        return [p.grad for p in tree_leaves(self.params)]

    def _zero_grads(self) -> None:
        for p in tree_leaves(self.params):
            p.grad = None
        self._red = None

    def _require_grads(self) -> None:
        missing = [c for c in self.chunks
                   if any(p.grad is None
                          for p in tree_leaves(self.params[c]))]
        if missing:
            raise RuntimeError(
                f"stage {self.stage}: no accumulated grads for chunks "
                f"{missing} (run a step first)")

    def _reduced_grads(self) -> List[torch.Tensor]:
        """The step's accumulated gradients (in ``tree_leaves`` order),
        reduced over the stage mesh: THE stage's communication, one
        ``psum_tree`` pass over the whole gradient a step (a plain f32
        all-reduce, or the two-leg int8 reduction with real int8
        payloads, its stochastic rounding seeded from the step and the
        rank). Cached until the next backward or step; off the mesh the
        gradients themselves."""
        if not self.use_mesh:
            return self._chunk_grads()
        if self._red is None:
            self._sync()
            t0 = time.perf_counter()
            group = self._group()
            grads = {c: tree_map(lambda p: p.grad, self.params[c])
                     for c in self.chunks}
            red = collective.psum_tree(
                grads, group, transport=self.grad_transport,
                block_size=self.quant_block_size,
                stochastic_rounding=self.quant_stochastic,
                seed=(0xE8 << 32) + self._step_count)
            self._red = tree_leaves(red)
            self._sync()
            dur = time.perf_counter() - t0
            st = self._stats
            st["reduce_s"] += dur
            st["busy_s"] += dur
            st["reduce_bytes"] += self._reduce_wire_bytes()
        return self._red

    def _reduce_wire_bytes(self) -> int:
        """Bytes of this rank's payload in one stage reduction: ``4 * n``
        a leaf for f32; for int8 the scatter leg's int8 values and f32
        block scales of each leaf padded to whole blocks over the ranks
        (``quantization.tree_wire_bytes``). 0 off the mesh or at one
        rank."""
        n = self.n_model if self.use_mesh else 1
        if n == 1:
            return 0
        sizes = [p.numel() for p in tree_leaves(self.params)]
        if self.grad_transport == "fp32":
            return tree_wire_bytes(sizes, transport="fp32")
        block = self.quant_block_size
        return tree_wire_bytes([flat_pad_len(k, n, block) for k in sizes],
                               block, "int8")

    def grad_sq_norm(self) -> float:
        """Squared L2 norm of this stage's accumulated f32 gradients —
        the stage's share of the global clip norm (one f32 scalar, the
        only gradient-derived value that reaches the driver in train
        mode). On a mesh it is taken of the reduced gradients, so every
        rank of the stage returns the same value (and every rank must
        call it: the reduction is a collective)."""
        self._require_grads()
        grads = self._reduced_grads()
        with torch.no_grad():
            sq = torch.stack([g.float().square().sum() for g in grads]).sum()
        return float(sq)

    def apply_opt(self, global_sq_norm: float) -> Dict[str, float]:
        """The stage's optimizer step: ``ClipAdamW.update`` on its
        params with the (reduced) gradients scaled by the clip of the
        global norm ``sqrt(global_sq_norm)`` (the sum of one
        :meth:`grad_sq_norm` a stage). With the flat update each rank
        updates its 1/N flat chunk of the params and moments, and the
        params are gathered back over the stage's ranks. Gradients,
        params and optimizer state never leave the stage; returns scalar
        metrics."""
        if self.optimizer is None:
            raise RuntimeError("stage built with train=False has no "
                               "optimizer (pass train=True)")
        self._require_grads()
        grads = self._reduced_grads()
        t0 = time.perf_counter()
        norm = torch.tensor(global_sq_norm, dtype=torch.float32,
                            device=self.device).sqrt()
        leaves, paths = tree_leaves(self.params), _paths(self.params)
        if self._opt_flat:
            chunks = [self._flat_slice(p) for p in leaves]
            self.optimizer.update([self._flat_slice(g) for g in grads],
                                  self.opt_state, chunks, norm, paths)
            with torch.no_grad():
                for p, c in zip(leaves, chunks):
                    full = collective._all_gather(c, self._group())
                    p.copy_(full.reshape(-1)[:p.numel()].view(p.shape))
        else:
            self.optimizer.update(grads, self.opt_state, leaves, norm,
                                  paths)
        self._zero_grads()
        self._step_count += 1
        self._sync()
        dur = time.perf_counter() - t0
        st = self._stats
        st["busy_s"] += dur
        st["opt_s"] += dur
        rec = _recorder()
        if rec is not None:
            rec.record("STAGE_TICK", stage=self.stage, phase="opt",
                       dur_s=round(dur, 6))
            rec.maybe_flush()
        return {"grad_norm": float(global_sq_norm) ** 0.5,
                "opt_s": dur, "step": self._step_count}

    # ----------------------------------------------------- checkpoint
    def _opt_numpy(self):
        """The moments param-shaped in numpy (the flat chunks gathered
        first: a collective every rank joins); None off rank 0."""
        if self.opt_state is None:
            return None
        mu, nu = self.opt_state["mu"], self.opt_state["nu"]
        if self._opt_flat:
            mu, nu = self._unflat(mu, self.params), \
                self._unflat(nu, self.params)
        if self.rank:
            return None
        return {"count": int(self.opt_state["count"]),
                "mu": to_numpy(mu), "nu": to_numpy(nu)}

    def adam_bytes(self) -> int:
        """Bytes of the Adam moments this rank holds."""
        if self.opt_state is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for n in ("mu", "nu")
                   for t in tree_leaves(self.opt_state[n]))

    def stage_checkpoint(self) -> Optional[Dict[str, Any]]:
        """Host (numpy) copy of the stage's train state, keyed by global
        chunk id — :func:`merge_stage_checkpoints` reassembles the
        canonical one-device layout from all stages' parts. Param-shaped
        and whole: on a mesh every rank must call it (the flat moments
        are gathered), and the part comes from rank 0 (the params are
        replicated); the other ranks return None."""
        opt = self._opt_numpy()
        if self.rank:
            return None
        return {"stage": self.stage, "n_stages": self.n_stages,
                "n_virtual": self.n_virtual,
                "chunks": {c: to_numpy(p) for c, p in self.params.items()},
                "opt_state": opt, "step": self._step_count}

    def load_state(self, part: Dict[str, Any]) -> None:
        """Load one part from :func:`split_train_state` (params keyed
        by this stage's chunk ids, opt state in the stage layout; the
        moments whole, or, with the flat update, re-sliced into this
        rank's flat chunk)."""
        want = set(self.chunks)
        got = {int(c) for c in part["params"]}
        if want != got:
            raise ValueError(
                f"stage {self.stage} hosts chunks {sorted(want)}, "
                f"checkpoint part carries {sorted(got)}")
        params = {int(c): _to_tensors(p, self.device)
                  for c, p in part["params"].items()}
        self.params = {c: params[c] for c in self.chunks}
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self._red = None
        opt = part.get("opt_state")
        if opt is not None:
            if self.optimizer is None:
                raise RuntimeError("cannot load optimizer state into a "
                                   "train=False stage")

            def moment(tree):
                t = _to_tensors(tree, self.device)
                return tree_map(self._flat_slice, t) if self._opt_flat \
                    else t
            self.opt_state = {
                "count": torch.tensor(int(opt["count"]), dtype=torch.int32,
                                      device=self.device),
                **{n: {c: moment(opt[n][c]) for c in self.chunks}
                   for n in ("mu", "nu")}}
        self._step_count = int(part.get("step", 0))

    def stream_checkpoint(self):
        """:meth:`stage_checkpoint` as a stream: one block per param
        chunk, then one meta block carrying the opt state and step
        count. Each block is its own stream item (exactly-once over the
        reliable layer), so the driver can forward a chunk's ref to its
        new owner while later chunks are still being copied, and the
        bytes move worker to worker (:meth:`load_state_blocks`). The
        blocks are whole (param-shaped), so any rank of a stage of any
        dp x fsdp loads them; on a mesh only rank 0 yields them, and the
        other ranks join the flat moments' gather."""
        if self.rank:
            self._opt_numpy()
            return
        for c in self.chunks:
            yield {"block": "params", "stage": self.stage, "chunk": c,
                   "params": to_numpy(self.params[c])}
        yield {"block": "meta", "stage": self.stage,
               "n_stages": self.n_stages, "n_virtual": self.n_virtual,
               "opt_state": self._opt_numpy(), "step": self._step_count}

    def load_state_blocks(self, *blocks) -> None:
        """Assemble a stage part from :meth:`stream_checkpoint` blocks
        and load it. The blocks arrive as actor-call object args, so
        when the driver passes the REFS a peer stage streamed, the
        payload is pulled worker-to-worker."""
        part: Dict[str, Any] = {"params": {}}
        for b in blocks:
            if b.get("block") == "params":
                part["params"][int(b["chunk"])] = b["params"]
            else:
                part["opt_state"] = b.get("opt_state")
                part["step"] = b.get("step", 0)
        self.load_state(part)

    # ------------------------------------- serial (unpipelined) path
    def forward_one(self, chunk: int, i: int, x, input_ids=None,
                    loss_mask=None):
        """Unary forward for the serial chunk-by-chunk baseline: no
        mailbox, one (chunk, microbatch) per call."""
        t0 = time.perf_counter()
        tgt = (input_ids, loss_mask) \
            if chunk == self.n_chunks - 1 and chunk > 0 else None
        res = self._fwd_op(chunk, i, x, tgt)
        self._tick("forward", i, chunk, time.perf_counter() - t0)
        return res

    def backward_one(self, chunk: int, i: int, g):
        t0 = time.perf_counter()
        out = self._bwd_op(chunk, i, g)
        self._tick("backward", i, chunk, time.perf_counter() - t0)
        return out

    def _tick(self, phase: str, i: int, chunk: int, dur: float) -> None:
        st = self._stats
        st["busy_s"] += dur
        st[("fwd_s" if phase == "forward" else "bwd_s")] += dur
        st["ops"] += 1
        rec = _recorder()
        if rec is not None:
            rec.record("STAGE_TICK", stage=self.stage, mb=i, vs=chunk,
                       phase=phase, dur_s=round(dur, 6))
            rec.maybe_flush()

    def reset_step(self) -> None:
        """Serial-path step reset (the streaming ``run`` resets
        itself)."""
        with self._cond:
            self._abort = False
        self._saved.clear()
        self._zero_grads()
        self._stats = self._fresh_stats()
        self._t_reset = time.perf_counter()

    # ------------------------------------------------------- queries
    def step_stats(self) -> Dict[str, float]:
        st = dict(self._stats)
        if not st["span_s"] and getattr(self, "_t_reset", None):
            st["span_s"] = time.perf_counter() - self._t_reset
        st["device"] = str(self.device)
        st["stage"] = self.stage
        st["rank"] = self.rank
        st["chunks"] = list(self.chunks)
        return st

    def get_grads(self):
        """Host (numpy) copy of the accumulated parameter gradients,
        keyed by global chunk id (fwd+bwd mode; in train mode the
        gradients are consumed in the stage by :meth:`apply_opt`). On a
        mesh the stage's REDUCED gradients (one reduction, cached; every
        rank must call it), from rank 0 only (the others return {})."""
        out = {}
        if self.use_mesh:
            if any(p.grad is None for p in tree_leaves(self.params)):
                return out
            it = iter(self._reduced_grads())
            red = {c: tree_map(lambda _: next(it), self.params[c])
                   for c in self.chunks}
            return {} if self.rank else to_numpy(red)
        for c in self.chunks:
            leaves = tree_leaves(self.params[c])
            if all(p.grad is not None for p in leaves):
                out[c] = to_numpy(tree_map(lambda p: p.grad,
                                            self.params[c]))
        return out

    def ping(self) -> int:
        return self.stage


@dataclasses.dataclass
class PipelineStepResult:
    loss: float
    n_tokens: float
    #: per-microbatch (loss, n) pairs in microbatch order
    microbatch_losses: List[Tuple[float, float]]
    #: step_stats dicts, one a stage (one a rank, in (stage, rank)
    #: order, on a stage mesh)
    stage_stats: List[Dict[str, float]]
    wall_s: float
    #: global gradient norm (train mode; None for fwd+bwd steps)
    grad_norm: Optional[float] = None
    #: optimizer step count after this step (train mode)
    step: Optional[int] = None

    @property
    def bubble_fraction(self) -> float:
        """Measured bubble: the mean over stages (ranks) of the fraction
        of the step's wall clock each spent NOT computing."""
        if not self.wall_s:
            return 0.0
        fr = [1.0 - min(s["busy_s"] / self.wall_s, 1.0)
              for s in self.stage_stats]
        return sum(fr) / len(fr)


def stage_gpus(n_stages: int) -> float:
    """The ``num_gpus`` each of ``n_stages`` stage (or rank) actors asks
    for: a card each where the runtime counts at least ``n_stages`` GPUs,
    ``1/n_stages`` of one where it counts fewer (they share the card),
    none where it counts none (actors on the CPU platform)."""
    import ray_tpu_torch
    have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
    if have >= n_stages:
        return 1.0
    return 1.0 / n_stages if have > 0 else 0.0


def actor_device(device, n_actors: int) -> Tuple[str, float]:
    """Where a plan's ``n_actors`` stage or rank actors run, and the
    ``num_gpus`` each asks for. ``device="cpu"``: the CPU, no card. Else
    each asks for its share of the cards as :func:`stage_gpus` says, and
    runs on the card, or on the CPU where the runtime's workers are on
    the CPU platform (``RAY_TPU_TORCH_PLATFORM=cpu`` hides every card
    from them). Raises where the runtime counts no GPU and the CPU was
    not asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu", 0.0
    gpus = stage_gpus(n_actors)
    if os.environ.get("RAY_TPU_TORCH_PLATFORM") == "cpu":
        return "cpu", gpus
    if not gpus:
        raise RuntimeError(
            f"{n_actors} actors need the card, and the runtime counts no "
            f"GPU (pass device='cpu' to run them on the CPU)")
    return "cuda", gpus


class MPMDPipeline:
    """Driver-side interleaved-1F1B scheduler over
    :class:`PipelineStage` actors.

    ``step(batch)`` splits the batch into ``n_microbatches`` along the
    batch axis, feeds chunk 0's token microbatches / the last chunk's
    targets and loss seeds, launches one streaming ``run`` per stage,
    and routes items (by ref) between neighbour chunks as
    ``streaming.wait_any`` reports them ready. The combined loss is
    the token-weighted mean of the per-microbatch losses — the
    one-device ``lm_loss`` of the full batch.

    ``n_virtual > 1`` hosts that many round-robin virtual stage chunks
    per actor and drives the interleaved schedule — analytic bubble
    ``(S-1)/(v*M+S-1)``.

    ``dp * fsdp > 1`` (or ``stage_mesh=True``) gives every stage a mesh
    of ``dp * fsdp`` rank actors (``self.ranks[s]``; ``self.stages``
    lists all ``S * N`` in (stage, rank) order), joined in one collective
    group a stage (gloo where ranks share a card, NCCL where each has
    its own): each rank takes its rows of every microbatch, rank ``r``
    of a chunk feeds rank ``r`` of the next, and the stage reduces its
    gradients once a step over its group (``grad_transport``,
    ``quant_block_size``, ``quant_stochastic``), with the flat 1/N
    update under ``shard_weight_update``.

    ``train=True`` makes ``step`` a full train step: after the streams
    drain, the driver sums the stages' squared gradient norms (one
    scalar a stage, however many ranks it has), then every rank applies
    its optimizer step at once — gradients, parameters and optimizer
    state never transit the driver. ``save_checkpoint()`` /
    ``load_checkpoint()`` move the canonical one-device state layout in
    and out (any ``n_virtual`` and stage mesh).

    ``serial=True`` drives the same actors chunk by chunk with unary
    calls and full barriers — the no-overlap baseline.

    Actors run where :func:`actor_device` puts them (the card unless
    ``device="cpu"``) and ask for ``num_gpus`` as it says for ``S * N``
    actors (``self.stage_gpus``); with a ``placement_group`` actor ``j``
    of ``self.stages`` takes its bundle ``j``.
    """

    def __init__(self, config, n_stages: int = 2,
                 n_microbatches: int = 4, seed: int = 0,
                 serial: bool = False,
                 step_timeout_s: float = 300.0,
                 device=None,
                 n_virtual: int = 1,
                 train: bool = False,
                 learning_rate: float = 1e-5,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = 1.0,
                 mailbox_deadline_s: Optional[float] = None,
                 dp: int = 1,
                 fsdp: int = 1,
                 grad_transport: str = "fp32",
                 shard_weight_update: bool = False,
                 quant_block_size: Optional[int] = None,
                 quant_stochastic: bool = False,
                 stage_mesh: Optional[bool] = None,
                 placement_group=None):
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.core.config import get_config

        if n_stages < 2:
            raise ValueError("MPMDPipeline needs n_stages >= 2 "
                             "(use the plain train step otherwise)")
        if n_virtual < 1:
            raise ValueError(f"n_virtual must be >= 1, got {n_virtual}")
        if n_stages * n_virtual > config.n_layers:
            raise ValueError(
                f"n_stages*n_virtual = {n_stages * n_virtual} virtual "
                f"stages need at least that many layers, model has "
                f"{config.n_layers}")
        _check_stage_grid(dp, fsdp, grad_transport)
        self.config = config
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_virtual = n_virtual
        self.n_chunks = n_stages * n_virtual
        self.serial = serial
        self.train = train
        self.dp = dp
        self.fsdp = fsdp
        self.n_model = dp * fsdp
        self._stage_mesh = (self.n_model > 1 if stage_mesh is None
                            else bool(stage_mesh))
        #: rank actors a stage: its mesh's, or one
        self.n_ranks = self.n_model if self._stage_mesh else 1
        self.placement_group = placement_group
        self.step_timeout_s = step_timeout_s
        # resolve the mailbox deadline on the DRIVER (its config sees
        # _system_config overrides) and ship the value to every stage
        deadline = (mailbox_deadline_s if mailbox_deadline_s is not None
                    else get_config().pipeline_mailbox_deadline_s)
        N = self.n_ranks
        where, self.stage_gpus = actor_device(device, n_stages * N)
        opts: Dict[str, Any] = {"max_concurrency": 4, "max_restarts": 0,
                                "num_gpus": self.stage_gpus}
        token = uuid.uuid4().hex[:8]
        names = [f"pp{s}-{token}" if N > 1 else None
                 for s in range(n_stages)]
        self.ranks: List[List[Any]] = []
        self.stages: List[Any] = []
        for s in range(n_stages):
            row = []
            for r in range(N):
                rank_opts = dict(opts)
                if placement_group is not None:
                    # one actor a bundle of the gang
                    from ray_tpu_torch.util.scheduling_strategies import (
                        PlacementGroupSchedulingStrategy)
                    rank_opts["scheduling_strategy"] = \
                        PlacementGroupSchedulingStrategy(
                            placement_group,
                            placement_group_bundle_index=s * N + r)
                cls = ray_tpu_torch.remote(**rank_opts)(PipelineStage)
                row.append(cls.remote(
                    config, s, n_stages, seed=seed, device=where,
                    n_virtual=n_virtual, train=train,
                    learning_rate=learning_rate,
                    weight_decay=weight_decay, clip_norm=clip_norm,
                    mailbox_deadline_s=deadline, dp=dp, fsdp=fsdp,
                    grad_transport=grad_transport,
                    shard_weight_update=shard_weight_update,
                    quant_block_size=quant_block_size,
                    quant_stochastic=quant_stochastic,
                    stage_mesh=stage_mesh, rank=r, group_name=names[s]))
                self.stages.append(row[-1])
            self.ranks.append(row)
        try:
            ray_tpu_torch.get([a.ping.remote() for a in self.stages],
                              timeout=300)
            if N > 1:
                self._join_stage_groups(names, where)
        except BaseException:
            self.shutdown()
            raise

    def _join_stage_groups(self, names, where: str) -> None:
        """One collective group a stage over its ranks (a process group
        of its own in each rank's process: stages share none)."""
        import ray_tpu_torch
        from ray_tpu_torch.parallel.collective import _actor_join
        N = self.n_ranks
        backend = "nccl" if where == "cuda" and self.stage_gpus == 1.0 \
            else "gloo"
        ray_tpu_torch.get(
            [a.__ray_call__.remote(_actor_join, N, r, backend, names[s])
             for s, row in enumerate(self.ranks)
             for r, a in enumerate(row)], timeout=300)

    # ---------------------------------------------------------- steps
    def _split(self, batch: Dict[str, Any]):
        ids = np.asarray(batch["input_ids"])
        mask = batch.get("loss_mask")
        mask = np.asarray(mask) if mask is not None else None
        m = self.n_microbatches
        if ids.shape[0] % m:
            raise ValueError(f"batch {ids.shape[0]} not divisible by "
                             f"{m} microbatches")
        if self._stage_mesh and (ids.shape[0] // m) % self.n_model:
            raise ValueError(
                f"microbatch rows ({ids.shape[0] // m}) not divisible "
                f"by the stage mesh dp*fsdp = {self.dp}*{self.fsdp} "
                f"= {self.n_model}")
        ids_mb = np.split(ids, m)
        mask_mb = np.split(mask, m) if mask is not None else [None] * m
        # per-microbatch label-token counts — known to the driver
        # without running the model, so the last chunk's backward seeds
        # (d total / d loss_i = n_i / N) can be fed up front
        ns = [float(mk[:, 1:].sum()) if mk is not None
              else float(i.shape[0] * (i.shape[1] - 1))
              for i, mk in zip(ids_mb, mask_mb)]
        return ids_mb, mask_mb, ns

    def rows(self, x, r: int):
        """Rank ``r``'s rows of a microbatch (``P(("dp", "fsdp"))``)."""
        if x is None or self.n_ranks == 1:
            return x
        n = x.shape[0] // self.n_ranks
        return x[r * n:(r + 1) * n]

    def step(self, batch: Dict[str, Any]) -> PipelineStepResult:
        res = (self._step_serial if self.serial
               else self._step_1f1b)(batch)
        self._record_step_telemetry(batch, res)
        return res

    def _record_step_telemetry(self, batch: Dict[str, Any],
                               res: PipelineStepResult) -> None:
        """Per-step training telemetry into the fleet metrics plane:
        step wall, tokens/s, measured bubble, grad norm and an MFU
        gauge over the stages' cards."""
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            m = runtime_metrics()
            m.train_step_wall.observe(res.wall_s)
            m.pipeline_bubble.set(res.bubble_fraction)
            m.train_loss.set(res.loss)
            if res.grad_norm is not None:
                m.train_grad_norm.set(res.grad_norm)
            if res.wall_s > 0:
                ids = np.asarray(batch["input_ids"])
                tokens_per_s = float(ids.size) / res.wall_s
                m.train_tokens_per_s.set(tokens_per_s)
                try:
                    from ray_tpu_torch.parallel.mesh import chip_spec
                    achieved = tokens_per_s * \
                        self.config.flops_per_token(ids.shape[1])
                    peak = chip_spec().bf16_flops * len(self.stages)
                    m.train_mfu.set(100.0 * achieved / peak)
                except Exception:
                    pass
            rec = _recorder()
            if rec is not None:
                rec.maybe_flush()
            from ray_tpu_torch.core.global_state import try_global_worker
            w = try_global_worker()
            if w is not None and getattr(w, "metrics_reporter",
                                         None) is not None:
                w.metrics_reporter.maybe_report()
        except Exception:
            pass

    def _opt_tail(self) -> Tuple[Optional[float], Optional[int]]:
        """Train-mode tail after the backwards drain: sum the stages'
        squared gradient norms (one scalar a stage: its ranks reduce
        their gradients and agree on it), fan the global value back
        out, and run every rank's optimizer step at once. No gradient or
        parameter bytes through the driver."""
        import ray_tpu_torch

        if not self.train:
            return None, None
        sq = ray_tpu_torch.get(
            [a.grad_sq_norm.remote() for a in self.stages],
            timeout=self.step_timeout_s)
        gsq = float(sum(sq[s * self.n_ranks]
                        for s in range(self.n_stages)))
        mets = ray_tpu_torch.get([a.apply_opt.remote(gsq)
                                  for a in self.stages],
                                 timeout=self.step_timeout_s)
        return mets[0]["grad_norm"], mets[0]["step"]

    def _step_1f1b(self, batch: Dict[str, Any]) -> PipelineStepResult:
        import ray_tpu_torch
        from ray_tpu_torch.core import streaming

        S, M, v = self.n_stages, self.n_microbatches, self.n_virtual
        K, N = self.n_chunks, self.n_ranks
        ids_mb, mask_mb, ns = self._split(batch)
        total_n = sum(ns)
        t0 = time.perf_counter()
        hold = []  # keep routed refs alive until the step completes
        # batched prefeed: stage 0's token microbatches in one call a
        # rank, the last stage's targets + loss cotangents (scalar
        # n_i / N, known up front) in another
        for r in range(N):
            hold.append(self.ranks[0][r].feed.remote(
                acts={(0, i): self.rows(ids_mb[i], r) for i in range(M)}))
            hold.append(self.ranks[-1][r].feed.remote(
                targets={i: (self.rows(ids_mb[i], r),
                             self.rows(mask_mb[i], r)) for i in range(M)},
                grads={(K - 1, i): np.float32(ns[i] / total_n)
                       for i in range(M)}))
        gens = [a.run.options(num_returns="streaming").remote(M)
                for a in self.stages]
        orders = [one_f_one_b_order(s, S, M, v) for s in range(S)]
        cursors = [0] * len(gens)
        loss_refs: Dict[int, Any] = {}
        by_gen = {id(g): j for j, g in enumerate(gens)}
        active = list(gens)
        deadline = time.monotonic() + self.step_timeout_s
        try:
            while active:
                ready, _ = streaming.wait_any(
                    active, timeout=max(deadline - time.monotonic(), 0.0))
                if not ready:
                    raise TimeoutError(
                        f"pipeline step stalled: no stage produced an "
                        f"item within {self.step_timeout_s}s")
                for g in ready:
                    j = by_gen[id(g)]
                    s, r = divmod(j, N)
                    try:
                        ref = g.next_ref(timeout=1.0)
                    except StopIteration:
                        active.remove(g)
                        continue
                    op, i, ch = orders[s][cursors[j]]
                    cursors[j] += 1
                    if op == "F" and ch < K - 1:
                        hold.append(
                            self.ranks[(ch + 1) % S][r]
                            .put_activation.remote(ch + 1, i, ref))
                    elif op == "F" and r == 0:
                        # tiny loss dicts (the stage's: the same on each
                        # rank): batch the gets after drain
                        loss_refs[i] = ref
                    elif op == "B" and ch > 0:
                        hold.append(
                            self.ranks[(ch - 1) % S][r]
                            .put_grad.remote(ch - 1, i, ref))
                    hold.append(ref)
            items = ray_tpu_torch.get([loss_refs[i] for i in range(M)],
                                      timeout=60)
            losses = {i: (it["loss"], it["n_tokens"])
                      for i, it in enumerate(items)}
            grad_norm, opt_step = self._opt_tail()
        except BaseException:
            self._cleanup(gens)
            raise
        wall = time.perf_counter() - t0
        stats = ray_tpu_torch.get(
            [a.step_stats.remote() for a in self.stages], timeout=60)
        mb = [losses[i] for i in range(M)]
        loss = sum(l * n for l, n in mb) / total_n
        return PipelineStepResult(
            loss=loss, n_tokens=total_n, microbatch_losses=mb,
            stage_stats=stats, wall_s=wall, grad_norm=grad_norm,
            step=opt_step)

    def _step_serial(self, batch: Dict[str, Any]) -> PipelineStepResult:
        """No-overlap baseline: each microbatch walks every chunk's
        forward, then every chunk's backward, with a full barrier per
        call — what pipelining exists to beat."""
        import ray_tpu_torch

        S, M, K = self.n_stages, self.n_microbatches, self.n_chunks
        ids_mb, mask_mb, ns = self._split(batch)
        total_n = sum(ns)
        t0 = time.perf_counter()
        ray_tpu_torch.get([a.reset_step.remote() for a in self.stages],
                          timeout=60)
        get = lambda refs: ray_tpu_torch.get(  # noqa: E731
            refs, timeout=self.step_timeout_s)
        losses = []
        for i in range(M):
            ids = [self.rows(ids_mb[i], r) for r in range(self.n_ranks)]
            masks = [self.rows(mask_mb[i], r) for r in range(self.n_ranks)]
            acts = get([a.forward_one.remote(0, i, ids[r])
                        for r, a in enumerate(self.ranks[0])])
            for ch in range(1, K):
                acts = get([
                    a.forward_one.remote(ch, i, acts[r], ids[r], masks[r])
                    if ch == K - 1 else a.forward_one.remote(ch, i, acts[r])
                    for r, a in enumerate(self.ranks[ch % S])])
            losses.append((acts[0]["loss"], acts[0]["n_tokens"]))
            gs: List[Any] = [np.float32(ns[i] / total_n)] * self.n_ranks
            for ch in range(K - 1, -1, -1):
                gs = get([a.backward_one.remote(ch, i, gs[r])
                          for r, a in enumerate(self.ranks[ch % S])])
        grad_norm, opt_step = self._opt_tail()
        wall = time.perf_counter() - t0
        stats = ray_tpu_torch.get(
            [a.step_stats.remote() for a in self.stages], timeout=60)
        loss = sum(l * n for l, n in losses) / total_n
        return PipelineStepResult(
            loss=loss, n_tokens=total_n, microbatch_losses=losses,
            stage_stats=stats, wall_s=wall, grad_norm=grad_norm,
            step=opt_step)

    # ---------------------------------------------------- checkpoints
    def save_checkpoint(self) -> Dict[str, Any]:
        """Gather per-stage parts and merge them into the canonical
        one-device ``{"params", "opt_state", "step"}`` layout
        (checkpointing is an explicit call, not per-step traffic). Every
        rank is called (a stage mesh gathers its flat moments); each
        stage's part is its rank 0's. The parts' arrays view the object
        store's memory, which is reused once their refs are gone: the
        merge copies them while the refs live."""
        import ray_tpu_torch
        refs = [a.stage_checkpoint.remote() for a in self.stages]
        parts = ray_tpu_torch.get(refs, timeout=self.step_timeout_s)
        out = merge_stage_checkpoints(
            self.config, parts[::self.n_ranks])
        del refs, parts
        return out

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        """Load a canonical train state — saved from ANY
        ``(n_stages, n_virtual)`` layout and stage mesh, or by the
        one-device step — into this pipeline, one stage after another.
        Each part goes into the object store once and every rank of its
        stage reads it from there (an argument passed by value would be
        copied into the call's message and out of it again)."""
        import ray_tpu_torch
        parts = split_train_state(self.config, state, self.n_stages,
                                  self.n_virtual)
        for row, p in zip(self.ranks, parts):
            ref = ray_tpu_torch.put(p)
            ray_tpu_torch.get([a.load_state.remote(ref) for a in row],
                              timeout=self.step_timeout_s)
            del ref

    def stream_checkpoint_refs(self, timeout_s: Optional[float] = None
                               ) -> List[List[Any]]:
        """Per-stage block-ref lists from
        :meth:`PipelineStage.stream_checkpoint` (each stage's rank 0
        streams; its other ranks join the flat moments' gather), gathered
        over the streaming layer with a bounded overall deadline. The
        blocks are whole, so the refs can be forwarded straight into the
        ``load_state_blocks`` calls of every rank of another pipeline's
        stage (worker-to-worker byte movement), whatever its stage mesh,
        or fetched and merged via :func:`merge_stage_checkpoints`. A
        stage actor dying mid-stream surfaces the streaming layer's
        typed error here — never a hang."""
        from ray_tpu_torch.core import streaming

        timeout_s = timeout_s if timeout_s is not None \
            else self.step_timeout_s
        gens = [a.stream_checkpoint.options(
            num_returns="streaming").remote() for a in self.stages]
        blocks: List[List[Any]] = [[] for _ in self.ranks]
        by_gen = {id(g): j for j, g in enumerate(gens)}
        active = list(gens)
        deadline = time.monotonic() + timeout_s
        try:
            while active:
                ready, _ = streaming.wait_any(
                    active,
                    timeout=max(deadline - time.monotonic(), 0.0))
                if not ready:
                    raise TimeoutError(
                        f"checkpoint stream stalled: no stage produced "
                        f"a block within {timeout_s}s")
                for g in ready:
                    try:
                        ref = g.next_ref(timeout=1.0)
                    except StopIteration:
                        active.remove(g)
                        continue
                    blocks[by_gen[id(g)] // self.n_ranks].append(ref)
        except BaseException:
            for g in gens:
                try:
                    g.close()
                except Exception:
                    pass
            raise
        return blocks

    def save_checkpoint_streaming(self,
                                  timeout_s: Optional[float] = None,
                                  refs: Optional[List[List[Any]]] = None
                                  ) -> Dict[str, Any]:
        """The canonical checkpoint via the streaming gather — same
        result as :meth:`save_checkpoint`, but each stage's state
        arrives as per-chunk blocks (exactly-once stream items) instead
        of one monolithic unary return. Pass ``refs`` from an earlier
        :meth:`stream_checkpoint_refs` call to merge without streaming
        the stages a second time."""
        import ray_tpu_torch

        timeout_s = timeout_s if timeout_s is not None \
            else self.step_timeout_s
        if refs is None:
            refs = self.stream_checkpoint_refs(timeout_s)
        parts = []
        for stage_refs in refs:
            items = ray_tpu_torch.get(stage_refs, timeout=timeout_s)
            part: Dict[str, Any] = {"chunks": {}}
            for b in items:
                if b.get("block") == "params":
                    part["chunks"][int(b["chunk"])] = b["params"]
                else:
                    part.update(
                        stage=b["stage"], n_stages=b["n_stages"],
                        n_virtual=b["n_virtual"],
                        opt_state=b.get("opt_state"),
                        step=b.get("step", 0))
            parts.append(part)
        return merge_stage_checkpoints(self.config, parts)

    # -------------------------------------------------------- cleanup
    def abort(self) -> None:
        """Quiesce every stage: unblock pending mailbox takes with a
        typed error and drain queued items, waiting (bounded) for the
        acks. After this the stages are idle and immediately
        reusable."""
        self._cleanup([])

    def _cleanup(self, gens) -> None:
        """Failure path: unblock + drain every stage mailbox, then
        drop all stream state — typed error out, no hang, no leaked
        stream refs. The abort acks are awaited (bounded, dead actors
        skipped) so a fire-and-forget abort cannot land inside the
        NEXT step's freshly-started ``run`` and kill it spuriously. A
        rank blocked in its stage group's collective on a dead peer
        fails there (the peer's sockets close), or goes down with
        :meth:`shutdown`."""
        import ray_tpu_torch
        refs = []
        for a in self.stages:
            try:
                refs.append(a.abort.remote())
            except Exception:
                pass
        for g in gens:
            try:
                g.close()
            except Exception:
                pass
        for r in refs:
            try:
                ray_tpu_torch.get(r, timeout=5.0)
            except Exception:
                pass

    def grads(self, timeout: float = 120.0):
        """Per-stage accumulated parameter-gradient trees (host numpy
        of their own; a stage mesh's reduced gradients), keyed by global
        chunk id; with ``n_virtual == 1`` each stage's single chunk tree
        is returned bare."""
        import ray_tpu_torch
        refs = [a.get_grads.remote() for a in self.stages]
        parts = [tree_map(np.copy, p) for p in ray_tpu_torch.get(
            refs, timeout=timeout)[::self.n_ranks]]
        del refs
        if self.n_virtual == 1:
            return [p[s] for s, p in enumerate(parts)]
        return parts

    def shutdown(self) -> None:
        import ray_tpu_torch
        for a in self.stages:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
