"""MPMD pipeline parallelism: actor-hosted stages, streamed activations,
interleaved virtual stages, a per-stage optimizer step. The port of
``ray_tpu/parallel/mpmd_pipeline.py`` with one device a stage.

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

Activations and their gradients cross stages in the compute dtype
(``config.dtype``), as the JAX ``stage_forward`` returns them; on the
card a tensor crosses through the object store (a copy to the host, the
shared-memory write, a copy to the receiving stage's device, done on its
compute thread).

Every forward, backward, optimizer and idle interval is a
``STAGE_TICK`` flight-recorder event labelled with its phase and chunk,
and :meth:`PipelineStage.step_stats` returns the measured busy/idle split
and the hops' bytes and seconds.

Checkpoints: :meth:`PipelineStage.stage_checkpoint` returns the stage's
params and Adam moments keyed by global chunk id (numpy);
:func:`merge_stage_checkpoints` reassembles the canonical one-device
train state of ``models.training.make_train_step``, ``{"params",
"opt_state": {"count", "mu", "nu"}, "step"}``, and
:func:`split_train_state` slices it for any ``(n_stages, n_virtual)``: a
checkpoint saved at v=2 reloads at v=1, and into the one-device step.

A dp x fsdp mesh inside each stage (the JAX ``mpmd3d`` lowering:
``dp``, ``fsdp``, ``stage_mesh``, int8 gradient transport and the
sharded update on a stage) is ROADMAP Queue 1 item 9 and raises.
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
from ray_tpu_torch.models.training import (ClipAdamW, _paths, tree_leaves,
                                           tree_map)
from ray_tpu_torch.models.transformer import (init_leaves,
                                              merge_stage_params, set_leaf,
                                              stage_forward,
                                              stage_layer_ranges, stage_loss,
                                              stage_slice_params)

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


def _check_stage_grid(dp: int, fsdp: int, grad_transport: str,
                      shard_weight_update: bool,
                      stage_mesh: Optional[bool]) -> None:
    """The one-device stage is ported; a mesh inside a stage is not."""
    if dp < 1 or fsdp < 1:
        raise ValueError(f"dp/fsdp must be >= 1, got {dp}/{fsdp}")
    if grad_transport not in ("fp32", "int8"):
        raise ValueError(f"grad_transport must be 'fp32' or 'int8', "
                         f"got {grad_transport!r}")
    if dp * fsdp > 1 or stage_mesh or grad_transport != "fp32" \
            or shard_weight_update:
        raise NotImplementedError(
            "a dp x fsdp mesh inside each pipeline stage (the mpmd3d "
            "lowering: dp, fsdp, stage_mesh, int8 gradient transport and "
            "the sharded update on a stage) is ROADMAP Queue 1 item 9, "
            "not ported yet; the port's stages hold one device each")


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
    """One pipeline stage: in-process, or hosted in its own actor.

    Holds the stage's ``n_virtual`` parameter chunks (f32 masters) on its
    device, the autograd graphs of the forwards whose backwards have not
    run, the accumulated parameter gradients and, with ``train=True``,
    its ``ClipAdamW`` state. Activations and gradients arrive through
    mailboxes keyed by ``(chunk, microbatch)`` (:meth:`feed`,
    :meth:`put_activation`, :meth:`put_grad`, :meth:`put_targets`), and
    one streaming :meth:`run` call a step yields the stage's per-op
    outputs in its deterministic interleaved-1F1B order.

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
                 stage_mesh: Optional[bool] = None):
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.serve.llm_engine import _server_device

        _check_stage_grid(dp, fsdp, grad_transport, shard_weight_update,
                          stage_mesh)
        if remat_policy is not None:
            config = dataclasses.replace(config, remat=None,
                                         remat_policy=remat_policy)
        self.config = config
        self.stage = stage
        self.n_stages = n_stages
        self.n_virtual = n_virtual
        self.n_chunks = n_stages * n_virtual
        self.chunks = stage_virtual_chunks(stage, n_stages, n_virtual)
        #: seconds a mailbox take may starve before the stage fails
        #: typed (a dead neighbour must surface as an error, never a
        #: hang) — config.pipeline_mailbox_deadline_s unless overridden
        self.mailbox_deadline_s = float(
            mailbox_deadline_s if mailbox_deadline_s is not None
            else get_config().pipeline_mailbox_deadline_s)
        self.device = _server_device(device)
        self.cuda = self.device.type == "cuda"
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
            self.opt_state = self.optimizer.init(self.params)
        self._step_count = 0
        self._cond = threading.Condition()
        self._acts: Dict[Tuple[int, int], Any] = {}
        self._grads_in: Dict[Tuple[int, int], Any] = {}
        self._targets: Dict[int, Any] = {}
        self._abort = False
        #: (chunk, microbatch) -> (output, received input) of a forward
        #: whose backward has not run: the graph JAX keeps as a vjp
        self._saved: Dict[Tuple[int, int], Any] = {}
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
                "to_device_s": 0.0}

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
        needs."""
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
            self._saved[(ch, i)] = (loss, xin)
            return {"loss": loss.item(), "n_tokens": float(n)}
        self._saved[(ch, i)] = (h, xin)
        self._sync()
        return h.detach()

    def _bwd_op(self, ch: int, i: int, g):
        """One backward op: accumulates this chunk's parameter gradients
        (f32, in the params' ``.grad``) and returns the upstream input
        gradient in the compute dtype (None on chunk 0). The last chunk's
        ``g`` is its loss seed, ``n_i / N``."""
        out, xin = self._saved.pop((ch, i))
        if ch == self.n_chunks - 1:
            g = torch.tensor(float(g), dtype=out.dtype, device=self.device)
        else:
            g = self._on_device(g, out.dtype)
        torch.autograd.backward(out, g)
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

    def _require_grads(self) -> None:
        missing = [c for c in self.chunks
                   if any(p.grad is None
                          for p in tree_leaves(self.params[c]))]
        if missing:
            raise RuntimeError(
                f"stage {self.stage}: no accumulated grads for chunks "
                f"{missing} (run a step first)")

    def grad_sq_norm(self) -> float:
        """Squared L2 norm of this stage's accumulated f32 gradients —
        the stage's share of the global clip norm (one f32 scalar, the
        only gradient-derived value that reaches the driver in train
        mode)."""
        self._require_grads()
        with torch.no_grad():
            sq = torch.stack([g.float().square().sum()
                              for g in self._chunk_grads()]).sum()
        return float(sq)

    def apply_opt(self, global_sq_norm: float) -> Dict[str, float]:
        """The stage's optimizer step: ``ClipAdamW.update`` on its
        params with the gradients scaled by the clip of the global norm
        ``sqrt(global_sq_norm)`` (the sum of every stage's
        :meth:`grad_sq_norm`). Gradients, params and optimizer state
        never leave the stage; returns scalar metrics."""
        if self.optimizer is None:
            raise RuntimeError("stage built with train=False has no "
                               "optimizer (pass train=True)")
        self._require_grads()
        t0 = time.perf_counter()
        norm = torch.tensor(global_sq_norm, dtype=torch.float32,
                            device=self.device).sqrt()
        self.optimizer.update(self._chunk_grads(), self.opt_state,
                              tree_leaves(self.params), norm,
                              _paths(self.params))
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
        if self.opt_state is None:
            return None
        return {"count": int(self.opt_state["count"]),
                "mu": to_numpy(self.opt_state["mu"]),
                "nu": to_numpy(self.opt_state["nu"])}

    def stage_checkpoint(self) -> Dict[str, Any]:
        """Host (numpy) copy of the stage's train state, keyed by global
        chunk id — :func:`merge_stage_checkpoints` reassembles the
        canonical one-device layout from all stages' parts."""
        return {"stage": self.stage, "n_stages": self.n_stages,
                "n_virtual": self.n_virtual,
                "chunks": {c: to_numpy(p) for c, p in self.params.items()},
                "opt_state": self._opt_numpy(), "step": self._step_count}

    def load_state(self, part: Dict[str, Any]) -> None:
        """Load one part from :func:`split_train_state` (params keyed
        by this stage's chunk ids, opt state in the stage layout)."""
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
        opt = part.get("opt_state")
        if opt is not None:
            if self.optimizer is None:
                raise RuntimeError("cannot load optimizer state into a "
                                   "train=False stage")
            self.opt_state = {
                "count": torch.tensor(int(opt["count"]), dtype=torch.int32,
                                      device=self.device),
                **{n: {c: _to_tensors(opt[n][c], self.device)
                       for c in self.chunks} for n in ("mu", "nu")}}
        self._step_count = int(part.get("step", 0))

    def stream_checkpoint(self):
        """:meth:`stage_checkpoint` as a stream: one block per param
        chunk, then one meta block carrying the opt state and step
        count. Each block is its own stream item (exactly-once over the
        reliable layer), so the driver can forward a chunk's ref to its
        new owner while later chunks are still being copied, and the
        bytes move worker to worker (:meth:`load_state_blocks`)."""
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
        st["chunks"] = list(self.chunks)
        return st

    def get_grads(self):
        """Host (numpy) copy of the accumulated parameter gradients,
        keyed by global chunk id (fwd+bwd mode; in train mode the
        gradients are consumed in the stage by :meth:`apply_opt`)."""
        out = {}
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
    #: per-stage step_stats dicts
    stage_stats: List[Dict[str, float]]
    wall_s: float
    #: global gradient norm (train mode; None for fwd+bwd steps)
    grad_norm: Optional[float] = None
    #: optimizer step count after this step (train mode)
    step: Optional[int] = None

    @property
    def bubble_fraction(self) -> float:
        """Measured bubble: the mean over stages of the fraction of
        the step's wall clock each stage spent NOT computing."""
        if not self.wall_s:
            return 0.0
        fr = [1.0 - min(s["busy_s"] / self.wall_s, 1.0)
              for s in self.stage_stats]
        return sum(fr) / len(fr)


def stage_gpus(n_stages: int) -> float:
    """The ``num_gpus`` each stage actor asks for: a card each where the
    runtime counts at least ``n_stages`` GPUs, ``1/n_stages`` of one
    where it counts fewer (the stages share the card), none where it
    counts none (stages on the CPU platform)."""
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

    ``train=True`` makes ``step`` a full train step: after the streams
    drain, the driver sums the stages' squared gradient norms (one
    scalar a stage), then every stage applies its optimizer step at
    once — gradients, parameters and optimizer state never transit the
    driver. ``save_checkpoint()`` / ``load_checkpoint()`` move the
    canonical one-device state layout in and out (any ``n_virtual``).

    ``serial=True`` drives the same actors chunk by chunk with unary
    calls and full barriers — the no-overlap baseline.

    Stage actors run where :func:`actor_device` puts them (the card
    unless ``device="cpu"``) and ask for ``num_gpus`` as it says
    (``self.stage_gpus``). ``dp``,
    ``fsdp``, ``stage_mesh``, ``grad_transport="int8"`` and
    ``shard_weight_update`` on a stage (the ``mpmd3d`` lowering) are
    ROADMAP Queue 1 item 9 and raise.
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
                 stage_mesh: Optional[bool] = None,
                 placement_group=None):
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
        _check_stage_grid(dp, fsdp, grad_transport, shard_weight_update,
                          stage_mesh)
        self.config = config
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_virtual = n_virtual
        self.n_chunks = n_stages * n_virtual
        self.serial = serial
        self.train = train
        self.placement_group = placement_group
        self.step_timeout_s = step_timeout_s
        # resolve the mailbox deadline on the DRIVER (its config sees
        # _system_config overrides) and ship the value to every stage
        deadline = (mailbox_deadline_s if mailbox_deadline_s is not None
                    else get_config().pipeline_mailbox_deadline_s)
        where, self.stage_gpus = actor_device(device, n_stages)
        opts: Dict[str, Any] = {"max_concurrency": 4, "max_restarts": 0,
                                "num_gpus": self.stage_gpus}
        self.stages = []
        for s in range(n_stages):
            stage_opts = dict(opts)
            if placement_group is not None:
                # one stage actor a bundle of the gang
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
                stage_opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(
                        placement_group,
                        placement_group_bundle_index=s)
            cls = ray_tpu_torch.remote(**stage_opts)(PipelineStage)
            self.stages.append(cls.remote(
                config, s, n_stages, seed=seed, device=where,
                n_virtual=n_virtual, train=train,
                learning_rate=learning_rate,
                weight_decay=weight_decay, clip_norm=clip_norm,
                mailbox_deadline_s=deadline))
        ray_tpu_torch.get([a.ping.remote() for a in self.stages],
                          timeout=300)

    # ---------------------------------------------------------- steps
    def _split(self, batch: Dict[str, Any]):
        ids = np.asarray(batch["input_ids"])
        mask = batch.get("loss_mask")
        mask = np.asarray(mask) if mask is not None else None
        m = self.n_microbatches
        if ids.shape[0] % m:
            raise ValueError(f"batch {ids.shape[0]} not divisible by "
                             f"{m} microbatches")
        ids_mb = np.split(ids, m)
        mask_mb = np.split(mask, m) if mask is not None else [None] * m
        # per-microbatch label-token counts — known to the driver
        # without running the model, so the last chunk's backward seeds
        # (d total / d loss_i = n_i / N) can be fed up front
        ns = [float(mk[:, 1:].sum()) if mk is not None
              else float(i.shape[0] * (i.shape[1] - 1))
              for i, mk in zip(ids_mb, mask_mb)]
        return ids_mb, mask_mb, ns

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
                    peak = chip_spec().bf16_flops * self.n_stages
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
        squared gradient norms (scalars), fan the global value back out,
        and run every stage's optimizer step at once. No gradient or
        parameter bytes through the driver."""
        import ray_tpu_torch

        if not self.train:
            return None, None
        sq = ray_tpu_torch.get(
            [a.grad_sq_norm.remote() for a in self.stages],
            timeout=self.step_timeout_s)
        gsq = float(sum(sq))
        mets = ray_tpu_torch.get([a.apply_opt.remote(gsq)
                                  for a in self.stages],
                                 timeout=self.step_timeout_s)
        return mets[0]["grad_norm"], mets[0]["step"]

    def _step_1f1b(self, batch: Dict[str, Any]) -> PipelineStepResult:
        import ray_tpu_torch
        from ray_tpu_torch.core import streaming

        S, M, v = self.n_stages, self.n_microbatches, self.n_virtual
        K = self.n_chunks
        ids_mb, mask_mb, ns = self._split(batch)
        total_n = sum(ns)
        t0 = time.perf_counter()
        hold = []  # keep routed refs alive until the step completes
        last = self.stages[-1]  # chunk K-1 lives on the last actor
        # batched prefeed: stage 0's token microbatches in one call,
        # the last stage's targets + loss cotangents (scalar n_i / N,
        # known up front) in another — 2 actor calls instead of 3M
        hold.append(self.stages[0].feed.remote(
            acts={(0, i): ids_mb[i] for i in range(M)}))
        hold.append(last.feed.remote(
            targets={i: (ids_mb[i], mask_mb[i]) for i in range(M)},
            grads={(K - 1, i): np.float32(ns[i] / total_n)
                   for i in range(M)}))
        gens = [a.run.options(num_returns="streaming").remote(M)
                for a in self.stages]
        orders = [one_f_one_b_order(s, S, M, v) for s in range(S)]
        cursors = [0] * S
        loss_refs: Dict[int, Any] = {}
        by_gen = {id(g): s for s, g in enumerate(gens)}
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
                    s = by_gen[id(g)]
                    try:
                        ref = g.next_ref(timeout=1.0)
                    except StopIteration:
                        active.remove(g)
                        continue
                    op, i, ch = orders[s][cursors[s]]
                    cursors[s] += 1
                    if op == "F" and ch < K - 1:
                        hold.append(
                            self.stages[(ch + 1) % S]
                            .put_activation.remote(ch + 1, i, ref))
                    elif op == "F":
                        # tiny loss dicts: batch the gets after drain
                        loss_refs[i] = ref
                    elif op == "B" and ch > 0:
                        hold.append(
                            self.stages[(ch - 1) % S]
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
        losses = []
        for i in range(M):
            act = ray_tpu_torch.get(
                self.stages[0].forward_one.remote(0, i, ids_mb[i]),
                timeout=self.step_timeout_s)
            for ch in range(1, K):
                actor = self.stages[ch % S]
                out = actor.forward_one.remote(
                    ch, i, act, ids_mb[i], mask_mb[i]) \
                    if ch == K - 1 else \
                    actor.forward_one.remote(ch, i, act)
                act = ray_tpu_torch.get(out, timeout=self.step_timeout_s)
            losses.append((act["loss"], act["n_tokens"]))
            g: Any = np.float32(ns[i] / total_n)
            for ch in range(K - 1, -1, -1):
                g = ray_tpu_torch.get(
                    self.stages[ch % S].backward_one.remote(ch, i, g),
                    timeout=self.step_timeout_s)
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
        (checkpointing is an explicit call, not per-step traffic). The
        parts' arrays view the object store's memory, which is reused
        once their refs are gone: the merge copies them while the refs
        live."""
        import ray_tpu_torch
        refs = [a.stage_checkpoint.remote() for a in self.stages]
        out = merge_stage_checkpoints(self.config, ray_tpu_torch.get(
            refs, timeout=self.step_timeout_s))
        del refs
        return out

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        """Load a canonical train state — saved from ANY
        ``(n_stages, n_virtual)`` layout, or by the one-device step —
        into this pipeline, one stage after another. Each part goes
        into the object store once and its stage reads it from there (an
        argument passed by value would be copied into the call's message
        and out of it again)."""
        import ray_tpu_torch
        parts = split_train_state(self.config, state, self.n_stages,
                                  self.n_virtual)
        for a, p in zip(self.stages, parts):
            ray_tpu_torch.get(a.load_state.remote(ray_tpu_torch.put(p)),
                              timeout=self.step_timeout_s)

    def stream_checkpoint_refs(self, timeout_s: Optional[float] = None
                               ) -> List[List[Any]]:
        """Per-stage block-ref lists from
        :meth:`PipelineStage.stream_checkpoint`, gathered over the
        streaming layer with a bounded overall deadline. The refs can
        be forwarded straight into another pipeline's
        ``load_state_blocks`` calls (worker-to-worker byte movement) or
        fetched and merged via :func:`merge_stage_checkpoints`. A stage
        actor dying mid-stream surfaces the streaming layer's typed
        error here — never a hang."""
        from ray_tpu_torch.core import streaming

        timeout_s = timeout_s if timeout_s is not None \
            else self.step_timeout_s
        gens = [a.stream_checkpoint.options(
            num_returns="streaming").remote() for a in self.stages]
        blocks: List[List[Any]] = [[] for _ in self.stages]
        by_gen = {id(g): s for s, g in enumerate(gens)}
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
                    blocks[by_gen[id(g)]].append(ref)
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
        NEXT step's freshly-started ``run`` and kill it spuriously."""
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
        of their own), keyed by global chunk id; with ``n_virtual == 1``
        each stage's single chunk tree is returned bare."""
        import ray_tpu_torch
        refs = [a.get_grads.remote() for a in self.stages]
        parts = [tree_map(np.copy, p)
                 for p in ray_tpu_torch.get(refs, timeout=timeout)]
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
