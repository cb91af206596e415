"""Elastic preemption-surviving training: drain → re-lower → resume.
The port's copy of ``ray_tpu/parallel/elastic.py``.

Slices come and go — maintenance windows, spot preemption,
stockouts — and the paper's production claim is that the framework, not
the user, absorbs it. This module closes that loop over the pieces the
earlier subsystems built separately: SliceManager draining (provider
maintenance notices → ``DrainNotice`` callbacks), gang placement-group
rescheduling, the MPMD pipeline's per-stage in-memory checkpoints, and
``split_train_state``'s ANY-(S, v, dp) checkpoint re-slicing.

:class:`ElasticTrainer` wraps any :class:`~ray_tpu_torch.parallel.plan.
ParallelPlan` ``TrainProgram`` and survives slice loss live:

1. **quiesce + snapshot** — on a drain notice (graceful path) the
   in-flight step has already completed (notices are consumed at step
   boundaries); the trainer aborts the stage mailboxes (bounded acks,
   queues drained) and snapshots per-stage state **in memory** via
   ``PipelineStage.stream_checkpoint`` — host-copied param chunks and
   canonicalized optimizer state as exactly-once stream blocks, no
   disk round-trip. On a hard mid-step failure (typed actor/stream
   errors) the live state is suspect, so recovery falls back to the
   last periodic snapshot plus the replay buffer.
2. **re-lower** — the plan is rebuilt onto the surviving capacity:
   same grid when another slice is (or will be) available (the drained
   slice's placement group is already RESCHEDULING), else down the
   fold ladder — shrink ``dp``, fold pipeline stages into more virtual
   chunks (``pp/2 × 2v`` keeps the chunk count), and finally collapse
   to the single-program SPMD lowering. Checkpoints are
   lowering-independent, so any rung reloads exactly. The old program
   is shut down before the new one is built (the JAX package builds the
   new one first): the actors of one host share its cards in fractions,
   so the new ones fit only once the old ones are gone.
3. **reload + resume** — on a same-grid rebuild (the same ``pp``,
   ``virtual`` and ``shard_weight_update``) the streamed block REFS are
   forwarded straight into the new stage actors' ``load_state_blocks``
   (bytes move peer-to-peer over the reliable layer, never through the
   driver); the blocks are whole (params and moments param-shaped), so
   every rank of a stage's new mesh loads its stage's blocks whatever
   its ``dp * fsdp`` (a flat-update rank re-slices the moments into its
   own chunk), and a dp fold keeps this path. Across layouts the driver
   merges
   (:func:`~ray_tpu_torch.parallel.mpmd_pipeline.merge_stage_checkpoints`)
   and the new program re-slices on load. Rolled-back steps are
   re-executed from the replay buffer, so the loss trajectory is
   **exactly** the uninterrupted one, step for step.

Steps-lost math: with ``snapshot_interval=1`` the replay buffer holds
at most the current batch, so a graceful drain loses 0 steps and a
hard kill re-executes exactly 1 (the in-flight step). Interval ``k``
bounds the loss at ``k`` for a kill, amortizing the per-step snapshot
gather.

Recovery emits ``ELASTIC_NOTICE`` / ``ELASTIC_SNAPSHOT`` /
``ELASTIC_RELOWER`` / ``ELASTIC_RESUME`` flight-recorder events
(``core/events.py``); ``ELASTIC_RESUME`` carries ``dur_s`` = the full
notice-to-resume window, so ``tools/timeline.py`` renders the recovery
as a duration slice — the preemption postmortem. ``chip_smoke.py``'s
EL1 phase measures each recovery's snapshot, re-lowering and total
seconds, its steps lost and the post-recovery trajectory on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.parallel.plan import (ParallelPlan, PlanStepResult,
                                   TrainProgram)

logger = logging.getLogger(__name__)

__all__ = ["ElasticTrainer", "ElasticError", "ElasticSnapshotError",
           "ElasticRecoveryError", "RecoveryReport", "fold_plan"]


class ElasticError(RayTpuError):
    """Base for elastic-training failures."""


class ElasticSnapshotError(ElasticError):
    """The in-memory state gather failed (e.g. a stage actor died
    mid-``stage_checkpoint``) — always typed and bounded, never a
    hang; the underlying cause is chained."""


class ElasticRecoveryError(ElasticError):
    """Recovery was attempted ``max_recoveries`` times and the step
    still cannot complete — the cluster is beyond what re-lowering can
    absorb."""


def fold_plan(plan: ParallelPlan) -> Optional[ParallelPlan]:
    """The next rung down the re-lowering ladder when capacity shrank:
    halve ``dp`` first (cheapest — data parallelism is pure
    replication), then fold pipeline stages into more virtual chunks
    per surviving stage (``pp/2 × 2v`` keeps the chunk count, so the
    layer split is unchanged), and finally collapse to the
    single-program SPMD lowering. Returns None when the plan is
    already minimal."""
    if plan.dp > 1:
        return dataclasses.replace(plan, dp=max(1, plan.dp // 2))
    if plan.pp >= 2:
        if plan.pp // 2 >= 2:
            return dataclasses.replace(plan, pp=plan.pp // 2,
                                       virtual=plan.virtual * 2)
        return dataclasses.replace(plan, pp=1, virtual=1)
    if plan.fsdp > 1:
        return dataclasses.replace(plan, fsdp=max(1, plan.fsdp // 2))
    return None


@dataclasses.dataclass
class RecoveryReport:
    """One completed recovery, in order: what triggered it, which plan
    it landed on, and what it cost."""
    trigger: str          # "notice" | "failure" | "regrow"
    reason: str
    from_plan: str
    to_plan: str
    steps_lost: int
    live_snapshot: bool
    snapshot_s: float
    relower_s: float
    total_s: float
    step: int

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _recorder():
    try:
        from ray_tpu_torch.core.global_state import try_global_worker
        w = try_global_worker()
        return w.recorder if w is not None else None
    except Exception:
        return None


def _is_recoverable(exc: BaseException) -> bool:
    """Failures the elastic loop absorbs: every typed framework error
    (actor death, delivery failure, lost objects, rpc/get timeouts),
    plain timeouts (pipeline stall / mailbox starvation), and the
    stage-abort RuntimeError. Anything else — a genuine bug, a
    ValueError from a bad batch — propagates untouched."""
    if isinstance(exc, ElasticError):
        return False
    if isinstance(exc, (RayTpuError, TimeoutError)):
        return True
    if isinstance(exc, RuntimeError) and "abort" in str(exc):
        return True
    return False


class ElasticTrainer(TrainProgram):
    """A ``TrainProgram`` that survives slice loss (module docstring).

    Wraps ``plan.build(config, ...)`` and exposes the same
    step/checkpoint/shutdown surface; ``slice_manager`` (optional)
    wires provider maintenance notices in via
    :meth:`~ray_tpu_torch.autoscaler.slices.SliceManager.register_on_drain`.
    ``slice_filter`` (a ``slice_id -> bool`` predicate) scopes the
    trainer to the slices it OWNS on a shared train+serve pool: drain
    notices for foreign slices are ignored and capacity/regrow
    decisions count only owned slices — without it, a colocated serve
    fleet's UP slice would convince a preempted trainer it still has
    capacity. Every build kwarg (``actor_options``, ``step_timeout_s``,
    ``placement_bundle``, ...) is forwarded to each (re-)lowering."""

    def __init__(self, plan: ParallelPlan, config, *,
                 learning_rate: float = 1e-5,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = 1.0,
                 seed: int = 0,
                 slice_manager=None,
                 slice_filter=None,
                 snapshot_interval: int = 1,
                 snapshot_timeout_s: float = 60.0,
                 max_recoveries: int = 8,
                 auto_regrow: bool = True,
                 **build_kwargs):
        if snapshot_interval < 1:
            raise ValueError(
                f"snapshot_interval must be >= 1, got "
                f"{snapshot_interval}")
        self.target_plan = plan
        self.plan = plan
        self.config = config
        self.slice_manager = slice_manager
        self.slice_filter = slice_filter
        self.snapshot_interval = snapshot_interval
        self.snapshot_timeout_s = snapshot_timeout_s
        self.max_recoveries = max_recoveries
        self.auto_regrow = auto_regrow
        self._build_kwargs = dict(build_kwargs)
        self._build_kwargs.update(
            learning_rate=learning_rate, weight_decay=weight_decay,
            clip_norm=clip_norm, seed=seed)
        self._lock = threading.Lock()
        self._notices: collections.deque = collections.deque()
        self._registered = False
        self.recoveries: List[RecoveryReport] = []
        self.steps_lost_total = 0
        self._step_index = 0
        self._replay: List[Dict[str, Any]] = []
        self.program = self._build(plan)
        # step-0 snapshot: recovery is possible before the first step
        self._snapshot = self.program.save_checkpoint()
        self._snapshot_step = 0
        if slice_manager is not None:
            slice_manager.register_on_drain(self._on_drain)
            self._registered = True

    # ------------------------------------------------------- plumbing
    @property
    def lowering(self) -> str:
        return self.plan.lowering

    def _build(self, plan: ParallelPlan) -> TrainProgram:
        return plan.build(self.config, **self._build_kwargs)

    def _on_drain(self, notice) -> None:
        """SliceManager callback — may run on the monitor thread, so
        it only enqueues; the notice is consumed at the next step
        boundary (the quiesce point). A foreign slice's drain (e.g.
        the colocated serve fleet shrinking) is not our loss."""
        if self.slice_filter is not None and \
                not self.slice_filter(notice.slice_id):
            return
        with self._lock:
            self._notices.append(notice)

    def _owned(self, slice_id) -> bool:
        return self.slice_filter is None or self.slice_filter(slice_id)

    def _pop_notices(self) -> List[Any]:
        with self._lock:
            out = list(self._notices)
            self._notices.clear()
        return out

    def _capacity(self) -> Optional[int]:
        """Usable OWNED slices by the manager's books (None without a
        manager): REQUESTED/UP and not draining."""
        if self.slice_manager is None:
            return None
        from ray_tpu_torch.autoscaler.slices import REQUESTED, UP
        return sum(1 for sid, s in self.slice_manager.slices.items()
                   if s.state in (REQUESTED, UP) and self._owned(sid))

    def _choose_plan(self, slice_lost: bool) -> ParallelPlan:
        cap = self._capacity()
        if not slice_lost:
            return self.plan
        if cap is not None and cap >= 1:
            # another slice is up or coming — the rescheduled gang
            # lands there; keep the grid
            return self.plan
        return fold_plan(self.plan) or self.plan

    # ------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """In-memory canonical snapshot of the live program state —
        streamed per-chunk from the stage actors for pipeline
        lowerings, a host copy for SPMD. Updates the recovery point
        and clears the replay buffer. Raises
        :class:`ElasticSnapshotError` (typed, deadline-bounded — never
        a hang) when the gather fails, e.g. a stage actor killed
        mid-``stage_checkpoint``."""
        try:
            pipeline = getattr(self.program, "pipeline", None)
            if pipeline is not None:
                state = pipeline.save_checkpoint_streaming(
                    timeout_s=self.snapshot_timeout_s)
            else:
                state = self.program.save_checkpoint()
        except Exception as e:
            raise ElasticSnapshotError(
                f"elastic snapshot failed at step {self._step_index}: "
                f"{type(e).__name__}: {e}") from e
        self._snapshot = state
        self._snapshot_step = self._step_index
        self._replay = []
        return state

    # ----------------------------------------------------------- step
    def step(self, batch: Dict[str, Any]) -> PlanStepResult:
        attempts = 0
        while True:
            try:
                self._handle_notices()
                self._maybe_regrow()
                res = self.program.step(batch)
                break
            except Exception as e:
                if not _is_recoverable(e):
                    raise
                attempts += 1
                if attempts > self.max_recoveries:
                    raise ElasticRecoveryError(
                        f"step {self._step_index + 1} still failing "
                        f"after {self.max_recoveries} recovery "
                        f"attempts") from e
                # the message, not the error: a handler that keeps
                # records would keep the error's frames, and this trainer
                logger.warning(
                    "elastic: step %d failed (%s: %s) — recovering "
                    "(attempt %d/%d)", self._step_index + 1,
                    type(e).__name__, str(e), attempts, self.max_recoveries)
                self._recover_failure(e)
        self._step_index += 1
        self._replay.append(batch)
        if len(self._replay) >= self.snapshot_interval:
            try:
                self.snapshot()
            except ElasticSnapshotError:
                # the step itself succeeded; keep the replay buffer
                # and let the NEXT step's failure path recover
                logger.warning(
                    "elastic: periodic snapshot failed at step %d — "
                    "keeping %d-step replay buffer",
                    self._step_index, len(self._replay))
        return res

    def _handle_notices(self) -> None:
        notices = self._pop_notices()
        if not notices:
            return
        reason = ",".join(
            f"{getattr(n, 'slice_id', '?')}:"
            f"{getattr(n, 'reason', 'drain')}" for n in notices)
        rec = _recorder()
        if rec is not None:
            from ray_tpu_torch.core.events import ELASTIC_NOTICE
            for n in notices:
                rec.record(ELASTIC_NOTICE,
                           slice=getattr(n, "slice_id", None),
                           reason=getattr(n, "reason", None))
        new_plan = self._choose_plan(slice_lost=True)
        self._relower(new_plan, trigger="notice", reason=reason,
                      live=True)

    def _maybe_regrow(self) -> None:
        if not self.auto_regrow or self.slice_manager is None:
            return
        if self.plan == self.target_plan:
            return
        from ray_tpu_torch.autoscaler.slices import UP
        cap = sum(1 for sid, s in self.slice_manager.slices.items()
                  if s.state == UP and self._owned(sid))
        if cap >= 1:
            self.regrow()

    def regrow(self, plan: Optional[ParallelPlan] = None
               ) -> Optional[RecoveryReport]:
        """Grow the grid back (scale-up): re-lower onto ``plan`` (the
        original target by default) from a live snapshot. No-op when
        already there."""
        target = plan or self.target_plan
        if target == self.plan:
            return None
        self._relower(target, trigger="regrow",
                      reason="capacity-restored", live=True)
        return self.recoveries[-1]

    def _recover_failure(self, exc: BaseException) -> None:
        """Hard mid-step failure: quiesce what survives, let the
        SliceManager observe the damage (dead hosts → drain →
        notices), then re-lower from the last periodic snapshot and
        replay."""
        if self.slice_manager is not None:
            try:
                self.slice_manager.update()
            except Exception:
                logger.exception("elastic: slice manager update failed "
                                 "during recovery")
        notices = self._pop_notices()
        rec = _recorder()
        if rec is not None and notices:
            from ray_tpu_torch.core.events import ELASTIC_NOTICE
            for n in notices:
                rec.record(ELASTIC_NOTICE,
                           slice=getattr(n, "slice_id", None),
                           reason=getattr(n, "reason", None))
        pipeline = getattr(self.program, "pipeline", None)
        if pipeline is not None:
            try:
                pipeline.abort()
            except Exception:
                pass
        new_plan = self._choose_plan(slice_lost=bool(notices))
        self._relower(new_plan, trigger="failure",
                      reason=f"{type(exc).__name__}", live=False,
                      failed_step=True)

    # -------------------------------------------------------- relower
    def _relower(self, new_plan: ParallelPlan, *, trigger: str,
                 reason: str, live: bool,
                 failed_step: bool = False) -> None:
        """The drain → re-lower → resume core: snapshot (live when
        trusted), tear the old program down, build the new one, reload
        (peer-to-peer block refs on a same-grid rebuild), replay
        rolled-back steps, and record the recovery window."""
        import ray_tpu_torch
        from ray_tpu_torch.core.events import (ELASTIC_RELOWER,
                                         ELASTIC_RESUME,
                                         ELASTIC_SNAPSHOT)

        t0 = time.perf_counter()
        rec = _recorder()
        old_program = self.program
        old_pipeline = getattr(old_program, "pipeline", None)
        state = None
        refs = None
        snap_s = 0.0
        if live:
            t_s = time.perf_counter()
            try:
                if old_pipeline is not None:
                    # quiesce: unblock + drain every stage mailbox
                    # (bounded acks), then stream the state out
                    old_pipeline.abort()
                    refs = old_pipeline.stream_checkpoint_refs(
                        self.snapshot_timeout_s)
                    state = old_pipeline.save_checkpoint_streaming(
                        timeout_s=self.snapshot_timeout_s, refs=refs)
                else:
                    state = old_program.save_checkpoint()
            except Exception:
                logger.exception(
                    "elastic: live snapshot failed — falling back to "
                    "the step-%d periodic snapshot", self._snapshot_step)
                state, refs = None, None
            snap_s = time.perf_counter() - t_s
            if rec is not None:
                rec.record(ELASTIC_SNAPSHOT, dur_s=round(snap_s, 6),
                           live=state is not None)

        steps_lost = 0
        if state is not None:
            self._snapshot = state
            self._snapshot_step = self._step_index
            self._replay = []
        else:
            state = self._snapshot
            steps_lost = len(self._replay)
        if failed_step:
            steps_lost += 1

        t_r = time.perf_counter()
        from_desc = self.plan.describe()
        # the old program goes down BEFORE the new one is built (the JAX
        # package builds first): a host's cards are shared out to the
        # actors in fractions, and the new actors' shares fit only once
        # the old ones gave theirs back. The snapshot is already safe:
        # the merged state lives in this process and the streamed blocks
        # in the object store, both outliving their producers.
        try:
            old_program.shutdown()
        except Exception:
            pass
        program = self._build(new_plan)
        new_pipeline = getattr(program, "pipeline", None)
        same_grid = (
            refs is not None and new_pipeline is not None
            and (new_plan.pp, new_plan.virtual,
                 new_plan.shard_weight_update)
            == (self.plan.pp, self.plan.virtual,
                self.plan.shard_weight_update))
        loaded = False
        if same_grid:
            # peer-to-peer reload: forward the streamed block refs
            # into every rank of the new stage actors — the bytes pull
            # worker-to-worker, the driver never re-serializes them
            try:
                ray_tpu_torch.get(
                    [a.load_state_blocks.remote(*stage_refs)
                     for row, stage_refs in zip(new_pipeline.ranks, refs)
                     for a in row],
                    timeout=self.snapshot_timeout_s)
                loaded = True
            except Exception:
                logger.exception(
                    "elastic: peer-to-peer block reload failed — "
                    "falling back to the driver-merged state")
        if not loaded:
            program.load_checkpoint(state)
        relower_s = time.perf_counter() - t_r
        self.program = program
        self.plan = new_plan
        if rec is not None:
            rec.record(ELASTIC_RELOWER, from_plan=from_desc,
                       to_plan=new_plan.describe(),
                       dur_s=round(relower_s, 6))

        replayed = list(self._replay)
        for b in replayed:
            # re-execute rolled-back steps: deterministic programs +
            # identical state ⇒ the exact original trajectory. A
            # failure here propagates to the step() retry loop with
            # snapshot and replay buffer intact.
            self.program.step(b)
        if replayed:
            self._snapshot = self.program.save_checkpoint()
            self._snapshot_step = self._step_index
            self._replay = []

        total_s = time.perf_counter() - t0
        report = RecoveryReport(
            trigger=trigger, reason=reason, from_plan=from_desc,
            to_plan=new_plan.describe(), steps_lost=steps_lost,
            live_snapshot=refs is not None or (live and not steps_lost),
            snapshot_s=round(snap_s, 6), relower_s=round(relower_s, 6),
            total_s=round(total_s, 6), step=self._step_index)
        self.recoveries.append(report)
        self.steps_lost_total += steps_lost
        if rec is not None:
            rec.record(ELASTIC_RESUME, dur_s=round(total_s, 6),
                       steps_lost=steps_lost, trigger=trigger,
                       to_plan=new_plan.describe())
            try:
                rec.maybe_flush()
            except Exception:
                pass
        logger.warning(
            "elastic: %s recovery complete in %.2fs — %s -> %s, "
            "%d step(s) re-executed", trigger, total_s, from_desc,
            report.to_plan, steps_lost)

    # ----------------------------------------------------- checkpoint
    def save_checkpoint(self) -> Dict[str, Any]:
        return self.program.save_checkpoint()

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        self.program.load_checkpoint(state)
        self._snapshot = state
        self._step_index = int(state.get("step", 0))
        self._snapshot_step = self._step_index
        self._replay = []

    # ---------------------------------------------------------- views
    def stats(self) -> Dict[str, Any]:
        return {
            "active_plan": self.plan.describe(),
            "target_plan": self.target_plan.describe(),
            "lowering": self.plan.lowering,
            "step": self._step_index,
            "snapshot_step": self._snapshot_step,
            "recoveries": [r.asdict() for r in self.recoveries],
            "steps_lost_total": self.steps_lost_total,
        }

    def shutdown(self) -> None:
        """Shut the program down and drop the recovery point: the
        snapshot's arrays may view the object store's shared memory, and
        the replay buffer holds the batches since it was taken."""
        if self._registered and self.slice_manager is not None:
            try:
                self.slice_manager.unregister_on_drain(self._on_drain)
            except Exception:
                pass
            self._registered = False
        self._snapshot = None
        self._replay = []
        try:
            self.program.shutdown()
        except Exception:
            pass
