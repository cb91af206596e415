"""TuneController: the trial-driving event loop.

Reference: ``python/ray/tune/execution/tune_controller.py:72`` (``step``
:718) — maintain a population of trial actors, drain their results,
consult searcher + scheduler, enact CONTINUE/STOP decisions, checkpoint,
and restart failed trials. One trial = one ``_TrialActor`` wrapping the
user Trainable; resources come from ``default_resource_request``
(placement-group factory) or a flat CPU bundle, and a trial's ``GPU``
request is its actor's ``num_gpus``. The port of
``ray_tpu/tune/tune_controller.py``, with PBT's ``exploit_trial`` and
the resource-changing scheduler's ``reallocate_trial``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, ActorError, TaskError
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.storage import StorageContext
from ray_tpu_torch.tune import _trial_context
from ray_tpu_torch.tune.experiment import (
    ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial)
from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import (
    DONE, TRAINING_ITERATION, TRIAL_ID, FunctionTrainable, Trainable)


class _TrialActor:
    """The actor hosting one trial's Trainable instance."""

    def __init__(self, trainable_cls, config, pg=None, trial_dir=None):
        if pg is not None:
            _trial_context.set_trial_placement_group(pg)
        if trial_dir:
            _trial_context.set_trial_dir(trial_dir)
        self._t = trainable_cls(config)

    def train(self):
        return self._t.train()

    def save(self, checkpoint_dir=None):
        return self._t.save(checkpoint_dir)

    def restore(self, checkpoint):
        self._t.restore(checkpoint)

    def reset(self, new_config):
        return self._t.reset(new_config)

    def stop(self):
        self._t.stop()


def _as_trainable_cls(trainable) -> type:
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable):
        wrapped = FunctionTrainable.wrap(trainable)
        if hasattr(trainable, "default_resource_request"):
            wrapped.default_resource_request = (
                trainable.default_resource_request)
        return wrapped
    raise TypeError(f"not a trainable: {trainable!r}")


class TuneController:
    def __init__(self, trainable, param_space: Dict,
                 searcher: Optional[Searcher],
                 scheduler: Optional[TrialScheduler],
                 storage: StorageContext,
                 metric: Optional[str], mode: Optional[str],
                 num_samples: int = 1,
                 max_concurrent_trials: Optional[int] = None,
                 stop: Optional[Dict[str, float]] = None,
                 max_failures: int = 0,
                 checkpoint_frequency: int = 0,
                 checkpoint_at_end: bool = True,
                 callbacks: Optional[list] = None):
        self.trainable_cls = _as_trainable_cls(trainable)
        self.param_space = param_space or {}
        self.searcher = searcher or BasicVariantGenerator()
        self.scheduler = scheduler or FIFOScheduler()
        self.storage = storage
        self.metric = metric
        self.mode = mode or "max"
        self.num_samples = num_samples
        self.max_concurrent = max_concurrent_trials or 0
        self.stop_criteria = stop or {}
        self.max_failures = max_failures
        self.checkpoint_frequency = checkpoint_frequency
        self.checkpoint_at_end = checkpoint_at_end
        from ray_tpu_torch.tune.callback import CallbackList
        self.callbacks = CallbackList(callbacks)
        self.callbacks.fire("setup", stop=stop, num_samples=num_samples)
        self._cb_iteration = 0

        self.searcher.set_search_properties(
            metric, self.mode, self.param_space, num_samples=num_samples)
        self.scheduler.set_search_properties(metric, self.mode)

        self.trials: List[Trial] = []
        self._futures: Dict[Any, Trial] = {}
        self._failures: Dict[str, int] = {}
        self._searcher_done = False
        self._trial_counter = 0

    # -- trial bookkeeping -------------------------------------------
    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def is_live(self, trial_id: str) -> bool:
        t = self.get_trial(trial_id)
        return t is not None and t.status in (RUNNING, PAUSED)

    def _trial_limit(self) -> int:
        """Total trials to create: the searcher's own count if it knows
        it (grid x num_samples for BasicVariant), else num_samples —
        bounding never-exhausting searchers like TPE."""
        total = getattr(self.searcher, "total_samples", None)
        return total if total else self.num_samples

    def _next_trial(self) -> Optional[Trial]:
        if self._searcher_done or self._trial_counter >= self._trial_limit():
            return None
        trial_id = f"{self._trial_counter:05d}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            # Permanent exhaustion vs. "ask again later" (e.g. a
            # ConcurrencyLimiter at capacity).
            if self.searcher.is_finished():
                self._searcher_done = True
            return None
        self._trial_counter += 1
        trial = Trial(trial_id, config, self.storage.experiment_name)
        self.trials.append(trial)
        self.scheduler.on_trial_add(self, trial)
        return trial

    def _resource_request(self, config) -> Optional[PlacementGroupFactory]:
        req = getattr(self.trainable_cls, "default_resource_request", None)
        if req is None:
            return None
        factory = req(config)
        return factory if isinstance(factory, PlacementGroupFactory) \
            else None

    def _create_actor(self, trial: Trial, config: Dict, pg):
        """Build the trial's actor, honoring the resource request. With
        an empty head bundle the group holds only worker bundles and the
        trial actor runs outside it (reference tuner semantics)."""
        factory = self._resource_request(config)
        opts: Dict[str, Any] = {"num_cpus": 1.0}
        override = getattr(trial, "resource_override", None)
        if override:
            # ResourceChangingScheduler reallocation (reference:
            # resource_changing_scheduler.py swaps the trial's
            # PlacementGroupFactory): the override wins over the
            # trainable's static request
            opts["num_cpus"] = float(override.get("CPU", 1.0))
            if override.get("GPU"):
                opts["num_gpus"] = float(override["GPU"])
            actor_cls = ray_tpu_torch.remote(**opts)(_TrialActor)
            return actor_cls.remote(
                self.trainable_cls, config, pg,
                self._trial_storage(trial).trial_dir)
        if factory is not None and pg is not None \
                and not factory.head_bundle_is_empty:
            head = factory.bundles[0]
            opts["num_cpus"] = float(head.get("CPU", 0.0))
            if "GPU" in head:
                opts["num_gpus"] = float(head["GPU"])
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy)
            opts["scheduling_strategy"] = (
                PlacementGroupSchedulingStrategy(
                    pg, placement_group_bundle_index=0))
        actor_cls = ray_tpu_torch.remote(**opts)(_TrialActor)
        return actor_cls.remote(
            self.trainable_cls, config, pg,
            self._trial_storage(trial).trial_dir)

    def _start_trial(self, trial: Trial) -> None:
        # a reallocation override replaces the trainable's static
        # request wholesale — reserving the factory's placement group
        # AND the override's CPUs would double-book the cluster
        factory = None if getattr(trial, "resource_override", None) \
            else self._resource_request(trial.config)
        pg = factory() if factory is not None else None
        trial.local_dir = self._trial_storage(trial).trial_dir
        first_start = trial.actor is None and trial.status == PENDING \
            and not getattr(trial, "_started_once", False)
        trial.actor = self._create_actor(trial, trial.config, pg)
        trial._pg = pg
        trial.status = RUNNING
        if first_start:
            trial._started_once = True
            self.callbacks.fire("on_trial_start", self._cb_iteration,
                                self.trials, trial)
        if trial.restore_pending is not None:
            trial.actor.restore.remote(trial.restore_pending)
            trial.restore_pending = None
        self._submit_train(trial)

    def _submit_train(self, trial: Trial) -> None:
        fut = trial.actor.train.remote()
        self._futures[fut] = trial

    def _trial_storage(self, trial: Trial) -> StorageContext:
        s = StorageContext(self.storage.storage_path,
                           self.storage.experiment_name,
                           trial_dir_name=f"trial_{trial.trial_id}")
        s.current_checkpoint_index = trial.iteration
        return s

    def _save_trial_checkpoint(self, trial: Trial) -> Optional[Checkpoint]:
        if trial.actor is None:
            return trial.checkpoint
        s = self._trial_storage(trial)
        dest = s.checkpoint_dir(trial.iteration)
        try:
            ckpt = ray_tpu_torch.get(trial.actor.save.remote(dest))
        except (TaskError, ActorError, ActorDiedError):
            return trial.checkpoint
        if ckpt is not None:
            trial.checkpoint = ckpt
            self.callbacks.fire("on_checkpoint", self._cb_iteration,
                                self.trials, trial, ckpt)
        return trial.checkpoint

    def _release_trial_resources(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                trial.actor.stop.remote()
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        pg = getattr(trial, "_pg", None)
        if pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group
            try:
                remove_placement_group(pg)
            except Exception:
                pass
            trial._pg = None

    def _stop_trial(self, trial: Trial, status: str,
                    error: Optional[BaseException] = None) -> None:
        trial.status = status
        trial.error = error
        if trial.actor is not None and status == TERMINATED \
                and self.checkpoint_at_end:
            self._save_trial_checkpoint(trial)
        self._release_trial_resources(trial)
        self.searcher.on_trial_complete(
            trial.trial_id, result=trial.last_result,
            error=status == ERROR)
        self.scheduler.on_trial_complete(self, trial, trial.last_result)
        self.callbacks.fire(
            "on_trial_error" if status == ERROR else "on_trial_complete",
            self._cb_iteration, self.trials, trial)
        self._snapshot()

    # -- ResourceChangingScheduler hook -------------------------------
    def reallocate_trial(self, trial: Trial,
                         resources: Dict[str, float]) -> bool:
        """Restart the trial's actor under a new resource allocation,
        restoring from a fresh checkpoint (reference:
        resource_changing_scheduler.py pauses the trial with a new
        PlacementGroupFactory). Returns True when the restart cycle was
        performed — the scheduler then returns NOOP so the normal
        decision path doesn't double-submit."""
        if trial.actor is None:
            trial.resource_override = dict(resources)
            return False
        if self._save_trial_checkpoint(trial) is None:
            return False
        trial.resource_override = dict(resources)
        trial.restore_pending = trial.checkpoint
        self._release_trial_resources(trial)
        trial.status = PENDING
        self._start_trial(trial)
        return True

    # -- PBT hook -----------------------------------------------------
    def exploit_trial(self, target: Trial, source: Trial,
                      new_config: Dict) -> None:
        """Clone source's state into target with a mutated config."""
        src_ckpt = self._save_trial_checkpoint(source)
        if src_ckpt is None:
            return
        if target.actor is None:
            # Paused target (synch PBT rounds run while the cohort is
            # parked): stage config + checkpoint; _start_trial applies
            # both when the trial resumes. The exploit checkpoint also
            # becomes the trial's own latest checkpoint — otherwise a
            # post-resume failure-retry would restore pre-exploit
            # weights under the post-exploit config.
            target.config = new_config
            target.checkpoint = src_ckpt
            target.restore_pending = src_ckpt
            return
        try:
            ok = ray_tpu_torch.get(target.actor.reset.remote(new_config))
        except (TaskError, ActorError, ActorDiedError):
            ok = False
        if not ok:
            try:
                ray_tpu_torch.kill(target.actor)
            except Exception:
                pass
            target.actor = self._create_actor(
                target, new_config, getattr(target, "_pg", None))
        try:
            ray_tpu_torch.get(target.actor.restore.remote(src_ckpt))
        except (TaskError, ActorError, ActorDiedError):
            # A dead target must not unwind the whole experiment; its
            # next train() future will fail and go through the normal
            # max_failures machinery.
            return
        target.config = new_config

    # -- stopping criteria -------------------------------------------
    def _should_stop(self, result: Dict) -> bool:
        for key, threshold in self.stop_criteria.items():
            v = result.get(key)
            if v is not None and v >= threshold:
                return True
        return False

    # -- main loop ----------------------------------------------------
    def _capacity(self) -> int:
        if self.max_concurrent <= 0:
            return 1 << 30
        running = sum(1 for t in self.trials if t.status == RUNNING)
        return max(0, self.max_concurrent - running)

    def run(self) -> List[Trial]:
        # Pre-create all pending trials the searcher can produce; start
        # up to capacity (the cluster queues actor creation beyond it).
        while True:
            self._fill()
            if not self._futures:
                if any(t.status in (PENDING, RUNNING) for t in self.trials):
                    continue
                paused = [t for t in self.trials if t.status == PAUSED]
                if paused:
                    # Nothing running and nothing pending: whatever
                    # paused these trials (soft stop, a synch barrier
                    # whose trigger died) will never fire again, so
                    # resume them rather than deadlock or strand them.
                    # Rescued trials run to completion — re-pausing in
                    # the experiment tail would thrash actor setup and
                    # teardown once per training step.
                    for t in paused:
                        t._rescued = True
                        self.unpause_trial(t)
                    continue
                break
            ready, _ = ray_tpu_torch.wait(
                list(self._futures.keys()), num_returns=1, timeout=120.0)
            if not ready:
                continue
            fut = ready[0]
            trial = self._futures.pop(fut)
            try:
                result = ray_tpu_torch.get(fut)
            except (TaskError, ActorError, ActorDiedError) as e:
                self._handle_failure(trial, e)
                continue
            self._handle_result(trial, result)
        self._snapshot()
        self.callbacks.fire("on_experiment_end", self.trials)
        return self.trials

    def _fill(self) -> None:
        while self._capacity() > 0:
            pending = next(
                (t for t in self.trials if t.status == PENDING), None)
            if pending is None:
                pending = self._next_trial()
            if pending is None:
                return
            self._start_trial(pending)

    def _handle_result(self, trial: Trial, result: Dict) -> None:
        if result.get(DONE):
            self._stop_trial(trial, TERMINATED)
            return
        result[TRIAL_ID] = trial.trial_id
        result["config"] = trial.config
        trial.last_result = result
        trial.results.append(result)
        trial.iteration = result.get(TRAINING_ITERATION, trial.iteration + 1)
        self._cb_iteration += 1
        self.callbacks.fire("on_trial_result", self._cb_iteration,
                            self.trials, trial, result)
        self.searcher.on_trial_result(trial.trial_id, result)
        if self.checkpoint_frequency and \
                trial.iteration % self.checkpoint_frequency == 0:
            self._save_trial_checkpoint(trial)
        if self._should_stop(result):
            self._stop_trial(trial, TERMINATED)
            return
        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == TrialScheduler.PAUSE \
                and getattr(trial, "_rescued", False):
            decision = TrialScheduler.CONTINUE
        if decision == TrialScheduler.STOP:
            self._stop_trial(trial, TERMINATED)
        elif decision == TrialScheduler.PAUSE:
            self._pause_trial(trial)
        elif decision == TrialScheduler.NOOP:
            pass  # scheduler already restarted/parked the trial itself
        else:
            self._submit_train(trial)

    def _pause_trial(self, trial: Trial) -> None:
        """Checkpoint and park the trial, releasing its actor, placement
        group, and concurrency slot (a paused trial must not pin compute
        — median-stopping's soft stop pauses precisely to free it).
        Resume goes through the normal restore path."""
        if self._save_trial_checkpoint(trial) is None:
            # No checkpoint means resuming would silently restart from
            # scratch; keep training instead of losing state.
            self._submit_train(trial)
            return
        trial.restore_pending = trial.checkpoint
        self._release_trial_resources(trial)
        trial.status = PAUSED

    def unpause_trial(self, trial: Trial) -> None:
        """Move a paused trial back to PENDING; _fill restarts it within
        the concurrency budget and restores its pause checkpoint."""
        if trial.status != PAUSED:
            return
        trial.status = PENDING

    def _handle_failure(self, trial: Trial, error: BaseException) -> None:
        n = self._failures.get(trial.trial_id, 0)
        if n < self.max_failures:
            self._failures[trial.trial_id] = n + 1
            trial.restore_pending = trial.checkpoint
            # Release the dead actor AND its placement group before the
            # retry reserves a fresh one — otherwise the old reservation
            # leaks and can starve the retry forever.
            self._release_trial_resources(trial)
            trial.status = PENDING  # re-started by _fill
            self._start_trial(trial)
        else:
            self.scheduler.on_trial_error(self, trial)
            self._stop_trial(trial, ERROR, error=error)

    # -- experiment state snapshot/resume -----------------------------
    @property
    def _state_file(self) -> str:
        return os.path.join(self.storage.experiment_dir,
                            "experiment_state.pkl")

    def _snapshot(self) -> None:
        state = [{
            "trial_id": t.trial_id,
            "config": t.config,
            "status": t.status,
            "last_result": t.last_result,
            "iteration": t.iteration,
            "checkpoint_path": t.checkpoint.path if t.checkpoint else None,
        } for t in self.trials]
        os.makedirs(self.storage.experiment_dir, exist_ok=True)
        with open(self._state_file, "wb") as f:
            pickle.dump(state, f)

    def load_snapshot(self) -> bool:
        if not os.path.exists(self._state_file):
            return False
        with open(self._state_file, "rb") as f:
            state = pickle.load(f)
        for s in state:
            trial = Trial(s["trial_id"], s["config"],
                          self.storage.experiment_name)
            trial.last_result = s["last_result"]
            trial.iteration = s["iteration"]
            if s["checkpoint_path"]:
                trial.checkpoint = Checkpoint(s["checkpoint_path"])
            if s["status"] in (TERMINATED, ERROR):
                trial.status = s["status"]
            else:
                trial.status = PENDING
                trial.restore_pending = trial.checkpoint
            self.trials.append(trial)
            self._trial_counter = max(self._trial_counter,
                                      int(s["trial_id"]) + 1)
        return True
