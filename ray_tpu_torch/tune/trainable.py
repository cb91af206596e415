"""Trainable: the unit of execution Tune schedules, the port of
``ray_tpu/tune/trainable.py`` (no device code): the class API, which
rllib's ``Algorithm`` derives from, and the function API
(``FunctionTrainable``, ``report``, ``get_checkpoint``,
``with_parameters``, ``with_resources``).

Reference: ``python/ray/tune/trainable/trainable.py`` — an actor with
``setup/step/save_checkpoint/load_checkpoint`` driven by repeated
``train()`` calls — and ``function_trainable.py`` (user function running
on a thread, ``tune.report`` feeding a bounded queue). Both styles run
inside a ``_TrialActor``.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint

# Result-dict autofilled keys (reference ``tune/result.py``)
TRAINING_ITERATION = "training_iteration"
DONE = "done"
TRIAL_ID = "trial_id"


class Trainable:
    """Class API: subclass with setup/step/save/load (reference :239)."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}
        self._iteration = 0
        self.setup(self.config)

    # -- overridable ---------------------------------------------------
    def setup(self, config: Dict) -> None:
        pass

    def step(self) -> Dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def reset_config(self, new_config: Dict) -> bool:
        """Return True if the trainable supports in-place config swap
        (lets PBT exploit without actor teardown)."""
        return False

    def cleanup(self) -> None:
        pass

    # -- driver-facing -------------------------------------------------
    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> Dict:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        return result

    def save(self, checkpoint_dir: Optional[str] = None) -> Checkpoint:
        d = checkpoint_dir or tempfile.mkdtemp(prefix="tune_ckpt_")
        os.makedirs(d, exist_ok=True)
        out = self.save_checkpoint(d) or d
        return Checkpoint(out)

    def restore(self, checkpoint: Checkpoint) -> None:
        self.load_checkpoint(checkpoint.path)

    def reset(self, new_config: Dict) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
        return ok

    def stop(self) -> None:
        self.cleanup()


class FunctionTrainable(Trainable):
    """Function API: runs ``fn(config)`` on a thread; ``tune.report``
    yields one result per train() call (reference function_trainable)."""

    _fn: Callable = None  # set by wrap()

    @classmethod
    def wrap(cls, fn: Callable) -> type:
        return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                    (cls,), {"_fn": staticmethod(fn)})

    def setup(self, config: Dict) -> None:
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._restore_checkpoint: Optional[Checkpoint] = None
        self._last_checkpoint: Optional[Checkpoint] = None
        self._error: Optional[BaseException] = None

    def _run(self):
        global _fn_session
        _fn_session = _FunctionSession(
            self._queue, self._restore_checkpoint)
        try:
            self._fn(self.config)
            self._queue.put(("done", None, None))
        except BaseException as e:
            self._queue.put(("error", e, None))

    def step(self) -> Dict:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tune_fn", daemon=True)
            self._thread.start()
        kind, payload, ckpt = self._queue.get()
        if kind == "error":
            raise payload
        if kind == "done":
            return {DONE: True}
        if ckpt is not None:
            self._last_checkpoint = ckpt
        return payload

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        if self._last_checkpoint is None:
            return None
        import shutil
        shutil.copytree(self._last_checkpoint.path, checkpoint_dir,
                        dirs_exist_ok=True)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        self._restore_checkpoint = Checkpoint(checkpoint_dir)


class _FunctionSession:
    def __init__(self, q: "queue.Queue",
                 checkpoint: Optional[Checkpoint]):
        self.queue = q
        self.loaded_checkpoint = checkpoint


_fn_session: Optional[_FunctionSession] = None


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """``ray_tpu_torch.tune.report`` — inside a function trainable."""
    s = _fn_session
    if s is None:
        # Fall back to the train-session report (trainer inside tune).
        from ray_tpu_torch.train._internal import session as train_session
        if train_session.get_session() is not None:
            train_session.report(metrics, checkpoint=checkpoint)
            return
        raise RuntimeError("tune.report() called outside a trial")
    s.queue.put(("result", dict(metrics), checkpoint))


def get_checkpoint() -> Optional[Checkpoint]:
    s = _fn_session
    if s is not None:
        return s.loaded_checkpoint
    from ray_tpu_torch.train._internal import session as train_session
    return train_session.get_checkpoint()


def with_parameters(trainable, **kwargs):
    """Bind large constant objects into a trainable
    (reference ``tune/trainable/util.py:with_parameters``)."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        class _Bound(trainable):  # type: ignore[misc, valid-type]
            def setup(self, config):
                super().setup({**config, **kwargs})
        _Bound.__name__ = trainable.__name__
        return _Bound

    def _fn(config):
        return trainable(config, **kwargs)
    _fn.__name__ = getattr(trainable, "__name__", "trainable")
    if hasattr(trainable, "default_resource_request"):
        _fn.default_resource_request = trainable.default_resource_request
    return _fn


def with_resources(trainable, resources):
    """Attach a resource request (dict or PlacementGroupFactory)."""
    from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory
    if isinstance(resources, dict):
        resources = PlacementGroupFactory([resources])
    if isinstance(trainable, type):
        trainable.default_resource_request = classmethod(
            lambda cls, config: resources)
    else:
        trainable.default_resource_request = lambda config: resources
    return trainable
