"""Learner and LearnerGroup: the port of ``ray_tpu/rllib/learner.py``.

``Learner`` holds an ``RLModule``'s parameters and optimizer state on its
device (the card by default) and runs one update per minibatch: the
module's train forward, the algorithm's loss, the backward, the global
norm, then optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` as
:class:`ray_tpu_torch.models.training.ClipAdamW` (``b2=0.999``, no weight
decay, no clip when ``grad_clip`` is falsy). The ``grad_norm`` metric is
the norm before the clip, ``total_loss`` the loss.

A group holds one local learner, or N learner actors on the port's
runtime that shard each batch and average their gradients. Gradients
leave an actor as numpy trees (nested dicts and lists of arrays) and are
averaged on the host with ``np.mean(np.stack(...))``, leaf by leaf, as
the JAX group does; the one average is then applied to every replica, so
the replicas stay bit-identical. No collective is used. A tree bound for
every learner (the average, weights) is put into the object store once
and passed by reference. Minibatch permutations come from the group's
numpy generator, so both packages shuffle alike.

A learner is any object with the ``Learner`` protocol:
``compute_gradients(batch) -> (grads, metrics)``,
``apply_gradients(grads)``, ``get_weights()``, ``set_weights(w)`` and
``update_from_batch(batch) -> metrics`` (the RLHF ``PolicyLearner`` is
another).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.training import ClipAdamW, global_norm
from ray_tpu_torch.rllib.models import (tree_get, tree_map, tree_paths,
                                        tree_to_numpy)
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.rollout_stream import _concat_batches, _nrows


def learner_device(device=None) -> torch.device:
    """A learner's device: the one named, else the card, raising without
    one. In a runtime worker put on the CPU platform
    (``RAY_TPU_TORCH_PLATFORM=cpu``, which hides every card from it)
    ``None`` is the CPU, as for the port's other actors' entry points."""
    from ray_tpu_torch.core.global_state import try_global_worker
    from ray_tpu_torch.models.transformer import resolve_device
    worker = try_global_worker()
    if device is None and getattr(worker, "kind", None) == "worker" \
            and os.environ.get("RAY_TPU_TORCH_PLATFORM") == "cpu":
        return torch.device("cpu")
    return resolve_device(device)


def _batch_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy sample batch on ``device``: floats as f32, integers (the
    actions of a Discrete space) as int64, which the log-probability
    gathers index with."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        elif t.dtype != torch.bool:
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


class Learner:
    """Holds params and optimizer state on ``device``; ``update_from_batch``
    is one update.

    ``device=None`` is the card and raises without one (see
    :func:`learner_device`); tests name the CPU. The initial weights are
    drawn from ``seed`` on the CPU and moved, so a seed gives the same
    weights on every device.
    """

    def __init__(self, module_spec: RLModuleSpec,
                 loss_fn: Callable[..., Tuple[torch.Tensor, Dict]],
                 learning_rate: float = 3e-4,
                 grad_clip: Optional[float] = 0.5, seed: int = 0,
                 loss_config: Optional[Dict[str, Any]] = None,
                 device=None):
        self.device = learner_device(device)
        self.module = module_spec.build()
        self._loss_fn = loss_fn
        self._loss_config = loss_config or {}
        self._opt = ClipAdamW(learning_rate, b2=0.999, weight_decay=0.0,
                              clip_norm=grad_clip if grad_clip else None)
        params = self.module.init(seed, device=self.device)
        self.load_state({"params": params, "opt_state": {
            "count": torch.zeros((), dtype=torch.int32, device=self.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}})

    def load_state(self, state: Dict[str, Any]) -> None:
        """Take ``{"params", "opt_state": {"count", "mu", "nu"}}`` in this
        learner's layout (``ray_tpu_torch._bridge.rllib_state_from_jax``
        carries a JAX learner's state into it)."""
        params = state["params"]
        self._paths = tree_paths(params)
        self._leaves = [tree_get(params, p) for p in self._paths]
        for p in self._leaves:
            p.requires_grad_(True)
        self._state = state

    # -- the update ----------------------------------------------------
    def _loss(self, batch: Dict[str, torch.Tensor]):
        out = self.module.forward_train(self._state["params"], batch["obs"])
        return self._loss_fn(out, batch, **self._loss_config)

    def _grads(self, batch: Dict[str, np.ndarray]):
        loss, metrics = self._loss(_batch_tensors(batch, self.device))
        # zeros for a leaf the loss does not reach (BC's value head), as
        # JAX's gradients have them
        grads = list(torch.autograd.grad(loss, self._leaves,
                                         allow_unused=True,
                                         materialize_grads=True))
        with torch.no_grad():
            gnorm = global_norm(grads)
        metrics = dict(metrics, total_loss=loss, grad_norm=gnorm)
        return grads, gnorm, metrics

    @staticmethod
    def _floats(metrics) -> Dict[str, float]:
        """Scalar tensors to floats, through one copy to the host."""
        vals = torch.stack([v.detach().float().reshape(())
                            for v in metrics.values()]).tolist()
        return dict(zip(metrics, vals))

    def _apply(self, grads: List[torch.Tensor], gnorm: torch.Tensor) -> None:
        self._opt.update(grads, self._state["opt_state"], self._leaves,
                         gnorm, paths=self._paths)

    # -- public --------------------------------------------------------
    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        grads, gnorm, metrics = self._grads(batch)
        with torch.no_grad():
            self._apply(grads, gnorm)
        return self._floats(metrics)

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """Data-parallel path: the gradient tree (tensors on the device)
        and the metrics; the group averages and applies."""
        grads, _, metrics = self._grads(batch)
        metrics.pop("grad_norm")
        it = iter(grads)
        return (tree_map(lambda _: next(it), self._state["params"]),
                self._floats(metrics))

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        """Apply a gradient tree (tensors or numpy arrays, keyed as the
        params) through the clip and Adam."""
        g = [_f32(tree_get(grads, p), self.device) for p in self._paths]
        self._apply(g, global_norm(g))

    def get_weights(self):
        return tree_to_numpy(self._state["params"])

    @torch.no_grad()
    def set_weights(self, params) -> None:
        """Copy a tree of the same structure (numpy arrays or tensors)
        into the params in place; the optimizer state stays."""
        for p, leaf in zip(self._paths, self._leaves):
            leaf.copy_(_f32(tree_get(params, p), self.device))


def _f32(x, device) -> torch.Tensor:
    """A numpy array or tensor leaf as an f32 tensor on ``device``, a copy
    (the clip scales gradients in place; a numpy leaf may view the object
    store)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, torch.float32, copy=True)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _mean_grads(grads: List[Any]):
    """The leaf-wise mean of numpy gradient trees."""
    return tree_map(lambda *gs: np.mean(np.stack(gs), axis=0), *grads)


class LearnerGroup:
    """Local single learner, or N remote learner actors doing
    data-parallel updates with gradient averaging."""

    def __init__(self, make_learner: Callable[[], Any],
                 num_learners: int = 0,
                 resources_per_learner: Optional[Dict] = None,
                 seed: int = 0):
        self._num = num_learners
        #: host walls of each synchronous gradient round of the sharded
        #: epoch, s: (the round's first launch to its gradients gathered,
        #: their mean, the mean applied on every learner)
        self.round_walls: List[tuple] = []
        # One generator for the whole run: minibatch permutations must
        # differ across training iterations.
        self._rng = np.random.default_rng(seed)
        if num_learners == 0:
            self._local = make_learner()
            self._remote: List[Any] = []
        else:
            self._local = None
            opts = dict(resources_per_learner or {"num_cpus": 1})
            cls = ray_tpu_torch.remote(**opts)(_RemoteLearner)
            self._remote = [cls.remote(make_learner)
                            for _ in range(num_learners)]
            # All learners start from learner 0's weights (its result's
            # ref, so the tree is not copied through this process).
            w = self._remote[0].get_weights.remote()
            ray_tpu_torch.get([a.set_weights.remote(w)
                               for a in self._remote[1:]])

    def update_from_batch(self, batch: Dict[str, np.ndarray],
                          minibatch_size: Optional[int] = None,
                          num_epochs: int = 1) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        n = _nrows(batch)
        mb = minibatch_size or n
        for _ in range(num_epochs):
            perm = self._rng.permutation(n)
            for start in range(0, n, mb):
                idx = perm[start:start + mb]
                sub = {k: v[idx] for k, v in batch.items()}
                metrics = self._one_update(sub)
        return metrics

    def _one_update(self, batch) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update_from_batch(batch)
        # shard batch across learners; average gradients
        shards = np.array_split(np.arange(_nrows(batch)), self._num)
        futs = [a.compute_gradients.remote(
            {k: v[idx] for k, v in batch.items()})
            for a, idx in zip(self._remote, shards) if len(idx)]
        results = ray_tpu_torch.get(futs)
        self._apply_everywhere(_mean_grads([g for g, _ in results]))
        return results[0][1]

    def _apply_everywhere(self, grads) -> None:
        """Apply one averaged gradient tree on every learner. The tree
        goes into the object store once and each learner reads it there:
        an argument passed by value would be pickled into each call's
        message (and into every retransmit of it)."""
        ref = ray_tpu_torch.put(grads)
        ray_tpu_torch.get([a.apply_gradients.remote(ref)
                           for a in self._remote])

    def update_from_stream(self, stream,
                           minibatch_size: Optional[int] = None,
                           num_epochs: int = 1
                           ) -> Dict[str, float]:
        """Streaming rollout-to-train epoch: the FIRST epoch consumes
        minibatches straight off the rollout stream as blocks arrive
        (no epoch barrier), collecting the blocks; the remaining
        ``num_epochs - 1`` epochs run shuffled-minibatch passes over the
        collected full batch. Streamed minibatches drop the ragged tail
        so every update shares one shape."""
        stream._collect = True
        metrics: Dict[str, float] = {}
        n_updates = 0
        for mb in stream.iter_batches(minibatch_size, drop_last=True):
            metrics = self._one_update(mb)
            n_updates += 1
        if not stream.blocks:
            return metrics
        if num_epochs > 1:
            batch = stream.full_batch()
            metrics = self.update_from_batch(
                batch, minibatch_size=minibatch_size,
                num_epochs=num_epochs - 1)
        metrics = dict(metrics)
        metrics["stream_updates"] = float(n_updates)
        return metrics

    def update_from_stream_sharded(self, stream,
                                   minibatch_size: Optional[int] = None,
                                   num_epochs: int = 1,
                                   on_round: Optional[
                                       Callable[[int, Dict[str, float]],
                                                None]] = None
                                   ) -> Dict[str, float]:
        """Multi-learner streaming epoch: the FIRST epoch trains on ALL
        learners as blocks arrive. Each arriving block goes to a learner
        shard deterministically, by its ``shard_key`` (else
        ``worker_index``, else ``uid``) mod ``num_learners``, so a
        lineage-replayed block re-chunks onto the same learner. Each
        learner computes gradients on its own shard concurrently; a
        synchronous round closes once every learner holds a gradient,
        and the round's average applies to ALL learners, keeping the
        replicas identical. Ragged tails average over the learners that
        have data. Epochs 2+ run shuffled passes over the collected full
        batch. ``on_round(n_rounds, metrics)`` fires after each applied
        round (the RLHF trainer's in-flight publish hook). Falls back to
        ``update_from_stream`` for a local or single-learner group."""
        if self._local is not None or self._num < 2:
            return self.update_from_stream(stream, minibatch_size,
                                           num_epochs)
        stream._collect = True
        n = self._num
        per = max(1, minibatch_size // n) if minibatch_size else None
        buffers: List[List[Dict[str, np.ndarray]]] = \
            [[] for _ in range(n)]
        rows = [0] * n
        futs: List[collections.deque] = \
            [collections.deque() for _ in range(n)]
        self.shard_rows = [0] * n
        self.shard_uids: List[List[int]] = [[] for _ in range(n)]
        metrics: Dict[str, float] = {}
        n_rounds = 0

        def launch(i: int, take: int) -> None:
            merged = _concat_batches(buffers[i])
            sub = {k: v[:take] for k, v in merged.items()}
            rest = _nrows(merged) - take
            buffers[i] = [{k: v[take:] for k, v in merged.items()}] \
                if rest else []
            rows[i] = rest
            futs[i].append((self._remote[i].compute_gradients.remote(sub),
                            time.perf_counter()))
            self.shard_rows[i] += take

        def close_round(require_all: bool) -> bool:
            nonlocal metrics, n_rounds
            have = [i for i in range(n) if futs[i]]
            if not have or (require_all and len(have) < n):
                return False
            launched = [futs[i].popleft() for i in have]
            t0 = min(t for _, t in launched)
            results = ray_tpu_torch.get([f for f, _ in launched])
            t1 = time.perf_counter()
            grads = _mean_grads([g for g, _ in results])
            t2 = time.perf_counter()
            self._apply_everywhere(grads)
            self.round_walls.append((t1 - t0, t2 - t1,
                                     time.perf_counter() - t2))
            metrics = results[0][1]
            n_rounds += 1
            if on_round is not None:
                on_round(n_rounds, metrics)
            return True

        for batch, info in stream.iter_blocks():
            i = int(info.get("shard_key",
                             info.get("worker_index",
                                      info.get("uid", 0)))) % n
            self.shard_uids[i].append(int(info.get("uid", -1)))
            buffers[i].append(batch)
            rows[i] += _nrows(batch)
            target = per if per is not None else rows[i]
            while target > 0 and rows[i] >= target:
                launch(i, target)
                if per is None:
                    break
            while close_round(require_all=True):
                pass
        for i in range(n):          # ragged shard tails
            if rows[i]:
                launch(i, rows[i])
        while close_round(require_all=False):
            pass
        if stream.blocks and num_epochs > 1:
            metrics = self.update_from_batch(
                stream.full_batch(), minibatch_size=minibatch_size,
                num_epochs=num_epochs - 1)
        metrics = dict(metrics)
        metrics["stream_updates"] = float(n_rounds)
        metrics["learners_used"] = float(
            sum(1 for r in self.shard_rows if r))
        return metrics

    def update_ordered(self, batch: Dict[str, np.ndarray]
                       ) -> Dict[str, float]:
        """One full-batch update with NO shuffling, always on one
        learner: sequence-structured losses need samples in order, and
        sharding would split the time axis."""
        if self._local is not None:
            return self._local.update_from_batch(batch)
        return ray_tpu_torch.get(
            self._remote[0].update_from_batch.remote(batch))

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._remote[0].get_weights.remote())

    def set_weights(self, w) -> None:
        if self._local is not None:
            self._local.set_weights(w)
        else:
            ref = ray_tpu_torch.put(w)
            ray_tpu_torch.get([a.set_weights.remote(ref)
                               for a in self._remote])

    def shutdown(self) -> None:
        for a in self._remote:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class _RemoteLearner:
    """Actor wrapper: gradients leave and arrive as numpy trees. ``walls``
    keeps the seconds of each call's own work in the actor: the
    gradients, their copy to numpy on the host, the update from the
    received mean."""

    def __init__(self, make_learner):
        self._learner = make_learner()
        self.walls: Dict[str, List[float]] = {"compute_gradients": [],
                                              "grads_to_host": [],
                                              "apply_gradients": []}

    def compute_gradients(self, batch):
        t0 = time.perf_counter()
        grads, metrics = self._learner.compute_gradients(batch)
        t1 = time.perf_counter()
        grads = tree_to_numpy(grads)
        self.walls["compute_gradients"].append(t1 - t0)
        self.walls["grads_to_host"].append(time.perf_counter() - t1)
        return grads, metrics

    def apply_gradients(self, grads):
        t0 = time.perf_counter()
        self._learner.apply_gradients(grads)
        self.walls["apply_gradients"].append(time.perf_counter() - t0)

    def get_weights(self):
        return self._learner.get_weights()

    def set_weights(self, w):
        self._learner.set_weights(w)

    def update_from_batch(self, batch):
        return self._learner.update_from_batch(batch)
