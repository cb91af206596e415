"""The closed PPO-RLHF loop, the port's copy of
``ray_tpu/rlhf/trainer.py``: rollout rounds → sharded multi-learner
streaming updates → in-flight weight republish, under a staleness bound.

Round anatomy (one ``train_round`` call):

1. Deterministic per-round prompt suffixes are appended to the shared
   system prompt and admitted to the rollout engines under the
   ``max_weight_lag`` gate.
2. Trajectory blocks stream back in completion order;
   ``LearnerGroup.update_from_stream_sharded`` re-chunks them
   deterministically across ALL learners and closes synchronous
   gradient rounds as shards fill.
3. After every ``sync_every_updates`` applied rounds the ``on_round``
   hook packs the fresh learner weights over the int8 wire and stages
   them on every engine — **while those engines are still decoding the
   round's remaining trajectories**. The engine step thread pointer-
   swaps between decode steps; tokens emitted after the swap carry the
   new policy version, so one trajectory's ``versions`` row can
   legitimately read ``[3 3 3 4 4 …]`` — that is the in-flight refresh
   observable the chaos tests pin down.

The staleness gate cannot deadlock: ``publish`` stages synchronously,
and ``LLMEngine.weight_version`` reports a *staged* version
immediately, so the learner-side version and the engine-side version
never diverge by more than the one publish that is mid-stage.

On the card the learner's teacher-forced forward and its backward run
the flash kernels (forward, delta, dK/dV, dQ) through ``attn_impl``
``"auto"``, and the rollouts run the paged kernel. ``device=None`` is
the card and raises without one, except in a runtime worker on the CPU
platform (``RAY_TPU_TORCH_PLATFORM=cpu``), where it is the CPU.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._bridge import to_numpy
from ray_tpu_torch.models.training import ClipAdamW, global_norm, tree_leaves
from ray_tpu_torch.models.transformer import (TransformerConfig, apply,
                                              init_params)
from ray_tpu_torch.rlhf.config import RLHFConfig
from ray_tpu_torch.rlhf.rollout import RolloutEngine
from ray_tpu_torch.rlhf.weight_sync import WeightPublisher
from ray_tpu_torch.rllib.learner import LearnerGroup
from ray_tpu_torch.serve import llm_engine as _llm_engine
from ray_tpu_torch.serve.llm_engine import _resolve_dtype


def _tree_like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) rebuilt into ``tree``'s
    nested dicts."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)
    return build(tree)


def _keyed_like(tree, other):
    """``other``'s leaves in ``tree``'s key order (the JAX package's trees
    may order their keys otherwise)."""
    if isinstance(tree, dict):
        return {k: _keyed_like(v, other[k]) for k, v in tree.items()}
    return other


def _f32_leaf(x, device) -> torch.Tensor:
    """A numpy array or tensor leaf as an f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


class PolicyLearner:
    """Token-level PPO learner over the port's transformer.

    Implements the ``Learner`` protocol (``compute_gradients`` /
    ``apply_gradients`` / ``get_weights`` / ``set_weights`` /
    ``update_from_batch``) so ``LearnerGroup`` can run it locally or as
    remote data-parallel replicas unchanged.

    The loss is exact PPO, not an approximation: the rollout batch's
    ``logprobs`` column was captured by the engine from the *behavior*
    policy's own forward pass (the quantized weights that actually
    generated each token), so ``exp(new_lp - logprobs)`` is the true
    importance ratio, and the ``versions`` column tells you which
    policy that was.

    State: f32 masters (``init_params``' default) and the optimizer of
    the JAX learner, optax's ``chain(clip_by_global_norm(grad_clip),
    adam(learning_rate))``, as :class:`ray_tpu_torch.models.training.
    ClipAdamW` with ``b2=0.999`` and no weight decay. The model computes
    in its config's dtype. Gradients come back as tensors on the device;
    ``apply_gradients`` takes tensors or numpy arrays.
    """

    def __init__(self, model: Dict[str, Any],
                 learning_rate: float = 1e-3,
                 clip_eps: float = 0.2, grad_clip: float = 1.0,
                 seed: int = 0, device=None):
        model = dict(model)
        model["dtype"] = _resolve_dtype(model.get("dtype", "float32"))
        self.config = TransformerConfig(**model)
        self.device = _llm_engine._server_device(device)
        self._clip_eps = float(clip_eps)
        self._opt = ClipAdamW(learning_rate, b2=0.999, weight_decay=0.0,
                              clip_norm=grad_clip if grad_clip else None)
        params = init_params(self.config, seed, self.device)
        self.load_state({"params": params,
                         "opt_state": self._opt.init(params)})

    def load_state(self, state: Dict[str, Any]) -> None:
        """Resume from ``{"params", "opt_state"}`` in this learner's
        layout (``ray_tpu_torch._bridge.policy_state_from_jax`` carries
        a JAX ``PolicyLearner``'s state into it)."""
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        self._state = state

    # --------------------------------------------------------- the loss
    def _loss(self, params, batch):
        prompt = batch["prompt"]
        tokens = batch["tokens"]
        P = prompt.shape[1]
        # Teacher-force the whole trajectory in one forward: position
        # P-1+j of the concatenated input predicts generated token j.
        inputs = torch.cat([prompt, tokens[:, :-1]], dim=1)
        logits = apply(self.config, params, inputs)
        gen = logits[:, P - 1:, :].float()
        lp = torch.log_softmax(gen, dim=-1).gather(
            -1, tokens[..., None].long())[..., 0]
        behavior_lp = batch["logprobs"]
        ratio = torch.exp(lp - behavior_lp)
        adv = batch["advantages"][:, None]
        clipped = torch.clamp(ratio, 1.0 - self._clip_eps,
                              1.0 + self._clip_eps)
        loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
        return loss, {"approx_kl": torch.mean(behavior_lp - lp),
                      "ratio_mean": torch.mean(ratio)}

    def _batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        def put(name, dtype):
            return torch.tensor(np.asarray(batch[name]), dtype=dtype,
                                device=self.device)
        return {"prompt": put("prompt", torch.int32),
                "tokens": put("tokens", torch.int32),
                "logprobs": put("logprobs", torch.float32),
                "advantages": put("advantages", torch.float32)}

    # --------------------------------------------- Learner protocol
    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        params = self._state["params"]
        leaves = tree_leaves(params)
        loss, metrics = self._loss(params, self._batch(batch))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gnorm = global_norm(grads)
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out["total_loss"] = float(loss.detach())
        out["grad_norm"] = float(gnorm)
        return _tree_like(params, grads), out

    def apply_gradients(self, grads) -> None:
        params = self._state["params"]
        leaves = tree_leaves(params)
        g = [_f32_leaf(x, self.device)
             for x in tree_leaves(_keyed_like(params, grads))]
        with torch.no_grad():
            self._opt.update(g, self._state["opt_state"], leaves,
                             global_norm(g))

    def get_weights(self):
        return to_numpy(self._state["params"])

    @torch.no_grad()
    def set_weights(self, params) -> None:
        """Copy a tree of the same keys (numpy arrays or tensors) into
        the f32 masters in place; the optimizer state stays."""
        def copy(dst, src):
            if isinstance(dst, dict):
                for k, v in dst.items():
                    copy(v, src[k])
            else:
                dst.copy_(_f32_leaf(src, self.device))
        copy(self._state["params"], params)

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        grads, metrics = self.compute_gradients(batch)
        self.apply_gradients(grads)
        return metrics


class RLHFTrainer:
    """Owns the whole loop: placement → learners → rollout engines →
    weight publisher. One ``train_round()`` call is one PPO round with
    in-flight weight refresh; ``train(n)`` runs n of them. ``device``
    is the local learner's and the rollout engines' (remote learners
    take it too, or ``None``: their worker's card, or the CPU in a
    worker on the CPU platform)."""

    def __init__(self, config: RLHFConfig, slice_manager=None,
                 recorder=None, device=None):
        self.config = config
        self.placement = config.lower()
        self._slice_manager = slice_manager
        if slice_manager is not None:
            self.placement.reserve(slice_manager)
        if recorder is None:
            try:
                from ray_tpu_torch.core.global_state import \
                    try_global_worker
                w = try_global_worker()
                recorder = getattr(w, "recorder", None)
            except Exception:
                recorder = None
        self._recorder = recorder
        model = config.model_config()
        lr, eps, seed = (config.learning_rate, config.clip_eps,
                         config.seed)

        def make_learner():
            return PolicyLearner(model, learning_rate=lr,
                                 clip_eps=eps, seed=seed, device=device)

        self.learners = LearnerGroup(
            make_learner,
            num_learners=(config.num_learners
                          if config.num_learners >= 2 else 0),
            seed=config.seed)
        w0 = self.learners.get_weights()
        # Engines start from the learners' exact initial policy: the
        # version-0 rollouts really are on-policy.
        self.rollout = RolloutEngine(config, params=w0,
                                     recorder=recorder, device=device)
        self.publisher = WeightPublisher(
            self.rollout.engines, block_size=config.quant_block_size,
            recorder=recorder)
        self._version = 0       # latest PUBLISHED learner version
        self._version_lock = threading.Lock()
        self._round = 0
        self.history: List[Dict[str, Any]] = []

    # -------------------------------------------------------- prompts
    def round_suffixes(self, round_index: Optional[int] = None
                       ) -> List[List[int]]:
        """Deterministic per-round prompt suffixes (seeded by config
        seed + round): reproducible rollouts without threading prompt
        datasets through every test."""
        cfg = self.config
        rnd = self._round if round_index is None else round_index
        rng = np.random.default_rng(cfg.seed * 1_000_003 + rnd)
        sfx_len = cfg.prompt_len - len(cfg.system_prompt)
        hi = min(1000, int(cfg.model_config().get("vocab_size", 50400)))
        return [rng.integers(2, hi, size=sfx_len,
                             dtype=np.int64).tolist()
                for _ in range(cfg.rollouts_per_round)]

    def _learner_version(self) -> int:
        with self._version_lock:
            return self._version

    # ---------------------------------------------------------- rounds
    def train_round(self, suffixes: Optional[List[List[int]]] = None
                    ) -> Dict[str, Any]:
        cfg = self.config
        self._round += 1
        if suffixes is None:
            suffixes = self.round_suffixes()
        stream = self.rollout.stream_round(
            suffixes, learner_version_fn=self._learner_version,
            collect=True)
        publishes_before = self.publisher.stats()["publishes"]

        def on_round(n_rounds: int, _metrics: Dict[str, float]
                     ) -> None:
            # In-flight republish: engines are still decoding this
            # round's remaining trajectories when this stages weights.
            if n_rounds % cfg.sync_every_updates == 0:
                w = self.learners.get_weights()
                v = self.publisher.publish(w)
                with self._version_lock:
                    self._version = v

        metrics = self.learners.update_from_stream_sharded(
            stream, minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs, on_round=on_round)
        if self.publisher.stats()["publishes"] == publishes_before:
            # Single/local-learner fallback path has no on_round hook:
            # still publish once per round so the loop stays closed.
            w = self.learners.get_weights()
            v = self.publisher.publish(w)
            with self._version_lock:
                self._version = v
        rstats = self.rollout.stats()
        pstats = self.publisher.stats()
        out = dict(metrics)
        out.update({
            "round": self._round,
            "trajectories": len(stream.infos),
            "rollout_tokens": rstats["tokens_total"],
            "prefix_hit_rate": rstats["prefix_hit_rate"],
            "prompt_blocks_total": rstats["prompt_blocks_total"],
            "rewarm_blocks": rstats["rewarm_blocks"],
            "weight_version": rstats["weight_version"],
            "weight_syncs": pstats["publishes"],
            "wire_compression": pstats["compression"],
            "sync_stall_s": rstats["sync_stall_s"],
            "staleness_p50": rstats["staleness_p50"],
            "staleness_p99": rstats["staleness_p99"],
            "staleness_max": rstats["staleness_max"],
        })
        self.history.append(out)
        return out

    def train(self, num_rounds: int) -> List[Dict[str, Any]]:
        return [self.train_round() for _ in range(num_rounds)]

    # ----------------------------------------------------------- audit
    def stats(self) -> Dict[str, Any]:
        return {
            "rounds": self._round,
            "placement": self.placement.placement,
            "slice_strategy": self.placement.slice_strategy,
            "rollout": self.rollout.stats(),
            "publisher": self.publisher.stats(),
        }

    def shutdown(self) -> None:
        try:
            self.rollout.shutdown()
        except Exception:
            pass
        try:
            self.learners.shutdown()
        except Exception:
            pass
        if self._slice_manager is not None:
            self.placement.release(self._slice_manager)
