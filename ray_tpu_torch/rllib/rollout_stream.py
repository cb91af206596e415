"""Rollout-to-train streaming dataflow, the port of
``ray_tpu/rllib/rollout_stream.py`` (Podracer-style decoupled
actor/learner, arXiv:2104.06272; a distributed rollout feed,
arXiv:2507.19017).

``rollout_stream`` is a **generator task** (``num_returns=
"streaming"``), not an actor method: it is deterministic in its
arguments (env construction, module init and action sampling are all
seeded), so a mid-epoch SIGKILL of a runner's worker lineage-replays
the stream prefix on a fresh worker and the owner's per-index dedup
delivers every block to the consumer exactly once.

``RolloutBlockStream`` is the fan-in consumer edge over N such streams:
``wait_any`` surfaces whichever producer has a block buffered (one
straggler never stalls the learner), blocks re-chunk into fixed
minibatches through ``iter_batches``, and the time the consumer spends
blocked with no block ready is measured as the rollout-to-train bubble.
``block_uid`` is the per-(producer, block) id that makes exactly-once
delivery assertable end to end.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch


class RandomEnv:
    """Gym-free env for benches and tests (no gymnasium dependency):
    seeded random-walk observations, +1 reward per step, fixed-length
    episodes. Observations, rewards and episode ends ignore the action
    and come from a numpy generator. Speaks the 5-tuple gymnasium step
    API the EnvRunner consumes."""

    class _Space:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self, obs_dim: int = 8, n_actions: int = 4,
                 episode_len: int = 50, seed: int = 0):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0
        # minimal gym-shaped spaces so Algorithm.setup's space probe
        # (spec_for_spaces) works without gymnasium
        self.observation_space = self._Space(shape=(obs_dim,))
        self.action_space = self._Space(n=n_actions)

    def close(self) -> None:
        pass

    def _obs(self) -> np.ndarray:
        return self._rng.standard_normal(self.obs_dim).astype(np.float32)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        terminated = self._t >= self.episode_len
        if terminated:
            self._t = 0
        return self._obs(), 1.0, terminated, False, {}


def block_uid(worker_index: int, block: int) -> int:
    """Stable per-(runner, block) id carried as a row column so
    exactly-once delivery is assertable end to end."""
    return worker_index * 1_000_000 + block


def rollout_stream(env_creator: Callable[[], Any], module_spec,
                   weights, num_blocks: int, steps_per_block: int,
                   num_envs: int = 1, gamma: float = 0.99,
                   lambda_: float = 0.95, seed: int = 0,
                   worker_index: int = 0,
                   fault: Optional[Dict[str, Any]] = None):
    """Generator-task body: build a (deterministically seeded) EnvRunner
    in-process and yield ``num_blocks`` rollout blocks of
    ``steps_per_block`` env steps each. Each item is ``(batch, info)``:
    the flat GAE'd sample batch (plus a ``block_uid`` row column) and a
    small info dict (episode returns, ids).

    ``fault={"die_at_block": i, "marker": path}`` is the chaos hook: the
    first execution SIGKILLs its own worker right before yielding block
    ``i`` (and drops a marker file so the lineage replay runs through)."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    runner = EnvRunner(env_creator, module_spec, num_envs=num_envs,
                       gamma=gamma, lambda_=lambda_, seed=seed,
                       worker_index=worker_index)
    runner.set_weights(weights)
    blocks = runner.sample_blocks(num_blocks, steps_per_block)
    for b, batch in enumerate(blocks):
        if fault and b == fault.get("die_at_block"):
            import os
            import signal
            marker = fault.get("marker")
            if marker and not os.path.exists(marker):
                open(marker, "w").close()
                os.kill(os.getpid(), signal.SIGKILL)
        uid = block_uid(worker_index, b)
        batch["block_uid"] = np.full(len(batch["obs"]), uid, np.int64)
        info = {"worker_index": worker_index, "block": b, "uid": uid,
                "episode_returns": runner.episode_returns()}
        yield batch, info


_rollout_stream_remote = None


def _remote_rollout_stream():
    global _rollout_stream_remote
    if _rollout_stream_remote is None:
        _rollout_stream_remote = ray_tpu_torch.remote(
            num_cpus=1, num_returns="streaming")(rollout_stream)
    return _rollout_stream_remote


def make_rollout_streams(env_creator, module_spec, weights,
                         n_runners: int, num_blocks: int,
                         steps_per_block: int, *, num_envs: int = 1,
                         gamma: float = 0.99, lambda_: float = 0.95,
                         seed: int = 0, backpressure: int = 4,
                         faults: Optional[Dict[int, Dict]] = None
                         ) -> List[Any]:
    """Launch N rollout generator tasks; returns their
    ``ObjectRefGenerator``s. ``weights`` may be a value or an
    ``ObjectRef`` (put once, resolved at each runner). ``faults`` maps
    worker_index -> fault dict (see ``rollout_stream``)."""
    fn = _remote_rollout_stream()
    return [
        fn.options(generator_backpressure_num_objects=backpressure)
        .remote(env_creator, module_spec, weights, num_blocks,
                steps_per_block, num_envs, gamma, lambda_,
                seed, i, (faults or {}).get(i))
        for i in range(n_runners)]


def _concat_batches(batches: List[Dict[str, np.ndarray]]
                    ) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


def _nrows(batch: Dict[str, np.ndarray]) -> int:
    """Row count of a sample batch: every column shares the leading
    axis, so any column works; env batches key their rows by ``obs``,
    RLHF trajectory batches by ``tokens``."""
    if "obs" in batch:
        return len(batch["obs"])
    return len(next(iter(batch.values())))


class RolloutBlockStream:
    """Fan-in over N rollout streams: completion-order block iteration
    via ``wait_any``, minibatch re-chunking, and consumer-idle (bubble)
    accounting."""

    def __init__(self, generators: List[Any], collect: bool = False):
        self._gens = list(generators)
        self._collect = collect
        self.blocks: List[Dict[str, np.ndarray]] = []
        self.infos: List[Dict[str, Any]] = []
        self._wait_s = 0.0
        self._wall_t0: Optional[float] = None
        self._wall_s = 0.0
        self._rows = 0

    # ------------------------------------------------------------ blocks
    def iter_blocks(self, timeout: float = 600.0
                    ) -> Iterator[Tuple[Dict[str, np.ndarray],
                                        Dict[str, Any]]]:
        """Yield ``(batch, info)`` from whichever runner has one ready
        (completion order). Time blocked with nothing ready accrues to
        the measured rollout-to-train bubble."""
        from ray_tpu_torch.core.streaming import wait_any
        if self._wall_t0 is None:
            self._wall_t0 = time.perf_counter()
        pending = list(self._gens)
        deadline = time.monotonic() + timeout
        while pending:
            t0 = time.perf_counter()
            ready, _ = wait_any(pending, timeout=30.0)
            self._wait_s += time.perf_counter() - t0
            if not ready:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "no rollout block arrived before the deadline")
                continue
            for g in ready:
                try:
                    ref = g.next_ref(timeout=0.5)
                except StopIteration:
                    continue
                except Exception:
                    if g.is_finished():
                        raise
                    continue
                t0 = time.perf_counter()
                batch, info = ray_tpu_torch.get(ref)
                self._wait_s += time.perf_counter() - t0
                self._rows += _nrows(batch)
                if self._collect:
                    self.blocks.append(batch)
                self.infos.append(info)
                yield batch, info
            pending = [g for g in pending if not g.is_finished()]
        self._wall_s = time.perf_counter() - self._wall_t0

    # ----------------------------------------------------------- batches
    def iter_batches(self, batch_size: Optional[int] = None,
                     drop_last: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """The learner's consume edge: re-chunk the arriving blocks
        into fixed ``batch_size`` minibatches."""
        carry: List[Dict[str, np.ndarray]] = []
        carry_rows = 0
        for batch, _info in self.iter_blocks():
            if batch_size is None:
                yield batch
                continue
            carry.append(batch)
            carry_rows += _nrows(batch)
            while carry_rows >= batch_size:
                merged = _concat_batches(carry)
                n = _nrows(merged)
                yield {k: v[:batch_size] for k, v in merged.items()}
                rest = {k: v[batch_size:] for k, v in merged.items()}
                carry = [rest] if n > batch_size else []
                carry_rows = n - batch_size
        if batch_size is not None and carry_rows and not drop_last:
            yield _concat_batches(carry)

    # ------------------------------------------------------------- stats
    def full_batch(self) -> Dict[str, np.ndarray]:
        """All collected blocks as one batch (requires
        ``collect=True``); feeds the shuffled epochs after the
        streamed first pass."""
        if not self.blocks:
            raise ValueError("no blocks collected "
                             "(construct with collect=True)")
        return _concat_batches(self.blocks)

    def episode_returns(self) -> List[float]:
        out: List[float] = []
        for info in self.infos:
            out.extend(info.get("episode_returns", []))
        return out

    def delivered_uids(self) -> List[int]:
        return [info["uid"] for info in self.infos]

    def stats(self) -> Dict[str, float]:
        wall = self._wall_s or (
            time.perf_counter() - self._wall_t0
            if self._wall_t0 is not None else 0.0)
        return {
            "rows": self._rows,
            "blocks": len(self.infos),
            "wait_s": round(self._wait_s, 4),
            "wall_s": round(wall, 4),
            # fraction of the consume wall the learner sat idle
            # waiting on rollouts
            "bubble": round(self._wait_s / wall, 4) if wall > 0 else 0.0,
        }

    def close(self) -> None:
        for g in self._gens:
            try:
                g.close()
            except Exception:
                pass
