"""Rollout-to-train streaming dataflow: the parts of
``ray_tpu/rllib/rollout_stream.py`` that RLHF reads.

``RolloutBlockStream`` is the fan-in consumer edge over N streaming
generator tasks (``num_returns="streaming"``): ``wait_any`` surfaces
whichever producer has a block buffered (one straggler never stalls the
learner), blocks re-chunk into fixed minibatches through
``iter_batches``, and the time the consumer spends blocked with no block
ready is measured as the rollout-to-train bubble. ``block_uid`` is the
per-(producer, block) id that makes exactly-once delivery assertable end
to end.

Not ported yet: ``RandomEnv``, ``rollout_stream`` and
``make_rollout_streams``, which read the env runner and ``RLModule``
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch


def block_uid(worker_index: int, block: int) -> int:
    """Stable per-(runner, block) id carried as a row column so
    exactly-once delivery is assertable end to end."""
    return worker_index * 1_000_000 + block


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
