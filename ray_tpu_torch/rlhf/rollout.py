"""The serving engine as the PPO rollout backend: the port's copy of
``ray_tpu/rlhf/rollout.py``, over the port's ``LLMEngine`` (the paged
kernel on the card).

Two rollout paths share one trajectory-block schema:

- :class:`RolloutEngine` — in-process ``LLMEngine`` replicas doing
  continuous batching: every request carries the shared system prompt
  (the radix-trie prefix cache skips re-prefilling it), streams
  ``(token, policy_version, logprob)`` via ``detailed`` submission, and
  tolerates **in-flight weight refresh**: a publish landing mid-round
  changes the version stamps of later tokens of still-decoding
  trajectories. Admission of each new trajectory is gated by the
  ``max_weight_lag`` staleness bound. The port's engine drops its
  prefix index at a weight swap (the JAX engine keeps it: ROADMAP
  Queue 3) and prefills the system prompt again on the new weights
  before the next admission, so a trajectory admitted after a swap
  matches it.
- :func:`rlhf_rollout_blocks` — a **streaming generator task**
  (``num_returns="streaming"``), deterministic in its arguments
  (engine built from a version-stamped packed weight payload, one
  trajectory at a time, syncs applied at fixed block boundaries), so a
  mid-rollout SIGKILL lineage-replays the block prefix with
  bit-identical tokens AND version stamps, and the owner's dedup
  delivers every block exactly once.

Trajectory blocks are ``(batch, info)`` like env rollout blocks, with
fixed-shape rows: ``prompt (1, P)``, ``tokens/logprobs/versions
(1, T)``, ``advantages (1,)``, ``block_uid (1,)``. Fixed ``T``
(``eos=None``) keeps every learner update at one shape.

Devices: ``device=None`` is the card and raises without one, except in
a runtime worker on the CPU platform (``RAY_TPU_TORCH_PLATFORM=cpu``),
where it is the CPU, as for ``LLMServer``. Weights arrive as numpy trees
(a learner's ``get_weights``) and are carried into the engine's dtype on
its device by :func:`ray_tpu_torch._bridge.params_from_jax`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.exceptions import EngineDeadError
from ray_tpu_torch.models.transformer import TransformerConfig, init_params
from ray_tpu_torch.rlhf.config import RLHFConfig
from ray_tpu_torch.rlhf.weight_sync import await_version, unpack_weights
from ray_tpu_torch.rllib.rollout_stream import (_concat_batches, _nrows,
                                                block_uid)
from ray_tpu_torch.serve import llm_engine as _llm_engine
from ray_tpu_torch.serve.llm_engine import (_DONE, EngineConfig, LLMEngine,
                                            _resolve_dtype)
from ray_tpu_torch.serve.request_trace import new_request_id


def _distinct_reward(tokens: List[int]) -> float:
    """Default deterministic sequence reward: distinct-token fraction
    (rewards diverse generations, punishes the degenerate repeats
    greedy decoding of a tiny model loves). Deterministic in the
    trajectory, so lineage replay reproduces advantages exactly."""
    return len(set(tokens)) / max(1, len(tokens))


class LocalBlockStream:
    """Queue-fed twin of ``RolloutBlockStream`` for in-process
    producers: same consume edge (``iter_blocks`` / ``iter_batches`` /
    ``full_batch`` / bubble accounting), fed by ``push`` from the
    rollout drain threads instead of ``wait_any`` over generators."""

    _SENTINEL = object()

    def __init__(self, collect: bool = False):
        self._q: "queue.Queue" = queue.Queue()
        self._collect = collect
        self.blocks: List[Dict[str, np.ndarray]] = []
        self.infos: List[Dict[str, Any]] = []
        self._wait_s = 0.0
        self._wall_t0: Optional[float] = None
        self._wall_s = 0.0
        self._rows = 0
        self._err: Optional[BaseException] = None

    # ---------------------------------------------------- producer edge
    def push(self, batch: Dict[str, np.ndarray],
             info: Dict[str, Any]) -> None:
        self._q.put((batch, info))

    def finish(self, err: Optional[BaseException] = None) -> None:
        self._err = err
        self._q.put(self._SENTINEL)

    # ---------------------------------------------------- consumer edge
    def iter_blocks(self, timeout: float = 600.0
                    ) -> Iterator[Tuple[Dict[str, np.ndarray],
                                        Dict[str, Any]]]:
        if self._wall_t0 is None:
            self._wall_t0 = time.perf_counter()
        deadline = time.monotonic() + timeout
        while True:
            t0 = time.perf_counter()
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                self._wait_s += time.perf_counter() - t0
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "no rollout block arrived before the deadline")
                continue
            self._wait_s += time.perf_counter() - t0
            if item is self._SENTINEL:
                break
            batch, info = item
            self._rows += _nrows(batch)
            if self._collect:
                self.blocks.append(batch)
            self.infos.append(info)
            yield batch, info
        self._wall_s = time.perf_counter() - self._wall_t0
        if self._err is not None:
            raise self._err

    def iter_batches(self, batch_size: Optional[int] = None,
                     drop_last: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
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

    def full_batch(self) -> Dict[str, np.ndarray]:
        if not self.blocks:
            raise ValueError("no blocks collected "
                             "(construct with collect=True)")
        return _concat_batches(self.blocks)

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
            "bubble": round(self._wait_s / wall, 4) if wall > 0
            else 0.0,
        }

    def close(self) -> None:
        pass


class RolloutEngine:
    """The generation side of PPO over a fleet of in-process serving
    engines (the anakin path; sebulba's remote twin is the
    :func:`rlhf_rollout_blocks` generator-task fleet).

    Every trajectory request is ``system_prompt + suffix`` — the radix
    trie serves the shared prefix from cache after the first request
    per engine, so rollout prefill cost is ~one suffix per trajectory
    (the engine holds a trajectory back while another one is prefilling
    the prompt they share). ``stream_round`` admits
    trajectories under the staleness gate and streams completed
    trajectory blocks in completion order. ``device`` is the engines'
    (see the module's docstring).
    """

    def __init__(self, config: RLHFConfig, params=None,
                 recorder=None, device=None):
        self.config = config
        model = config.model_config()
        model["dtype"] = _resolve_dtype(model["dtype"])
        self.model_config = TransformerConfig(**model)
        ec = EngineConfig(**config.engine_config())
        self.device = _llm_engine._server_device(device)
        if params is None:
            tree = init_params(self.model_config, config.seed, self.device,
                               dtype=self.model_config.dtype)
        else:
            tree = params_from_jax(params, self.model_config, self.device)
        # the engines share one read-only tree
        self.engines = [
            LLMEngine(self.model_config, ec, params=tree,
                      device=self.device, replica_tag=f"rlhf-engine-{i}")
            for i in range(config.num_engines)]
        self._recorder = recorder
        self._lock = threading.Lock()
        self._seq = 0                  # global trajectory counter
        self._round = 0
        self._staleness: List[int] = []
        self._baseline: Optional[float] = None
        self.reward_fn: Callable[[List[int]], float] = _distinct_reward
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(
            config.num_engines * ec.decode_slots + 4,
            thread_name_prefix="rlhf-rollout")

    # ----------------------------------------------------------- state
    @property
    def weight_version(self) -> int:
        """Slowest engine's policy version (the staleness gate's
        denominator — admission waits for the laggard)."""
        return min(e.weight_version for e in self.engines)

    # ----------------------------------------------------------- round
    def stream_round(self, suffixes: List[List[int]],
                     learner_version_fn: Optional[Callable[[], int]]
                     = None,
                     collect: bool = False,
                     admit_timeout_s: float = 60.0
                     ) -> LocalBlockStream:
        """Launch one rollout round; returns the block stream
        immediately (blocks arrive in completion order). Each
        trajectory is admitted to its engine only while
        ``learner_version - engine_version <= max_weight_lag``; the
        observed lag at admission is the round's staleness sample
        set."""
        stream = LocalBlockStream(collect=collect)
        self._pool.submit(self._feed_round, list(suffixes),
                          learner_version_fn, admit_timeout_s, stream)
        return stream

    def _feed_round(self, suffixes, learner_version_fn,
                    admit_timeout_s, stream) -> None:
        cfg = self.config
        try:
            self._round += 1
            rnd = self._round
            futs = []
            for j, suffix in enumerate(suffixes):
                eng = self.engines[j % len(self.engines)]
                if learner_version_fn is not None:
                    deadline = time.monotonic() + admit_timeout_s
                    while (learner_version_fn() - eng.weight_version
                           > cfg.max_weight_lag):
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                "staleness gate starved: engine never "
                                "caught up within max_weight_lag="
                                f"{cfg.max_weight_lag}")
                        time.sleep(0.002)
                    lag = max(0, learner_version_fn()
                              - eng.weight_version)
                else:
                    lag = 0
                with self._lock:
                    self._staleness.append(lag)
                    seq = self._seq
                    self._seq += 1
                prompt = list(cfg.system_prompt) + [int(t)
                                                    for t in suffix]
                # every trajectory is a traced serve request: the
                # engine keeps its own 1-in-N tail sample, but the
                # round's RLHF_ROLLOUT event names the slowest
                # trajectory's request_id so `ray-tpu trace` can open
                # its waterfall from the flight recorder
                rid = new_request_id()
                req = eng.submit(prompt, cfg.max_new_tokens,
                                 eos_token_id=None, detailed=True,
                                 trace_ctx={"request_id": rid,
                                            "policy": "rlhf",
                                            "admission": "bypass",
                                            "enqueue_ts": time.time()})
                futs.append(self._pool.submit(
                    self._drain, j % len(self.engines), seq, prompt,
                    req, eng, stream, rid))
            tokens = 0
            versions: set = set()
            slowest_rid, slowest_s = None, -1.0
            for f in futs:
                n_tok, vers, rid, dur_s = f.result()
                tokens += n_tok
                versions |= vers
                if dur_s > slowest_s:
                    slowest_rid, slowest_s = rid, dur_s
            if self._recorder is not None:
                try:
                    self._recorder.record(
                        "RLHF_ROLLOUT", round=rnd,
                        trajectories=len(suffixes), tokens=tokens,
                        policy_versions=sorted(versions),
                        slowest_request_id=slowest_rid,
                        slowest_s=round(max(slowest_s, 0.0), 6))
                except Exception:
                    pass
            stream.finish()
        except BaseException as e:  # noqa: BLE001 — surface, never hang
            stream.finish(err=e)

    def _drain(self, engine_idx: int, seq: int, prompt: List[int],
               req, eng, stream: LocalBlockStream,
               request_id: Optional[str] = None
               ) -> Tuple[int, set, Optional[str], float]:
        t_start = time.monotonic()
        toks: List[int] = []
        vers: List[int] = []
        lps: List[float] = []
        while True:
            try:
                item = req.out.get(timeout=0.5)
            except queue.Empty:
                if eng._dead is not None:
                    raise EngineDeadError(
                        f"engine step loop died: {eng._dead!r}")
                continue
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            tok, ver, lp = item
            toks.append(int(tok))
            vers.append(int(ver))
            lps.append(float(lp) if lp is not None else 0.0)
        T = self.config.max_new_tokens
        if len(toks) != T:
            raise RuntimeError(
                f"trajectory {seq} has {len(toks)} tokens, expected "
                f"{T} (fixed-length rollouts need eos=None)")
        reward = float(self.reward_fn(toks))
        with self._lock:
            base = self._baseline if self._baseline is not None \
                else reward
            adv = reward - base
            self._baseline = 0.9 * base + 0.1 * reward
        uid = block_uid(engine_idx, seq)
        batch = {
            "prompt": np.asarray([prompt], np.int32),
            "tokens": np.asarray([toks], np.int32),
            "logprobs": np.asarray([lps], np.float32),
            "versions": np.asarray([vers], np.int32),
            "advantages": np.asarray([adv], np.float32),
            "block_uid": np.full((1,), uid, np.int64),
        }
        info = {"uid": uid, "worker_index": engine_idx,
                "shard_key": seq, "block": seq, "reward": reward,
                "versions": sorted(set(vers)),
                "request_id": request_id}
        stream.push(batch, info)
        return T, set(vers), request_id, time.monotonic() - t_start

    # ----------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        eng = [e.stats() for e in self.engines]
        with self._lock:
            lags = list(self._staleness)
            n_traj = self._seq
        hits = sum(s["prefix_hit_blocks_total"] for s in eng)
        blocks = sum(s["prompt_blocks_total"] for s in eng)
        return {
            "trajectories": n_traj,
            "tokens_total": sum(s["tokens_total"] for s in eng),
            "prefix_hit_rate": (round(hits / blocks, 4) if blocks
                                else None),
            "prompt_blocks_total": blocks,
            "rewarm_blocks": sum(s["rewarm_blocks"] for s in eng),
            "weight_version": self.weight_version,
            "weight_swaps": sum(s["weight_swaps"] for s in eng),
            "weight_swap_wall_s": round(
                sum(s["weight_swap_wall_s"] for s in eng), 6),
            "sync_stall_s": round(
                sum(s["sync_stall_s"] for s in eng), 6),
            "staleness_samples": len(lags),
            "staleness_p50": (float(np.percentile(lags, 50))
                              if lags else None),
            "staleness_p99": (float(np.percentile(lags, 99))
                              if lags else None),
            "staleness_max": max(lags) if lags else None,
            "engines": eng,
        }

    def pool_audit(self) -> List[str]:
        out: List[str] = []
        for i, e in enumerate(self.engines):
            out.extend(f"engine{i}: {line}" for line in e.pool_audit())
        return out

    def shutdown(self) -> None:
        for e in self.engines:
            try:
                e.shutdown()
            except Exception:
                pass
        self._pool.shutdown(wait=False)


# ------------------------------------------------- generator-task path
def rlhf_rollout_blocks(model: Dict[str, Any], engine: Dict[str, Any],
                        packed_weights: Dict[str, Any],
                        suffixes: List[List[int]],
                        system_prompt: List[int],
                        max_new_tokens: int,
                        worker_index: int = 0,
                        syncs: Optional[Dict[int, Dict[str, Any]]]
                        = None,
                        fault: Optional[Dict[str, Any]] = None):
    """Generator-task body for the disaggregated (sebulba) rollout
    fleet: build a private engine from the version-stamped int8 packed
    weights, generate one trajectory per suffix, and yield ``(batch,
    info)`` blocks. Deterministic in its arguments — greedy decode from
    packed weights, ``syncs`` (block index → packed payload) applied at
    fixed block boundaries and *awaited* before the next trajectory —
    so a SIGKILL mid-round lineage-replays the prefix with identical
    tokens and identical per-token version stamps, and the streaming
    owner's dedup delivers each block exactly once.

    ``fault={"die_at_block": i, "marker": path}`` is the same chaos
    hook ``rollout_stream`` carries: first execution SIGKILLs its own
    worker right before yielding block ``i``."""
    model = dict(model)
    model["dtype"] = _resolve_dtype(model.get("dtype", "float32"))
    cfg = TransformerConfig(**model)
    ec = dict(engine)
    ec["capture_logprobs"] = True
    ec["spec_tokens"] = 0
    dev = _llm_engine._server_device(None)
    params, version = unpack_weights(packed_weights, dev)
    tree = params_from_jax(params, cfg, dev)
    eng = LLMEngine(cfg, EngineConfig(**ec), params=tree, device=dev,
                    replica_tag=f"rlhf-gen-{worker_index}")
    eng.stage_weights(tree, version)

    await_version(eng, version, timeout_s=30.0)
    baseline: Optional[float] = None
    try:
        for b, suffix in enumerate(suffixes):
            if syncs and b in syncs:
                p2, v2 = unpack_weights(syncs[b], dev)
                eng.stage_weights(params_from_jax(p2, cfg, dev), v2)
                await_version(eng, v2, timeout_s=30.0)
            if fault and b == fault.get("die_at_block"):
                import os
                marker = fault.get("marker")
                if marker and not os.path.exists(marker):
                    open(marker, "w").close()
                    os.kill(os.getpid(),
                            __import__("signal").SIGKILL)
            prompt = [int(t) for t in system_prompt] + \
                [int(t) for t in suffix]
            rid = new_request_id()
            items = list(eng.generate_sync(
                prompt, max_new_tokens, eos_token_id=None,
                detailed=True,
                trace_ctx={"request_id": rid, "policy": "rlhf",
                           "admission": "bypass",
                           "enqueue_ts": time.time()}))
            toks = [int(t) for t, _v, _l in items]
            vers = [int(v) for _t, v, _l in items]
            lps = [float(l) if l is not None else 0.0
                   for _t, _v, l in items]
            reward = _distinct_reward(toks)
            base = baseline if baseline is not None else reward
            adv = reward - base
            baseline = 0.9 * base + 0.1 * reward
            uid = block_uid(worker_index, b)
            batch = {
                "prompt": np.asarray([prompt], np.int32),
                "tokens": np.asarray([toks], np.int32),
                "logprobs": np.asarray([lps], np.float32),
                "versions": np.asarray([vers], np.int32),
                "advantages": np.asarray([adv], np.float32),
                "block_uid": np.full((1,), uid, np.int64),
            }
            info = {"uid": uid, "worker_index": worker_index,
                    "block": b, "reward": reward,
                    "versions": sorted(set(vers))}
            yield batch, info
    finally:
        eng.shutdown()


_rlhf_stream_remote = None


def _remote_rlhf_stream():
    global _rlhf_stream_remote
    if _rlhf_stream_remote is None:
        _rlhf_stream_remote = ray_tpu_torch.remote(
            num_cpus=1, num_returns="streaming")(rlhf_rollout_blocks)
    return _rlhf_stream_remote


def make_rlhf_rollout_streams(model: Dict[str, Any],
                              engine: Dict[str, Any],
                              packed_weights: Dict[str, Any],
                              suffixes_per_worker: List[List[List[int]]],
                              system_prompt: List[int],
                              max_new_tokens: int, *,
                              backpressure: int = 4,
                              syncs: Optional[Dict[int, Dict]] = None,
                              faults: Optional[Dict[int, Dict]] = None
                              ) -> List[Any]:
    """Launch one :func:`rlhf_rollout_blocks` generator task per
    worker; returns their ``ObjectRefGenerator``s (feed them to
    ``RolloutBlockStream`` for ``wait_any`` fan-in). ``syncs`` /
    ``faults`` map worker_index → per-worker dicts."""
    fn = _remote_rlhf_stream()
    return [
        fn.options(generator_backpressure_num_objects=backpressure)
        .remote(model, engine, packed_weights, sfx, system_prompt,
                max_new_tokens, i, (syncs or {}).get(i),
                (faults or {}).get(i))
        for i, sfx in enumerate(suffixes_per_worker)]
