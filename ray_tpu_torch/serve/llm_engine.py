"""Continuous-batching LLM inference engine over the port's paged decode
path: the counterpart of ``ray_tpu/serve/llm_engine.py::LLMEngine``.

A paged KV cache in device memory (``models.transformer.init_kv_cache``),
a fixed array of **decode slots** stepped as ONE batched ``decode_step``
call, and **chunked prefill** interleaved between decode steps, so a new
arrival's time to first token never stalls in-flight streams for more
than one ``prefill_chunk``. New requests are admitted between steps
(continuous batching): a finishing stream frees its slot and blocks for
the next queued prompt at once.

Shapes are fixed at construction: ``decode_slots`` sequences per decode
call, ``prefill_chunk`` tokens per prefill call, one block table of
``blocks_per_seq`` entries per slot. Idle slots point at the reserved
trash block 0, so their decode writes never touch a live sequence.

Blocks are refcounted (:mod:`ray_tpu_torch.serve.prefix_cache`):
EOS/cancel/error decref instead of free; full prompt chunks are indexed
in a radix trie, so a request whose prompt shares a prefix skips
prefilling the matched blocks; a fully matched, block-aligned prompt
copies its last matched block (copy-on-write) so its final token still
runs through prefill for its logits.

Not ported yet (see ROADMAP): speculative decode, log-probability
capture, in-flight weight staging, disaggregated KV export/adopt and
the KV wire, warm-prefix export/import, request tracing, SLO and
metrics, and the ``LLMServer`` deployment behind ``serve.run``/HTTP.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.exceptions import EngineDeadError, RequestTooLargeError
from ray_tpu_torch.models.transformer import (decode_step, init_kv_cache,
                                              init_params, prefill,
                                              resolve_device)
from ray_tpu_torch.ops.paged_flash import paged_work_pages
from ray_tpu_torch.serve.prefix_cache import PrefixBlockPool


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the serving engine.

    - ``decode_slots``: sequences decoded per batched step.
    - ``kv_block_size``: tokens per KV-cache block (the kernel takes up
      to 32).
    - ``max_seq_len``: per-request window (prompt + generated tokens);
      sets ``blocks_per_seq``.
    - ``prefill_chunk``: prompt tokens processed per engine step.
    - ``num_kv_blocks``: KV pool size; 0 = full occupancy plus the
      reserved trash block.
    - ``enable_prefix_sharing``: refcounted radix-trie sharing of full
      prompt KV blocks.
    """
    decode_slots: int = 8
    kv_block_size: int = 16
    max_seq_len: int = 256
    prefill_chunk: int = 32
    num_kv_blocks: int = 0
    max_new_tokens: int = 64          # default per-request cap
    eos_token_id: Optional[int] = None
    enable_prefix_sharing: bool = True

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.kv_block_size)

    @property
    def resolved_num_blocks(self) -> int:
        if self.num_kv_blocks:
            return self.num_kv_blocks
        return 1 + self.decode_slots * self.blocks_per_seq

    def kv_bytes_per_token(self, model_config) -> int:
        """KV bytes per token: the device-memory side of the block math."""
        c = model_config
        itemsize = torch.empty((), dtype=c.dtype).element_size()
        return 2 * c.n_layers * c.kv_heads * c.head_dim * itemsize


_DONE = object()          # stream-end sentinel on the request queue

# request lifecycle states
_QUEUED, _PREFILL, _DECODE, _FINISHED = range(4)


class _Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "out", "state", "slot", "blocks", "prefill_pos",
                 "seq_len", "generated", "cancelled", "t_submit",
                 "t_first_token", "hit_blocks", "trie_node", "trie_cursor")

    def __init__(self, rid: int, prompt: List[int], max_new_tokens: int,
                 eos_token_id: Optional[int]):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.out: "queue.Queue" = queue.Queue()
        self.state = _QUEUED
        self.slot: Optional[int] = None
        self.blocks: List[int] = []
        self.prefill_pos = 0          # prompt tokens already in cache
        self.seq_len = 0              # cache positions written
        self.generated = 0            # tokens emitted
        self.cancelled = False
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        # -- prefix sharing (prefix_cache.PrefixBlockPool)
        self.hit_blocks = 0           # prompt blocks prefill skipped
        self.trie_node = None         # deepest trie node of this prompt
        self.trie_cursor = 0          # next full prompt block to index


class LLMEngine:
    """Continuous-batching scheduler over the paged decode path.

    Thread model: one background step thread owns the device state
    (cache and slot arrays); ``submit``/``cancel`` only touch the queue
    under a lock and are safe from any thread or event loop. Consumers
    read per-request ``queue.Queue``s fed by the step thread.

    ``device`` defaults to CUDA and raises when there is none; tests
    pass ``device="cpu"``.
    """

    def __init__(self, model_config, engine_config: Optional[EngineConfig]
                 = None, params=None, seed: int = 0, device=None):
        self.model_config = model_config
        self.config = engine_config or EngineConfig()
        ec = self.config
        if ec.prefill_chunk < 1 or ec.decode_slots < 1:
            raise ValueError("prefill_chunk and decode_slots must be >= 1")
        self.device = resolve_device(device)
        self._params = params if params is not None \
            else init_params(model_config, seed, self.device,
                             dtype=model_config.dtype)
        if self._params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {self._params['embed'].device}, the "
                f"engine runs on {self.device}")
        self._cache = init_kv_cache(model_config, ec.resolved_num_blocks,
                                    ec.kv_block_size, self.device)

        S, T = ec.decode_slots, ec.blocks_per_seq
        # Host-side slot arrays. Block-table row 0s point idle slots at
        # the reserved trash block.
        self._block_tables = np.zeros((S, T), np.int32)
        self._seq_lens = np.zeros((S,), np.int32)
        self._last_tok = np.zeros((S,), np.int32)
        self._slots: List[Optional[_Request]] = [None] * S
        self._free_slots = list(range(S))
        # refcounted block pool + radix prefix index (block 0 = trash)
        self._pool = PrefixBlockPool(ec.resolved_num_blocks,
                                     ec.kv_block_size, reserved=(0,))

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._prefilling: "collections.deque[_Request]" = \
            collections.deque()
        self._rid = 0
        self._stop = False
        self._dead: Optional[BaseException] = None

        # -- stats ------------------------------------------------------
        self._tokens_total = 0
        self._decode_steps = 0
        self._prefill_chunks = 0
        self._decode_wall_s = 0.0
        self._prefill_wall_s = 0.0
        # pages the paged kernel reads per decode step vs the window
        self._decode_pages_live = 0
        self._decode_pages_window = 0
        self._prompt_blocks_total = 0
        self._cow_copies = 0
        self._occupancy: Dict[int, int] = collections.defaultdict(int)
        self._t_start = time.monotonic()
        self._ttft_ewma: Optional[float] = None

        from concurrent.futures import ThreadPoolExecutor
        self._poll_pool = ThreadPoolExecutor(
            2 * ec.decode_slots + 4, thread_name_prefix="llm-engine-poll")
        self._thread = threading.Thread(
            target=self._run, name="llm-engine-step", daemon=True)
        self._thread.start()

    # ----------------------------------------------------- device calls
    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_fn(self, tokens, bt, start, lens) -> np.ndarray:
        logits, self._cache = prefill(self.model_config, self._params,
                                      tokens, self._cache, bt, start, lens)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      lens.long() - 1]
        return torch.argmax(last, dim=-1).cpu().numpy()

    def _decode_fn(self, toks, bt, seq_lens) -> np.ndarray:
        logits, self._cache = decode_step(self.model_config, self._params,
                                          toks, self._cache, bt, seq_lens)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src``'s k/v copied to ``dst`` across all
        layers, in place."""
        s = torch.tensor([src], device=self.device)
        d = torch.tensor([dst], device=self.device)
        for name in ("k", "v"):
            c = self._cache[name]
            c.index_copy_(1, d, c.index_select(1, s))

    # ------------------------------------------------------- public API
    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None) -> _Request:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        ec = self.config
        if len(prompt) + 1 > ec.max_seq_len:
            raise RequestTooLargeError(
                f"prompt of {len(prompt)} tokens + 1 exceeds the engine "
                f"window max_seq_len={ec.max_seq_len}")
        mnt = max_new_tokens if max_new_tokens is not None \
            else ec.max_new_tokens
        eos = eos_token_id if eos_token_id is not None else ec.eos_token_id
        with self._work:
            if self._dead is not None:
                raise EngineDeadError(
                    f"engine step loop died: {self._dead!r}")
            self._rid += 1
            req = _Request(self._rid, prompt, max(1, int(mnt)), eos)
            self._pending.append(req)
            self._work.notify_all()
        return req

    def cancel(self, req: _Request) -> None:
        """Mark a request cancelled; the step thread frees its slot and
        blocks at the next step boundary."""
        with self._work:
            req.cancelled = True
            self._work.notify_all()

    async def generate(self, prompt_ids: Sequence[int],
                       max_new_tokens: Optional[int] = None,
                       eos_token_id: Optional[int] = None):
        """Async token stream for one request. Raises typed errors
        instead of hanging; early ``aclose()`` cancels the request and
        frees its slot and blocks."""
        req = self.submit(prompt_ids, max_new_tokens, eos_token_id)
        loop = asyncio.get_running_loop()
        get = functools.partial(req.out.get, timeout=0.2)
        try:
            while True:
                try:
                    item = await loop.run_in_executor(self._poll_pool, get)
                except queue.Empty:
                    if self._dead is not None:
                        raise EngineDeadError(
                            f"engine step loop died: {self._dead!r}")
                    continue
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.cancel(req)

    def generate_sync(self, prompt_ids: Sequence[int],
                      max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None,
                      timeout_s: float = 120.0):
        """Blocking token stream."""
        req = self.submit(prompt_ids, max_new_tokens, eos_token_id)
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                try:
                    item = req.out.get(timeout=0.2)
                except queue.Empty:
                    if self._dead is not None:
                        raise EngineDeadError(
                            f"engine step loop died: {self._dead!r}")
                    if time.monotonic() > deadline:
                        raise TimeoutError("generate_sync timed out")
                    continue
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.cancel(req)

    def stats(self) -> Dict:
        """Scheduler counters: queue depth, batch occupancy histogram,
        tokens/s, prefix sharing, and the leak-check views of the slot
        and block free lists."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t_start, 1e-9)
            ps = self._pool.stats()
            hit_rate = (round(ps["hits_total"]
                              / self._prompt_blocks_total, 4)
                        if self._prompt_blocks_total else None)
            return {
                "queue_depth": len(self._pending),
                "prefilling": len(self._prefilling),
                "active_slots": sum(1 for r in self._slots
                                    if r is not None),
                "free_slots": len(self._free_slots),
                "free_blocks": ps["reclaimable"],
                "blocks_cached": ps["cached"],
                "blocks_shared": ps["shared"],
                "total_blocks": self.config.resolved_num_blocks - 1,
                "prefix_hit_blocks_total": ps["hits_total"],
                "prompt_blocks_total": self._prompt_blocks_total,
                "prefix_hit_rate": hit_rate,
                "prefix_evictions_total": ps["evictions_total"],
                "cow_copies_total": self._cow_copies,
                "tokens_total": self._tokens_total,
                "tokens_per_s": round(self._tokens_total / elapsed, 2),
                "decode_steps": self._decode_steps,
                "prefill_chunks": self._prefill_chunks,
                "decode_wall_s": round(self._decode_wall_s, 4),
                "prefill_wall_s": round(self._prefill_wall_s, 4),
                "decode_pages_live": self._decode_pages_live,
                "decode_pages_window": self._decode_pages_window,
                "decode_block_work_frac": (
                    round(self._decode_pages_live
                          / self._decode_pages_window, 4)
                    if self._decode_pages_window else None),
                "kv_block_size": self.config.kv_block_size,
                "paged_impl": self.model_config.paged_impl,
                "occupancy_hist": dict(self._occupancy),
                "ttft_ewma_s": (round(self._ttft_ewma, 6)
                                if self._ttft_ewma is not None else None),
                "dead": repr(self._dead) if self._dead else None,
            }

    def pool_audit(self) -> List[str]:
        """Block-accounting integrity check: empty list = every block is
        exactly one of free/active/cached and the trie holds no dangling
        entries."""
        with self._lock:
            return self._pool.audit()

    def shutdown(self) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._thread.join(timeout=10)
        self._poll_pool.shutdown(wait=False)

    # -------------------------------------------------------- step loop
    def _run(self) -> None:
        try:
            with torch.inference_mode():
                while True:
                    with self._work:
                        while not self._stop \
                                and not self._has_work_locked():
                            self._work.wait(timeout=0.5)
                        if self._stop:
                            break
                    self._step()
        except BaseException as e:  # noqa: BLE001 — fail typed, never hang
            self._on_dead(e)

    def _has_work_locked(self) -> bool:
        return bool(self._pending) or bool(self._prefilling) \
            or any(r is not None for r in self._slots)

    def _on_dead(self, e: BaseException) -> None:
        with self._work:
            self._dead = e
            reqs = [r for r in self._slots if r is not None]
            reqs += list(self._prefilling) + list(self._pending)
            self._pending.clear()
            self._prefilling.clear()
        err = EngineDeadError(f"engine step loop died: {e!r}")
        err.__cause__ = e
        for r in set(reqs):
            r.out.put(err)

    # one engine step: reap -> admit -> one prefill chunk -> one decode
    def _step(self) -> None:
        self._reap_cancelled()
        self._admit()
        self._prefill_one_chunk()
        self._decode_once()

    def _reap_cancelled(self) -> None:
        with self._lock:
            for req in list(self._prefilling):
                if req.cancelled:
                    self._prefilling.remove(req)
                    self._release_locked(req)
            for req in list(self._pending):
                if req.cancelled:
                    self._pending.remove(req)
                    req.out.put(_DONE)
            for req in self._slots:
                if req is not None and req.cancelled:
                    self._release_locked(req)

    def _admit(self) -> None:
        ec = self.config
        bs = ec.kv_block_size
        while True:
            with self._lock:
                if not self._pending or not self._free_slots:
                    return
                req = self._pending[0]
                plen = len(req.prompt)
                need = -(-min(plen + req.max_new_tokens,
                              ec.max_seq_len) // bs)
                # radix prefix match: matched full blocks are shared and
                # skip prefill; a fully matched block-aligned prompt
                # keeps its LAST matched block as a copy-on-write source
                # so the final token still runs through prefill
                matched: List[int] = []
                mtok = 0
                cow_src = None
                if ec.enable_prefix_sharing:
                    matched, mtok, req.trie_node = \
                        self._pool.match_prefix(req.prompt)
                    if mtok == plen and matched:
                        cow_src = matched.pop()
                        mtok -= bs
                n_priv = need - len(matched) - (1 if cow_src is not None
                                                else 0)
                priv = self._pool.allocate(n_priv)
                if priv is None:
                    # full occupancy: release the match and wait
                    self._pool.release(matched)
                    if cow_src is not None:
                        self._pool.release([cow_src])
                    req.trie_node = None
                    return
                cow_dst = None
                if cow_src is not None:
                    cow_dst = priv[0]
                    priv = priv[1:]
                    self._cow_copies += 1
                req.blocks = matched + \
                    ([cow_dst] if cow_dst is not None else []) + priv
                req.hit_blocks = len(matched) + \
                    (1 if cow_src is not None else 0)
                self._pool.count_hits(req.hit_blocks)
                req.trie_cursor = req.hit_blocks
                req.prefill_pos = (plen - 1) if cow_src is not None \
                    else mtok
                self._prompt_blocks_total += -(-plen // bs)
                self._pending.popleft()
                req.slot = self._free_slots.pop()
                self._block_tables[req.slot, :] = 0
                self._block_tables[req.slot, :len(req.blocks)] = \
                    req.blocks
                self._seq_lens[req.slot] = 0
                req.state = _PREFILL
                self._slots[req.slot] = req
                self._prefilling.append(req)
            # device-side copy outside the lock (the step thread is the
            # only device user; submit/cancel stay responsive)
            if cow_src is not None:
                self._copy_block(cow_src, cow_dst)
                with self._lock:
                    self._pool.release([cow_src])

    def _prefill_one_chunk(self) -> None:
        with self._lock:
            req = self._prefilling[0] if self._prefilling else None
        if req is None:
            return
        ec = self.config
        C = ec.prefill_chunk
        start = req.prefill_pos
        n = min(C, len(req.prompt) - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = req.prompt[start:start + n]
        t0 = time.monotonic()
        tok = self._prefill_fn(
            self._tensor(chunk),
            self._tensor(self._block_tables[req.slot:req.slot + 1]),
            self._tensor(np.full((1,), start, np.int32)),
            self._tensor(np.full((1,), n, np.int32)))
        self._prefill_wall_s += time.monotonic() - t0
        req.prefill_pos += n
        self._prefill_chunks += 1
        # index newly completed FULL prompt blocks in the radix trie; a
        # lost insert race keeps our block private
        if req.trie_node is not None:
            with self._lock:
                while req.trie_node is not None and \
                        (req.trie_cursor + 1) * ec.kv_block_size \
                        <= req.prefill_pos:
                    i = req.trie_cursor
                    blk = req.prompt[i * ec.kv_block_size:
                                     (i + 1) * ec.kv_block_size]
                    node, _ = self._pool.insert_child(
                        req.trie_node, blk, req.blocks[i])
                    req.trie_node = node   # None = parent evicted: stop
                    req.trie_cursor += 1
        if req.prefill_pos < len(req.prompt):
            return
        # prompt fully cached: the final chunk's last logits give the
        # first generated token
        first = int(tok[0])
        req.seq_len = len(req.prompt)
        req.t_first_token = time.monotonic()
        ttft = req.t_first_token - req.t_submit
        self._ttft_ewma = ttft if self._ttft_ewma is None \
            else 0.8 * self._ttft_ewma + 0.2 * ttft
        with self._lock:
            self._prefilling.popleft()
            if req.cancelled:
                self._release_locked(req)
                return
            if req.eos_token_id is not None and first == req.eos_token_id:
                self._release_locked(req)
                return
            req.generated = 1
            req.out.put(first)
            self._tokens_total += 1
            if req.generated >= req.max_new_tokens:
                self._release_locked(req)
                return
            req.state = _DECODE
            self._last_tok[req.slot] = first
            self._seq_lens[req.slot] = req.seq_len

    def _decode_once(self) -> None:
        with self._lock:
            active = [r for r in self._slots
                      if r is not None and r.state == _DECODE]
            if not active:
                return
            self._decode_steps += 1
            self._occupancy[len(active)] += 1
            toks = self._last_tok.copy()
            lens = self._seq_lens.copy()
            bt = self._block_tables.copy()
        ec = self.config
        self._decode_pages_live += int(paged_work_pages(
            lens.astype(np.int64) + 1, ec.kv_block_size).sum())
        self._decode_pages_window += ec.decode_slots * ec.blocks_per_seq
        t0 = time.monotonic()
        out = self._decode_fn(self._tensor(toks), self._tensor(bt),
                              self._tensor(lens))
        self._decode_wall_s += time.monotonic() - t0
        with self._lock:
            for req in active:
                if req.cancelled or self._slots[req.slot] is not req:
                    continue
                tok = int(out[req.slot])
                req.seq_len += 1           # the token we just wrote
                self._seq_lens[req.slot] = req.seq_len
                if req.eos_token_id is not None \
                        and tok == req.eos_token_id:
                    self._release_locked(req)
                    continue
                req.generated += 1
                req.out.put(tok)
                self._tokens_total += 1
                if req.generated >= req.max_new_tokens \
                        or req.seq_len + 1 >= ec.max_seq_len:
                    self._release_locked(req)
                else:
                    self._last_tok[req.slot] = tok

    def _release_locked(self, req: _Request) -> None:
        """Return a request's slot and blocks to the free lists and close
        its stream (call with self._lock held)."""
        if req.slot is not None and self._slots[req.slot] is req:
            self._slots[req.slot] = None
            self._block_tables[req.slot, :] = 0
            self._seq_lens[req.slot] = 0
            self._last_tok[req.slot] = 0
            self._free_slots.append(req.slot)
            # decref, not free: trie-indexed blocks stay warm
            self._pool.release(req.blocks)
            req.blocks = []
            req.slot = None
            req.trie_node = None
        req.state = _FINISHED
        req.out.put(_DONE)
        self._work.notify_all()
