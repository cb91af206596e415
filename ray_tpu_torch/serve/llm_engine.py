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

Speculative decode (``spec_tokens > 0``): each decode step drafts up to
k tokens per slot by prompt lookup (the most recent earlier occurrence
of the sequence's trailing n-gram; no draft model), verifies them in ONE
``prefill`` call over the whole slot array at ``(slots, k+1)``, through
the same paged kernel, and accepts the longest draft prefix that matches
the model's own greedy argmax, plus one token: the emitted tokens are
those of one-token decode. A per-slot acceptance EWMA turns drafting off
for sequences it does not pay for.

Also: the selected token's log-probability (``capture_logprobs``, for
``detailed`` streams of ``(token, weight_version, logprob)``), in-flight
weight staging (``stage_weights``: a pointer swap between steps, no slot
drained), the disaggregated KV hand-off (``prefill_export`` /
``submit_adopt`` over the wire codec of :mod:`ray_tpu_torch.serve.
disagg`), warm-prefix export and import, per-request tracing with the
SLO watchdog (:mod:`ray_tpu_torch.serve.request_trace`,
:mod:`ray_tpu_torch.serve.slo`) and the serve metrics
(:mod:`ray_tpu_torch.core.metric_defs`).

Inside a runtime worker (a serve replica) the engine also records its
events on the worker's flight recorder (``PREFIX_MIGRATE``,
``RLHF_SYNC``, ``KV_ADOPT``, ``KV_SHIP``, ``ENGINE_TTFT``,
``ENGINE_STATS``), takes its tracer and SLO budgets from the worker's
config, ships traces to the controller's store, and paces the worker's
fleet metrics reports. Outside a runtime none of these exist and the
engine behaves the same otherwise.

:class:`LLMServer` is the deployment-facing wrapper that ``serve.run``,
the HTTP proxy and the disaggregated router drive.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.core.global_state import try_global_worker
from ray_tpu_torch.core.metric_defs import runtime_metrics
from ray_tpu_torch.exceptions import EngineDeadError, RequestTooLargeError
from ray_tpu_torch.models.transformer import (decode_step, init_kv_cache,
                                              init_params, prefill,
                                              resolve_device)
from ray_tpu_torch.ops.paged_flash import paged_work_pages
from ray_tpu_torch.serve import request_trace as RT
from ray_tpu_torch.serve.disagg import pack_kv_blocks, unpack_kv_blocks
from ray_tpu_torch.serve.prefix_cache import PrefixBlockPool
from ray_tpu_torch.serve.request_trace import RequestTracer
from ray_tpu_torch.serve.slo import SLOBudget, SLOWatchdog


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
    - ``spec_tokens``: draft tokens per slot per decode step by
      prompt-lookup speculation (0 = one-token decode).
    - ``spec_ngram``: longest history n-gram tried by the draft lookup.
    - ``spec_min_acceptance``: per-slot acceptance-EWMA floor below
      which drafting is turned off for that sequence.
    - ``capture_logprobs``: prefill and decode also return the selected
      token's log-probability, so ``detailed`` streams carry ``(token,
      weight_version, logprob)``. Excludes ``spec_tokens > 0`` (the
      verify path scores positions out of emission order).
    """
    decode_slots: int = 8
    kv_block_size: int = 16
    max_seq_len: int = 256
    prefill_chunk: int = 32
    num_kv_blocks: int = 0
    max_new_tokens: int = 64          # default per-request cap
    eos_token_id: Optional[int] = None
    enable_prefix_sharing: bool = True
    spec_tokens: int = 0
    spec_ngram: int = 3
    spec_min_acceptance: float = 0.1
    capture_logprobs: bool = False
    #: Per-request tracing: None keeps the tracer's default (on, 1-in-N
    #: sampled); True/False force it for this engine.
    enable_trace: Optional[bool] = None
    #: Tokens per DECODE trace span: bounds the span count of long
    #: generations.
    trace_decode_tick: int = 16
    #: Wire format of KV hand-offs (serve/disagg.py): "bf16" ships blocks
    #: raw in the cache's own dtype (bit-exact adoption; an f32 cache
    #: ships f32); "int8" ships blockwise-quantized values and f32 scales.
    kv_wire: str = "bf16"
    #: Part label this engine's trace span batches ship under: a prefill
    #: engine and a decode engine sharing one request id ship under
    #: distinct parts, or a store merging them drops one side's spans.
    trace_part: str = "engine"

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
                 "t_first_token", "history", "hit_blocks", "trie_node",
                 "trie_cursor", "spec_ewma", "spec_disabled", "warmup",
                 "detailed", "trace", "t_enqueue_wall", "queue_wait_s",
                 "last_tok_wall", "tick_t0", "tick_toks", "export",
                 "adopt", "rewarm")

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
        self.warmup = False           # warm-up request: no telemetry
        self.rewarm = False           # a prefix prefilled again at a swap
        self.detailed = False         # stream (tok, version, logprob)
        # -- disaggregated hand-off (serve/disagg.py)
        self.export = False           # end at the prompt: ship its KV
        self.adopt: Optional[dict] = None   # shipped payload to adopt
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        # -- per-request tracing (serve/request_trace.py)
        self.trace = None             # RequestTrace or None
        self.t_enqueue_wall = 0.0     # router (or submit) wall clock
        self.queue_wait_s = 0.0       # enqueue -> engine admission
        self.last_tok_wall: Optional[float] = None
        self.tick_t0: Optional[float] = None   # open DECODE tick start
        self.tick_toks = 0            # tokens in the open DECODE tick
        # -- prefix sharing (prefix_cache.PrefixBlockPool)
        self.hit_blocks = 0           # prompt blocks prefill skipped
        self.trie_node = None         # deepest trie node of this prompt
        self.trie_cursor = 0          # next full prompt block to index
        # -- speculative decode
        self.history: List[int] = list(prompt)   # tokens 0..seq_len
        self.spec_ewma: Optional[float] = None   # acceptance EWMA
        self.spec_disabled = False


def _leaves(tree, prefix=""):
    """(dotted name, tensor) of every leaf of a nested parameter dict."""
    if isinstance(tree, dict):
        return [x for k, v in sorted(tree.items())
                for x in _leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


class LLMEngine:
    """Continuous-batching scheduler over the paged decode path.

    Thread model: one background step thread owns the device state
    (cache and slot arrays); ``submit``/``cancel``/``stage_weights`` only
    touch the queue under a lock and are safe from any thread or event
    loop; device work asked for from another thread (warm-prefix export
    and import) is posted to the step thread and runs at the top of its
    next step. Consumers read per-request ``queue.Queue``s fed by the
    step thread.

    ``device`` defaults to CUDA and raises when there is none; tests
    pass ``device="cpu"``. ``replica_tag`` labels this engine's flight
    recorder events and exported payloads.
    """

    def __init__(self, model_config, engine_config: Optional[EngineConfig]
                 = None, params=None, seed: int = 0, device=None,
                 replica_tag: str = ""):
        self.model_config = model_config
        self.config = engine_config or EngineConfig()
        self.replica_tag = replica_tag
        ec = self.config
        if ec.prefill_chunk < 1 or ec.decode_slots < 1:
            raise ValueError("prefill_chunk and decode_slots must be >= 1")
        if ec.spec_tokens < 0 or ec.spec_ngram < 1:
            raise ValueError("spec_tokens must be >= 0 and spec_ngram "
                             ">= 1")
        if ec.capture_logprobs and ec.spec_tokens > 0:
            raise ValueError(
                "capture_logprobs is incompatible with speculative "
                "decode (spec_tokens > 0): the verify path scores "
                "positions out of emission order")
        if ec.kv_wire not in ("bf16", "int8"):
            raise ValueError(
                f"kv_wire must be 'bf16' or 'int8', got {ec.kv_wire!r}")
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
        #: step-thread op queue: device work posted from other threads
        #: (warm-prefix export/import) runs at the top of the next step,
        #: where the step thread alone owns the cache
        self._ops: "collections.deque[dict]" = collections.deque()
        self._rid = 0
        self._stop = False
        self._dead: Optional[BaseException] = None

        # -- in-flight weight staging: a caller stages a parameter tree
        # and a version; the step thread swaps the pointer between steps.
        # No slot is ever drained, so _sync_stall_s (decode time lost
        # waiting on a refresh) stays 0 by construction.
        self._staged_weights: Optional[tuple] = None
        self._weight_version = 0
        self._weight_swaps = 0
        self._weight_swap_wall_s = 0.0
        self._sync_stall_s = 0.0

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
        #: steps whose admission waited for a prefix another request was
        #: prefilling into the current index
        self._prefix_waits = 0
        #: prompt blocks prefilled again after weight swaps (the reused
        #: prefixes of the dropped index)
        self._rewarm_blocks = 0
        #: the prefixes the last swap queued for a re-prefill, and
        #: whether a request has been admitted since (one that did not
        #: match a re-prefilled prefix drops it at the next swap)
        self._rewarmed: List[tuple] = []
        self._admitted_since_swap = False
        # hand-off accounting: exports on the prefill side, adopts on
        # the decode side; the two walls are the device and copy work of
        # packing and of adopting a payload
        self._kv_exports = 0
        self._kv_export_bytes = 0
        self._kv_export_wall_s = 0.0
        self._kv_adopts = 0
        self._kv_adopt_bytes = 0
        self._kv_adopt_blocks = 0
        self._kv_adopt_wall_s = 0.0
        self._kv_ship_wall_s = 0.0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_disables = 0
        self._occupancy: Dict[int, int] = collections.defaultdict(int)
        self._t_start = time.monotonic()
        self._last_stats_emit = 0.0
        self._ttft_ewma: Optional[float] = None
        self._queue_wait_ewma: Optional[float] = None
        self._metrics = runtime_metrics()
        # the runtime worker this engine serves in (a replica), if any:
        # its flight recorder, fleet metrics reporter and config
        worker = try_global_worker()
        self._recorder = getattr(worker, "recorder", None)
        self._reporter = getattr(worker, "metrics_reporter", None)
        cfg = getattr(worker, "config", None)
        # -- per-request tracing and the SLO watchdog: the engine is the
        # waterfall's single shipper; one span batch ships at request end
        # iff sampled, SLO-tripped or failed
        self._tracer = RequestTracer(cfg, part=ec.trace_part)
        if ec.enable_trace is not None:
            self._tracer.enabled = bool(ec.enable_trace)
        self._slo = SLOWatchdog(SLOBudget.from_config(cfg))

        from concurrent.futures import ThreadPoolExecutor
        self._poll_pool = ThreadPoolExecutor(
            2 * ec.decode_slots + 4, thread_name_prefix="llm-engine-poll")
        self._thread = threading.Thread(
            target=self._run, name="llm-engine-step", daemon=True)
        self._thread.start()

    # ----------------------------------------------------- device calls
    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _pick(self, logits: torch.Tensor):
        """Greedy tokens of ``[B, vocab]`` logits, and with
        ``capture_logprobs`` their log-softmax (in f32) as host arrays."""
        tok = torch.argmax(logits, dim=-1)
        if not self.config.capture_logprobs:
            return tok.cpu().numpy(), None
        lp = torch.log_softmax(logits.float(), dim=-1)
        lp = lp.gather(-1, tok[:, None])[:, 0]
        return tok.cpu().numpy(), lp.cpu().numpy()

    def _prefill_fn(self, tokens, bt, start, lens):
        logits, self._cache = prefill(self.model_config, self._params,
                                      tokens, self._cache, bt, start, lens)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      lens.long() - 1]
        return self._pick(last)

    def _decode_fn(self, toks, bt, seq_lens):
        logits, self._cache = decode_step(self.model_config, self._params,
                                          toks, self._cache, bt, seq_lens)
        return self._pick(logits)

    def _verify_fn(self, toks, bt, starts, lens) -> np.ndarray:
        """The speculative verify: the whole slot array steps ``k+1``
        tokens per slot through the chunked-prefill trunk (positions and
        write masks handle ragged per-slot draft lengths); the argmax of
        every position comes back for the host's acceptance."""
        logits, self._cache = prefill(self.model_config, self._params,
                                      toks, self._cache, bt, starts, lens)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src``'s k/v copied to ``dst`` across all
        layers, in place."""
        s = torch.tensor([src], device=self.device)
        d = torch.tensor([dst], device=self.device)
        for name in ("k", "v"):
            c = self._cache[name]
            c.index_copy_(1, d, c.index_select(1, s))

    def _gather(self, blocks: Sequence[int]):
        """The k and v slabs ``[n_layers, len(blocks), bs, KVH, D]`` of
        ``blocks`` (at most ``blocks_per_seq``), gathered at the fixed
        padded shape: pad ids read the trash block and are cut off."""
        ids = np.zeros((self.config.blocks_per_seq,), np.int64)
        ids[:len(blocks)] = blocks
        ids = self._tensor(ids)
        return tuple(self._cache[n].index_select(1, ids)[:, :len(blocks)]
                     for n in ("k", "v"))

    def _scatter(self, blocks: Sequence[int], k: torch.Tensor,
                 v: torch.Tensor) -> None:
        """Write slabs ``[n_layers, len(blocks), ...]`` into ``blocks`` at
        the fixed padded shape: pad ids point at the trash block with
        zero data, so the duplicate writes all write zeros and their
        order cannot matter."""
        T = self.config.blocks_per_seq
        ids = np.zeros((T,), np.int64)
        ids[:len(blocks)] = blocks
        ids = self._tensor(ids)
        for name, slab in (("k", k), ("v", v)):
            c = self._cache[name]
            pad = torch.zeros((c.shape[0], T) + tuple(c.shape[2:]),
                              dtype=c.dtype, device=c.device)
            pad[:, :len(blocks)] = slab
            c.index_copy_(1, ids, pad)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------- public API
    def stage_weights(self, params, version: int) -> None:
        """Stage a parameter tree for an in-flight refresh. The step
        thread swaps it in at the next step boundary: in-flight sequences
        finish their current step on the old weights and go on with the
        new ones, every emitted token stamped by the version that
        produced it; cached prompt prefixes are dropped at the swap, so
        no later request reads K/V of the old weights. Staging twice
        before a swap keeps only the newest
        tree. Safe from any thread. The tree must match the engine's
        (keys, shapes, dtypes, device), else this raises; on the card the
        step thread's stream waits for the caller's stream as it is now,
        so tensors the caller wrote on it are complete before use."""
        self._check_params(params)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        with self._work:
            if self._dead is not None:
                raise EngineDeadError(
                    f"engine step loop died: {self._dead!r}")
            self._staged_weights = (params, int(version), ready)
            self._work.notify_all()

    def _check_params(self, params) -> None:
        have = _leaves(self._params)
        got = _leaves(params) if isinstance(params, dict) else []
        if [n for n, _ in got] != [n for n, _ in have]:
            raise ValueError(
                "staged params do not have the engine's tree: "
                f"{sorted(n for n, _ in got)} vs {sorted(n for n, _ in have)}")
        for (name, new), (_, old) in zip(got, have):
            if not isinstance(new, torch.Tensor):
                raise TypeError(f"staged leaf {name} is not a tensor")
            if new.shape != old.shape or new.dtype != old.dtype \
                    or new.device != old.device:
                raise ValueError(
                    f"staged leaf {name}: {tuple(new.shape)} {new.dtype} "
                    f"on {new.device}, the engine's is {tuple(old.shape)} "
                    f"{old.dtype} on {old.device}")

    @property
    def weight_version(self) -> int:
        """Version of the weights the NEXT decode step will run."""
        with self._lock:
            staged = self._staged_weights
            return staged[1] if staged is not None \
                else self._weight_version

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               detailed: bool = False,
               trace_ctx: Optional[Dict[str, Any]] = None,
               _warmup: bool = False, _export: bool = False,
               _adopt: Optional[Dict[str, Any]] = None) -> _Request:
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
            req.warmup = _warmup
            req.detailed = detailed
            req.export = _export
            req.adopt = _adopt
            if not _warmup:
                self._attach_trace(req, trace_ctx)
            self._pending.append(req)
            self._work.notify_all()
        return req

    def _attach_trace(self, req: _Request,
                      trace_ctx: Optional[Dict[str, Any]]) -> None:
        """Open this request's trace. ``trace_ctx`` is a router's stamp
        (request_id, sampled verdict, enqueue timestamp, routing
        annotations); a direct ``submit`` gets a locally minted
        request_id and the tracer's own 1-in-N sampling decision."""
        tr = self._tracer
        if not tr.enabled:
            return
        now = time.time()
        ctx = trace_ctx or {}
        rid = ctx.get("request_id")
        # a caller-pinned id with no explicit sampling verdict keeps the
        # tracer's own 1-in-N; a router always stamps its verdict
        sampled = ctx.get("sampled") if rid else None
        if sampled is not None:
            sampled = bool(sampled)
        meta = {k: ctx[k] for k in ("policy", "score", "admission")
                if ctx.get(k) is not None}
        trace = tr.begin(request_id=rid, sampled=sampled,
                         meta=meta or None)
        if trace is None:
            return
        req.trace = trace
        # clamp a skewed cross-process enqueue stamp: the QUEUED span
        # must never start in this process's future
        req.t_enqueue_wall = min(float(ctx.get("enqueue_ts") or now), now)

    def cancel(self, req: _Request) -> None:
        """Mark a request cancelled; the step thread frees its slot and
        blocks at the next step boundary."""
        with self._work:
            req.cancelled = True
            self._work.notify_all()

    async def generate(self, prompt_ids: Sequence[int],
                       max_new_tokens: Optional[int] = None,
                       eos_token_id: Optional[int] = None,
                       trace_ctx: Optional[Dict[str, Any]] = None):
        """Async token stream for one request. Raises typed errors
        instead of hanging; early ``aclose()`` cancels the request and
        frees its slot and blocks."""
        req = self.submit(prompt_ids, max_new_tokens, eos_token_id,
                          trace_ctx=trace_ctx)
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

    def _items(self, req: _Request, what: str, timeout_s: float):
        """The items of ``req``'s stream until its end, raising typed
        errors instead of hanging."""
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
                        raise TimeoutError(f"{what} timed out")
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
                      timeout_s: float = 120.0,
                      detailed: bool = False,
                      trace_ctx: Optional[Dict[str, Any]] = None):
        """Blocking token stream; ``detailed`` streams ``(token,
        weight_version, logprob)`` tuples (logprob None unless
        ``capture_logprobs``)."""
        req = self.submit(prompt_ids, max_new_tokens, eos_token_id,
                          detailed=detailed, trace_ctx=trace_ctx)
        yield from self._items(req, "generate_sync", timeout_s)

    # ------------------------------------------- disagg hand-off API
    def prefill_export(self, prompt_ids: Sequence[int],
                       trace_ctx: Optional[Dict[str, Any]] = None,
                       timeout_s: float = 120.0) -> Dict[str, Any]:
        """Run a prompt through chunked prefill and return the hand-off
        payload (prompt, first token and its logprob, packed KV slab)
        instead of decoding: the prefill half of disaggregated serving.
        Blocking."""
        req = self.submit(prompt_ids, max_new_tokens=1,
                          trace_ctx=trace_ctx, _export=True)
        for item in self._items(req, "prefill_export", timeout_s):
            if isinstance(item, dict):
                return item
        raise EngineDeadError("prefill_export stream ended without a "
                              "payload")

    def submit_adopt(self, payload: Dict[str, Any],
                     max_new_tokens: Optional[int] = None,
                     eos_token_id: Optional[int] = None,
                     detailed: bool = False,
                     trace_ctx: Optional[Dict[str, Any]] = None
                     ) -> _Request:
        """Enqueue a shipped prefill payload for adoption and decode: the
        decode half of disaggregated serving. The returned request
        streams what a colocated ``submit`` of the same prompt would
        have streamed (first token included)."""
        if int(payload.get("block_size", 0)) != self.config.kv_block_size:
            raise ValueError(
                f"shipped block_size {payload.get('block_size')} != "
                f"engine kv_block_size {self.config.kv_block_size}")
        return self.submit(payload["prompt"], max_new_tokens,
                           eos_token_id, detailed=detailed,
                           trace_ctx=trace_ctx, _adopt=payload)

    # --------------------------------------- warm-prefix migration API
    def export_warm_prefixes(self, min_hits: int = 1,
                             max_blocks: int = 0
                             ) -> Optional[Dict[str, Any]]:
        """Package this engine's warm ref-0 radix-trie chains (hits >=
        ``min_hits``) for another engine to import. Runs on the step
        thread. Returns None when there is nothing worth shipping."""
        ec = self.config

        def _do():
            with self._lock:
                chains = self._pool.export_chains(min_hits, max_blocks) \
                    if ec.enable_prefix_sharing else []
                # chains share root prefixes: ship each block once
                slab_idx: Dict[int, int] = {}
                entries: List[tuple] = []   # (chunk tokens, block id)
                for chain in chains:
                    for key, blk in chain:
                        if blk not in slab_idx:
                            slab_idx[blk] = len(entries)
                            entries.append((key, blk))
            if not entries:
                return None
            T = ec.blocks_per_seq
            ks, vs = [], []
            for i0 in range(0, len(entries), T):
                k, v = self._gather([b for _, b in entries[i0:i0 + T]])
                ks.append(k)
                vs.append(v)
            kv = pack_kv_blocks(torch.cat(ks, dim=1), torch.cat(vs, dim=1),
                                ec.kv_wire)
            self._metrics.serve_prefix_migrated.inc(
                len(entries), tags={"dir": "export"})
            self._record("PREFIX_MIGRATE", dir="export",
                         blocks=len(entries), chains=len(chains))
            return {
                "chains": [[(list(key), slab_idx[blk])
                            for key, blk in chain] for chain in chains],
                "kv": kv,
                "n_blocks": len(entries),
                "block_size": ec.kv_block_size,
                "wire": ec.kv_wire,
                "wire_bytes": kv["wire_bytes"],
                "src": self.replica_tag,
            }

        return self._run_on_step_thread(_do)

    def import_warm_prefixes(self, payload: Optional[Dict[str, Any]]) -> int:
        """Adopt a migrated warm-prefix payload into this engine's pool
        and radix trie (ref-0 cached blocks, evictable like any local
        cache). Opportunistic: chunks already held locally are skipped,
        and import stops at pool pressure rather than evicting this
        engine's own warm cache. Runs on the step thread; returns the
        number of blocks adopted."""
        if payload is None:
            return 0
        if int(payload.get("block_size", 0)) != self.config.kv_block_size:
            raise ValueError(
                f"migrated block_size {payload.get('block_size')} != "
                f"engine kv_block_size {self.config.kv_block_size}")
        ec = self.config

        def _do():
            plan: List[tuple] = []     # (slab index, local block id)
            with self._lock:
                if not ec.enable_prefix_sharing:
                    return 0
                pool = self._pool
                for chain in payload["chains"]:
                    node = pool._root
                    for key, idx in chain:
                        key = tuple(int(t) for t in key)
                        child = node.children.get(key)
                        if child is not None and not child.detached:
                            node = child
                            continue
                        # pressure guard: free list only; import never
                        # evicts local warm cache
                        if not pool._free:
                            break
                        blk = pool.allocate(1)[0]
                        nnode, inserted = pool.insert_child(node, key, blk)
                        if not inserted:
                            pool.release([blk])
                            node = nnode
                            if node is None:
                                break
                            continue
                        plan.append((idx, blk))
                        pool.decref(blk)   # ref-0, trie-resident
                        node = nnode
                    # a truncated chain stops: deeper chunks need parents
            if not plan:
                return 0
            k_slab, v_slab = unpack_kv_blocks(
                payload["kv"], dtype=self._cache["k"].dtype,
                device=self.device)
            T = ec.blocks_per_seq
            for i0 in range(0, len(plan), T):
                grp = plan[i0:i0 + T]
                idx = torch.tensor([i for i, _ in grp], device=self.device)
                self._scatter([b for _, b in grp],
                              k_slab.index_select(1, idx),
                              v_slab.index_select(1, idx))
            self._sync_device()
            self._metrics.serve_prefix_migrated.inc(
                len(plan), tags={"dir": "import"})
            self._record("PREFIX_MIGRATE", dir="import", blocks=len(plan),
                         chains=len(payload["chains"]))
            return len(plan)

        return self._run_on_step_thread(_do)

    def warmup(self, timeout_s: float = 600.0) -> None:
        """Run one tiny request end to end (on the card this builds and
        loads the kernel libraries) and reset the session counters it
        skewed, so the TTFT EWMA and the rates start from real traffic."""
        req = self.submit([2, 3], 2, _warmup=True)
        for _ in self._items(req, "warmup", timeout_s):
            pass
        with self._lock:
            self._ttft_ewma = None
            self._t_start = time.monotonic()
            self._tokens_total = 0
            self._decode_steps = 0
            self._prefill_chunks = 0
            self._decode_wall_s = self._prefill_wall_s = 0.0
            self._decode_pages_live = self._decode_pages_window = 0
            self._prompt_blocks_total = 0
            self._spec_drafted = self._spec_accepted = 0
            self._spec_disables = 0
            self._occupancy.clear()

    def stats(self) -> Dict[str, Any]:
        """Scheduler counters: queue depth, batch occupancy histogram,
        tokens/s, prefix sharing, hand-off and weight-refresh accounting,
        speculation, and the leak-check views of the slot and block free
        lists."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t_start, 1e-9)
            ps = self._pool.stats()
            hit_rate = (round(ps["hits_total"]
                              / self._prompt_blocks_total, 4)
                        if self._prompt_blocks_total else None)
            out = {
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
                "prefix_wait_steps": self._prefix_waits,
                "rewarm_blocks": self._rewarm_blocks,
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
                # the first-block fingerprints of the trie's roots: a
                # router's signal to place a cold session where its
                # system prompt's KV already lives
                "prefix_fingerprints": (
                    self._pool.root_fingerprints()
                    if self.config.enable_prefix_sharing else []),
                "occupancy_hist": dict(self._occupancy),
                "ttft_ewma_s": (round(self._ttft_ewma, 6)
                                if self._ttft_ewma is not None else None),
                "queue_wait_ewma_s": (
                    round(self._queue_wait_ewma, 6)
                    if self._queue_wait_ewma is not None else None),
                "kv_exports": self._kv_exports,
                "kv_export_bytes": self._kv_export_bytes,
                "kv_export_wall_s": round(self._kv_export_wall_s, 6),
                "kv_adopts": self._kv_adopts,
                "kv_adopt_bytes": self._kv_adopt_bytes,
                "kv_adopt_blocks": self._kv_adopt_blocks,
                "kv_adopt_wall_s": round(self._kv_adopt_wall_s, 6),
                "kv_ship_wall_s": round(self._kv_ship_wall_s, 4),
                # swaps are pointer flips between steps, so decode time
                # lost waiting on a refresh must stay 0.0
                "weight_version": self._weight_version,
                "weight_swaps": self._weight_swaps,
                "weight_swap_wall_s": round(self._weight_swap_wall_s, 6),
                "sync_stall_s": round(self._sync_stall_s, 6),
                "dead": repr(self._dead) if self._dead else None,
            }
            if self.config.spec_tokens > 0:
                out["spec"] = {
                    "drafted": self._spec_drafted,
                    "accepted": self._spec_accepted,
                    "acceptance_rate": (
                        round(self._spec_accepted / self._spec_drafted, 4)
                        if self._spec_drafted else None),
                    "disables": self._spec_disables,
                }
            return out

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
            or bool(self._ops) or self._staged_weights is not None \
            or any(r is not None for r in self._slots)

    def _on_dead(self, e: BaseException) -> None:
        with self._work:
            self._dead = e
            reqs = [r for r in self._slots if r is not None]
            reqs += list(self._prefilling) + list(self._pending)
            self._pending.clear()
            self._prefilling.clear()
            ops = list(self._ops)
            self._ops.clear()
        err = EngineDeadError(f"engine step loop died: {e!r}")
        err.__cause__ = e
        for r in set(reqs):
            self._close_trace(r, err)
            r.out.put(err)
        for op in ops:                 # never strand an op's waiter
            op["box"]["e"] = err
            op["done"].set()

    def _run_on_step_thread(self, fn, timeout_s: float = 30.0):
        """Run ``fn`` on the step thread (the cache's only user) at the
        next step boundary and return its result, so its gathers and
        scatters never interleave with a step's cache writes."""
        op = {"fn": fn, "done": threading.Event(), "box": {}}
        with self._work:
            if self._dead is not None:
                raise EngineDeadError(
                    f"engine step loop died: {self._dead!r}")
            self._ops.append(op)
            self._work.notify_all()
        if not op["done"].wait(timeout_s):
            raise TimeoutError("engine step-thread op timed out")
        if "e" in op["box"]:
            raise op["box"]["e"]
        return op["box"].get("r")

    def _drain_ops(self) -> None:
        while True:
            with self._lock:
                op = self._ops.popleft() if self._ops else None
            if op is None:
                return
            try:
                op["box"]["r"] = op["fn"]()
            except BaseException as e:  # noqa: BLE001 — typed to waiter
                op["box"]["e"] = e
            finally:
                op["done"].set()

    # one engine step: drain posted ops -> swap staged weights -> reap
    # -> admit -> one prefill chunk -> one decode
    def _step(self) -> None:
        self._drain_ops()
        self._maybe_swap_weights()
        self._reap_cancelled()
        self._admit()
        self._prefill_one_chunk()
        self._decode_once()
        self._emit_stats()

    def _maybe_swap_weights(self) -> None:
        """Apply a staged weight refresh between steps: a pointer swap on
        the step thread, so in-flight slots are never drained and no
        request waits. On the card the step thread's stream first waits
        (on the device, not the host) for the staging caller's stream.
        The prefix index is dropped: its KV was written by the old
        weights (the JAX engine keeps the index: ROADMAP Queue 3). Its
        reused prefixes are prefilled again on the new weights ahead of
        every queued request (``rewarm_blocks``), so that what a request
        admitted after the swap matches does not depend on when the swap
        landed."""
        with self._lock:
            staged = self._staged_weights
            if staged is None:
                return
            self._staged_weights = None
            active_reqs = [r for r in self._slots if r is not None]
        t0w = time.time()
        t0 = time.monotonic()
        params, version, ready = staged
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        self._params = params
        swap_s = time.monotonic() - t0
        now_w = time.time()
        for r in active_reqs:
            # the swap overlapped these requests' decode: mark the
            # version boundary in each waterfall
            if r.trace is not None:
                r.trace.span(RT.WEIGHT_SWAP, t0w, now_w, version=version)
        with self._lock:
            again = self._rewarm_prefixes() \
                if self.config.enable_prefix_sharing else []
            self._pool.drop_index()
            # the re-prefills still queued are in ``again``
            kept = [r for r in self._pending if not r.rewarm]
            self._pending.clear()
            self._pending.extend(kept)
            for tokens in reversed(again):
                self._rid += 1
                req = _Request(self._rid, list(tokens), 1, None)
                req.warmup = req.rewarm = True
                self._pending.appendleft(req)
            self._rewarmed = again
            self._admitted_since_swap = False
            self._weight_version = version
            self._weight_swaps += 1
            self._weight_swap_wall_s += swap_s
        self._record("RLHF_SYNC", version=version, swap_s=round(swap_s, 6),
                     active_slots=len(active_reqs))

    def _reap_cancelled(self) -> None:
        with self._lock:
            for req in list(self._prefilling):
                if req.cancelled:
                    self._prefilling.remove(req)
                    self._release_locked(req)
            for req in list(self._pending):
                if req.cancelled:
                    self._pending.remove(req)
                    self._close_trace(req)
                    req.out.put(_DONE)
            for req in self._slots:
                if req is not None and req.cancelled:
                    self._release_locked(req)

    def _trace_admit(self, req: _Request, mtok: int, **attrs) -> None:
        """QUEUED and ADMITTED spans and the queue-wait SLO of an
        admitted request (call with self._lock held)."""
        if req.trace is None:
            return
        now = time.time()
        req.queue_wait_s = max(0.0, now - req.t_enqueue_wall)
        req.trace.span(RT.QUEUED, req.t_enqueue_wall, now)
        req.trace.span(RT.ADMITTED, now, None, slot=req.slot,
                       hit_blocks=req.hit_blocks, prefix_tokens=mtok,
                       **attrs)
        self._slo.observe_queue(req.trace, req.queue_wait_s)

    def _admit(self) -> None:
        ec = self.config
        bs = ec.kv_block_size
        while True:
            with self._lock:
                if not self._pending or not self._free_slots:
                    return
                head_adopt = self._pending[0].adopt is not None
            if head_adopt:
                # hand-off adoption: shipped KV blocks, no prefill
                if not self._admit_adopt(self._pending[0]):
                    return          # pool pressure: wait for blocks
                continue
            with self._lock:
                if not self._pending or not self._free_slots:
                    return
                req = self._pending[0]
                if ec.enable_prefix_sharing and \
                        self._prefix_in_flight(req.prompt):
                    # its prefix is being prefilled into the index now:
                    # admit it once those blocks are indexed (prefill
                    # runs one request at a time, so nothing is lost)
                    self._prefix_waits += 1
                    return
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
                    if req.rewarm:
                        # a re-prefill's match is no request's reuse
                        node = req.trie_node
                        while node.parent is not None:
                            node.hits -= 1
                            node = node.parent
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
                req.trie_cursor = req.hit_blocks
                req.prefill_pos = (plen - 1) if cow_src is not None \
                    else mtok
                if req.rewarm:
                    self._rewarm_blocks += -(-plen // bs)
                else:
                    self._pool.count_hits(req.hit_blocks)
                    self._prompt_blocks_total += -(-plen // bs)
                    self._admitted_since_swap = True
                self._pending.popleft()
                req.slot = self._free_slots.pop()
                self._block_tables[req.slot, :] = 0
                self._block_tables[req.slot, :len(req.blocks)] = \
                    req.blocks
                self._seq_lens[req.slot] = 0
                req.state = _PREFILL
                self._slots[req.slot] = req
                self._prefilling.append(req)
                if req.hit_blocks and not req.rewarm:
                    self._metrics.serve_prefix_hits.inc(req.hit_blocks)
                self._trace_admit(req, mtok, cow=cow_src is not None)
            # device-side copy outside the lock (the step thread is the
            # only device user; submit/cancel stay responsive)
            if cow_src is not None:
                self._copy_block(cow_src, cow_dst)
                with self._lock:
                    self._pool.release([cow_src])

    def _rewarm_prefixes(self) -> List[tuple]:
        """What to prefill again at a swap, less any that is a prefix of
        another: the prefixes requests matched since the last swap; the
        re-prefills this swap cuts short or finds queued; and, when no
        request has been admitted since the last swap, what that swap
        queued. So a re-prefilled prefix that the requests admitted after
        it did not match is not prefilled at the next swap (call with
        self._lock held)."""
        cands = {tuple(c) for c in self._pool.reused_prefixes()} | {
            tuple(r.prompt) for r in (*self._prefilling, *self._pending)
            if r.rewarm}
        if not self._admitted_since_swap:
            cands.update(self._rewarmed)
        keep: List[tuple] = []
        for c in sorted(cands, key=len, reverse=True):
            if not any(k[:len(c)] == c for k in keep):
                keep.append(c)
        return keep

    def _prefix_in_flight(self, prompt: Sequence[int]) -> bool:
        """True while a request prefilling into the current index (one
        admitted since the last weight swap, whose inserts have not
        aborted) has full prompt blocks in common with ``prompt`` that
        it has not indexed yet. Two requests admitted in one step would
        otherwise both prefill a shared prefix, as after a swap drops the
        index; KV from before the swap is never matched (call with
        self._lock held)."""
        bs = self.config.kv_block_size
        for r in self._prefilling:
            if r.trie_node is None or r.trie_node.detached:
                continue
            n = min(len(prompt), len(r.prompt)) // bs
            k = 0
            while k < n and prompt[k * bs:(k + 1) * bs] == \
                    r.prompt[k * bs:(k + 1) * bs]:
                k += 1
            if r.trie_cursor < k:
                return True
        return False

    # --------------------------------------------- disagg adopt / export
    def _admit_adopt(self, req: _Request) -> bool:
        """Admit a hand-off: slot and blocks like a normal request, but
        the prompt's KV arrives in the shipped slab instead of through
        prefill. Blocks the local radix trie already holds are reused
        (their slab copy is not scattered); the rest are scattered into
        the pool, then every full prompt chunk is trie-indexed. Never
        copy-on-write: the first token came with the payload. Returns
        False, with nothing taken, on pool pressure."""
        ec = self.config
        bs = ec.kv_block_size
        payload = req.adopt
        t0w = time.time()
        with self._lock:
            if not self._free_slots:
                return False
            plen = len(req.prompt)
            n_ship = min(int(payload["n_blocks"]), -(-plen // bs))
            need = -(-min(plen + req.max_new_tokens, ec.max_seq_len) // bs)
            matched: List[int] = []
            mtok = 0
            if ec.enable_prefix_sharing:
                matched, mtok, req.trie_node = \
                    self._pool.match_prefix(req.prompt)
            priv = self._pool.allocate(need - len(matched))
            if priv is None:
                self._pool.release(matched)
                req.trie_node = None
                return False
            req.blocks = matched + priv
            req.hit_blocks = len(matched)
            self._pool.count_hits(req.hit_blocks)
            req.trie_cursor = req.hit_blocks
            req.prefill_pos = plen
            self._prompt_blocks_total += -(-plen // bs)
            self._admitted_since_swap = True
            self._pending.popleft()
            req.slot = self._free_slots.pop()
            self._block_tables[req.slot, :] = 0
            self._block_tables[req.slot, :len(req.blocks)] = req.blocks
            self._seq_lens[req.slot] = 0
            req.state = _PREFILL
            self._slots[req.slot] = req
            if req.hit_blocks:
                self._metrics.serve_prefix_hits.inc(req.hit_blocks)
            self._trace_admit(req, mtok, adopt=True)
            # destinations of the slab blocks the local trie did NOT hold
            dst = req.blocks[req.hit_blocks:n_ship]
        # scatter outside the lock (the step thread owns the device)
        t0 = time.monotonic()
        if dst:
            k_slab, v_slab = unpack_kv_blocks(
                payload["kv"], dtype=self._cache["k"].dtype,
                device=self.device)
            self._scatter(dst, k_slab[:, req.hit_blocks:n_ship],
                          v_slab[:, req.hit_blocks:n_ship])
            self._sync_device()
        self._kv_adopt_wall_s += time.monotonic() - t0
        t1w = time.time()
        first = int(payload["first"])
        req.seq_len = plen
        req.t_first_token = time.monotonic()
        ship_ts = min(float(payload.get("ship_ts") or t0w), t0w)
        wire = payload.get("wire", ec.kv_wire)
        if req.trace is not None:
            req.trace.span(RT.KV_SHIP, ship_ts, t0w,
                           bytes=payload.get("wire_bytes"), wire=wire,
                           src=payload.get("src"))
            req.trace.span(RT.KV_ADOPT, t0w, t1w, blocks=len(dst),
                           reused=req.hit_blocks,
                           bytes=payload.get("wire_bytes"), wire=wire)
        self._kv_adopts += 1
        self._kv_adopt_bytes += int(payload.get("wire_bytes") or 0)
        self._kv_adopt_blocks += len(dst)
        self._kv_ship_wall_s += max(0.0, t1w - ship_ts)
        self._metrics.serve_kv_ship_seconds.observe(max(0.0, t1w - ship_ts))
        self._record("KV_ADOPT", blocks=len(dst), reused=req.hit_blocks,
                     dur_s=round(t1w - t0w, 6))
        self._record_ttft(req)
        with self._lock:
            # trie-index every full prompt chunk: the shipped prefix is
            # warm here for later requests
            while req.trie_node is not None and \
                    req.trie_cursor < plen // bs:
                i = req.trie_cursor
                node, _ = self._pool.insert_child(
                    req.trie_node, req.prompt[i * bs:(i + 1) * bs],
                    req.blocks[i])
                req.trie_node = node
                req.trie_cursor += 1
            if req.cancelled:
                self._release_locked(req)
                return True
            if req.eos_token_id is not None and first == req.eos_token_id:
                self._release_locked(req)
                return True
            req.generated = 1
            req.out.put(self._item(req, first, payload.get("first_lp")))
            req.history.append(first)
            self._tokens_total += 1
            if req.generated >= req.max_new_tokens:
                self._release_locked(req)
                return True
            req.state = _DECODE
            self._last_tok[req.slot] = first
            self._seq_lens[req.slot] = req.seq_len
        return True

    def _finish_export(self, req: _Request, first: int, lp) -> None:
        """Terminal step of a prefill-export request: gather the prompt's
        finished KV blocks into one slab, pack it for the wire (on the
        device for int8; one host copy per array), hand the payload to the
        waiting ``prefill_export`` call, and free the slot: this engine
        never decodes it."""
        ec = self.config
        bs = ec.kv_block_size
        plen = len(req.prompt)
        n_ship = -(-plen // bs)
        t0w = time.time()
        t0 = time.monotonic()
        with self._lock:
            self._prefilling.popleft()
            if req.cancelled:
                self._release_locked(req)
                return
            blocks = req.blocks[:n_ship]
        k_slab, v_slab = self._gather(blocks)
        kv = pack_kv_blocks(k_slab, v_slab, ec.kv_wire)
        payload = {
            "prompt": list(req.prompt),
            "first": int(first),
            "first_lp": None if lp is None else float(lp[0]),
            "kv": kv,
            "n_blocks": n_ship,
            "block_size": bs,
            "wire": ec.kv_wire,
            "wire_bytes": kv["wire_bytes"],
            "ship_ts": time.time(),
            "src": self.replica_tag,
        }
        t1w = time.time()
        self._kv_export_wall_s += time.monotonic() - t0
        self._kv_exports += 1
        self._kv_export_bytes += int(kv["wire_bytes"])
        if req.trace is not None:
            req.trace.span(RT.KV_SHIP, t0w, t1w, bytes=kv["wire_bytes"],
                           wire=ec.kv_wire, blocks=n_ship, dir="export")
        self._metrics.serve_kv_ship_bytes.inc(
            kv["wire_bytes"], tags={"wire": ec.kv_wire})
        self._record("KV_SHIP", blocks=n_ship, bytes=kv["wire_bytes"],
                     wire=ec.kv_wire)
        with self._lock:
            req.out.put(payload)
            self._release_locked(req)

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
        t0w = time.time()
        t0 = time.monotonic()
        tok, lp = self._prefill_fn(
            self._tensor(chunk),
            self._tensor(self._block_tables[req.slot:req.slot + 1]),
            self._tensor(np.full((1,), start, np.int32)),
            self._tensor(np.full((1,), n, np.int32)))
        self._prefill_wall_s += time.monotonic() - t0
        req.prefill_pos += n
        self._prefill_chunks += 1
        if req.trace is not None:
            req.trace.span(RT.PREFILL, t0w, time.time(), pos=start,
                           tokens=n)
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
        if req.rewarm:
            # indexed again: nothing to emit
            with self._lock:
                self._prefilling.popleft()
                self._release_locked(req)
            return
        # prompt fully cached: the final chunk's last logits give the
        # first generated token
        first = int(tok[0])
        if req.export:
            # hand-off prefill: ship the finished blocks instead of
            # decoding
            self._finish_export(req, first, lp)
            return
        req.seq_len = len(req.prompt)
        req.t_first_token = time.monotonic()
        self._record_ttft(req)
        with self._lock:
            self._prefilling.popleft()
            if req.cancelled:
                self._release_locked(req)
                return
            if req.eos_token_id is not None and first == req.eos_token_id:
                self._release_locked(req)
                return
            req.generated = 1
            req.out.put(self._item(req, first,
                                   None if lp is None else float(lp[0])))
            req.history.append(first)
            self._tokens_total += 1
            if req.generated >= req.max_new_tokens:
                self._release_locked(req)
                return
            req.state = _DECODE
            self._last_tok[req.slot] = first
            self._seq_lens[req.slot] = req.seq_len

    def _account_decode_pages(self, live_lens) -> None:
        """Book one decode step's length-aware work: pages the paged
        kernel reads (``max(ceil(live/bs), 1)`` per slot; idle slots read
        their one trash page) against the full table window."""
        ec = self.config
        self._decode_pages_live += int(paged_work_pages(
            np.asarray(live_lens, np.int64), ec.kv_block_size).sum())
        self._decode_pages_window += ec.decode_slots * ec.blocks_per_seq

    def _active_for_decode(self) -> List[_Request]:
        """The slots in decode, booked as one step (call with self._lock
        held)."""
        active = [r for r in self._slots
                  if r is not None and r.state == _DECODE]
        if active:
            self._decode_steps += 1
            self._occupancy[len(active)] += 1
            self._metrics.serve_batch_occupancy.observe(len(active))
        return active

    def _decode_once(self) -> None:
        if self.config.spec_tokens > 0:
            self._decode_speculative()
            return
        with self._lock:
            active = self._active_for_decode()
            if not active:
                return
            toks = self._last_tok.copy()
            lens = self._seq_lens.copy()
            bt = self._block_tables.copy()
        # only decoding slots write: the step writes every slot's token,
        # and a slot still in prefill (seq_len 0) would write token 0 over
        # position 0 of its first block, which may be a shared prefix
        # block; its row reads and writes the trash block instead, as an
        # idle slot's does. (The JAX engine writes it: ROADMAP Queue 3.)
        decoding = np.zeros(len(bt), bool)
        decoding[[r.slot for r in active]] = True
        bt[~decoding] = 0
        self._account_decode_pages(lens + 1)
        t0 = time.monotonic()
        out, lps = self._decode_fn(self._tensor(toks), self._tensor(bt),
                                   self._tensor(lens))
        self._decode_wall_s += time.monotonic() - t0
        produced = 0
        now_w = time.time()
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
                req.out.put(self._item(req, tok,
                                       None if lps is None
                                       else float(lps[req.slot])))
                req.history.append(tok)
                self._tokens_total += 1
                produced += 1
                self._trace_token(req, now_w)
                if req.generated >= req.max_new_tokens \
                        or req.seq_len + 1 >= self.config.max_seq_len:
                    self._release_locked(req)
                else:
                    self._last_tok[req.slot] = tok
        # decode tokens into the counter (each first token is counted by
        # _record_ttft), so its rate is the engine's tokens/s
        if produced:
            self._metrics.serve_tokens.inc(produced)

    # ---------------------------------------------- speculative decode
    def _draft(self, req: _Request, n_draft: int) -> List[int]:
        """Prompt-lookup drafting: the continuation of the most recent
        earlier occurrence of the sequence's own trailing n-gram (longest
        n first). No draft model, no device work; a miss returns fewer
        drafts or none."""
        if n_draft <= 0:
            return []
        h = req.history
        for g in range(min(self.config.spec_ngram, len(h) - 1), 0, -1):
            pat = h[-g:]
            for i in range(len(h) - g - 1, -1, -1):
                if h[i:i + g] == pat:
                    return h[i + g:i + g + n_draft]
        return []

    def _decode_speculative(self) -> None:
        """One verify step over the slot array: each active slot runs
        [last_tok, draft_1..draft_d] at its next positions in ONE
        fixed-shape (S, k+1) call, then accepts the longest draft prefix
        that matches the model's own argmax chain plus one token. d = 0
        is exactly a one-token decode step, so the emitted tokens are
        those of speculation off. Rejected drafts leave writes only at
        positions past the accepted seq_len: never read (causal
        masking) and overwritten when real tokens reach them."""
        ec = self.config
        L = ec.spec_tokens + 1
        S = ec.decode_slots
        bs = ec.kv_block_size
        with self._lock:
            active = self._active_for_decode()
            if not active:
                return
            toks = np.zeros((S, L), np.int32)
            lens = np.zeros((S,), np.int32)
            starts = np.zeros((S,), np.int32)
            drafts: Dict[int, List[int]] = {}
            for req in active:
                s = req.slot
                # cap drafts to the sequence's allocated blocks, so draft
                # writes NEVER spill into the shared trash block (other
                # slots' junk there could corrupt a verify)
                span = len(req.blocks) * bs
                budget = min(L, span - req.seq_len,
                             req.max_new_tokens - req.generated + 1)
                d = [] if req.spec_disabled else \
                    self._draft(req, max(0, budget - 1))
                toks[s, 0] = self._last_tok[s]
                if d:
                    toks[s, 1:1 + len(d)] = d
                lens[s] = 1 + len(d)
                starts[s] = req.seq_len
                drafts[s] = d
            bt = self._block_tables.copy()
        self._account_decode_pages(starts + lens)
        t0w = time.time()
        t0 = time.monotonic()
        preds = self._verify_fn(self._tensor(toks), self._tensor(bt),
                                self._tensor(starts), self._tensor(lens))
        self._decode_wall_s += time.monotonic() - t0
        produced = 0
        now_w = time.time()
        with self._lock:
            for req in active:
                if req.cancelled or self._slots[req.slot] is not req:
                    continue
                s = req.slot
                d = drafts[s]
                emitted = 0
                for j in range(len(d) + 1):
                    tok = int(preds[s, j])
                    req.seq_len += 1       # position j's token is real
                    self._seq_lens[s] = req.seq_len
                    if req.eos_token_id is not None \
                            and tok == req.eos_token_id:
                        self._release_locked(req)
                        break
                    req.generated += 1
                    req.out.put(self._item(req, tok, None))
                    req.history.append(tok)
                    self._tokens_total += 1
                    produced += 1
                    emitted += 1
                    self._trace_token(req, now_w)
                    if req.generated >= req.max_new_tokens \
                            or req.seq_len + 1 >= ec.max_seq_len:
                        self._release_locked(req)
                        break
                    self._last_tok[s] = tok
                    # go on to draft j+1 only if draft j was what the
                    # model itself predicted (its cache entry is right)
                    if j >= len(d) or d[j] != tok:
                        break
                if d:
                    accepted = max(0, emitted - 1)
                    self._spec_drafted += len(d)
                    self._spec_accepted += accepted
                    if req.trace is not None:
                        req.trace.span(RT.SPEC_VERIFY, t0w, now_w,
                                       drafted=len(d), accepted=accepted)
                    ratio = accepted / len(d)
                    req.spec_ewma = ratio if req.spec_ewma is None \
                        else 0.8 * req.spec_ewma + 0.2 * ratio
                    if req.spec_ewma < ec.spec_min_acceptance \
                            and not req.spec_disabled:
                        req.spec_disabled = True
                        self._spec_disables += 1
                    self._metrics.serve_spec_accept.observe(ratio)
        if produced:
            self._metrics.serve_tokens.inc(produced)

    def _trace_token(self, req: _Request, now_w: float) -> None:
        """Book one emitted decode token into the request's trace: the
        inter-token gap to the SLO watchdog, and a DECODE span every
        ``trace_decode_tick`` tokens. A speculative burst emits several
        tokens at one wall instant: their gaps are ~0, as the stream a
        user sees."""
        tr = req.trace
        if tr is None:
            return
        last = req.last_tok_wall
        req.last_tok_wall = now_w
        if last is not None:
            self._slo.observe_gap(tr, max(0.0, now_w - last))
        if req.tick_t0 is None:
            req.tick_t0 = last if last is not None else now_w
        req.tick_toks += 1
        if req.tick_toks >= self.config.trace_decode_tick:
            tr.span(RT.DECODE, req.tick_t0, now_w, tokens=req.tick_toks)
            req.tick_t0, req.tick_toks = None, 0

    def _item(self, req: _Request, tok: int, logprob):
        """One stream item: a plain int, or ``(token, weight_version,
        logprob)`` for ``detailed`` streams. Called on the step thread,
        where the version is constant for the whole step: the stamp is
        the version whose weights computed this token's logits."""
        if not req.detailed:
            return tok
        return (tok, self._weight_version, logprob)

    def _release_locked(self, req: _Request,
                        err: Optional[BaseException] = None) -> None:
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
        self._close_trace(req, err)
        req.out.put(err if err is not None else _DONE)
        self._work.notify_all()

    def _close_trace(self, req: _Request,
                     err: Optional[BaseException] = None) -> None:
        """Terminal span and ship decision of one request's trace,
        exactly once (the trace is detached first). FAILED names the
        typed error; DONE carries the token count."""
        tr = req.trace
        if tr is None:
            return
        req.trace = None
        now = time.time()
        if req.tick_toks and req.tick_t0 is not None:
            tr.span(RT.DECODE, req.tick_t0, now, tokens=req.tick_toks)
            req.tick_t0, req.tick_toks = None, 0
        if err is not None:
            tr.span(RT.FAILED, now, None, error=type(err).__name__,
                    detail=str(err)[:200])
        else:
            tr.span(RT.DONE, now, None, tokens=req.generated,
                    cancelled=bool(req.cancelled))
        self._tracer.finish(tr)

    # ------------------------------------------------ metrics / events
    def _record(self, ev: str, **data) -> None:
        """An event on the runtime worker's flight recorder, labelled
        with this replica (no runtime: nothing)."""
        if self._recorder is not None:
            self._recorder.record(ev, replica=self.replica_tag, **data)

    def _record_ttft(self, req: _Request) -> None:
        if req.warmup:
            return      # warm-up traffic: its TTFT is the build's wall
        ttft = req.t_first_token - req.t_submit
        # full TTFT = router enqueue -> first token: the histogram
        # observes the full number, as the waterfalls report it; the EWMA
        # stays engine-scoped
        qw = req.queue_wait_s
        t_enq = req.t_enqueue_wall
        full = max(ttft, time.time() - t_enq) if t_enq else ttft
        self._ttft_ewma = ttft if self._ttft_ewma is None \
            else 0.8 * self._ttft_ewma + 0.2 * ttft
        self._queue_wait_ewma = qw if self._queue_wait_ewma is None \
            else 0.8 * self._queue_wait_ewma + 0.2 * qw
        self._metrics.serve_ttft.observe(full)
        self._metrics.serve_tokens.inc()
        trace = req.trace
        self._record("ENGINE_TTFT", rid=req.rid, ttft_s=round(ttft, 6),
                     queue_wait_s=round(qw, 6), prompt_len=len(req.prompt),
                     request_id=(trace.request_id
                                 if trace is not None else None))
        if trace is not None:
            now = time.time()
            req.last_tok_wall = now     # inter-token gap baseline
            trace.event(RT.FIRST_TOKEN, now, ttft_s=round(full, 6),
                        engine_ttft_s=round(ttft, 6),
                        queue_wait_s=round(qw, 6))
            self._slo.observe_ttft(trace, full)

    def _emit_stats(self, interval_s: float = 0.5) -> None:
        now = time.monotonic()
        if now - self._last_stats_emit < interval_s:
            return
        self._last_stats_emit = now
        s = self.stats()
        self._metrics.serve_queue_depth.set(s["queue_depth"])
        self._metrics.serve_tokens_per_s.set(s["tokens_per_s"])
        self._metrics.serve_blocks_shared.set(s["blocks_shared"])
        self._record("ENGINE_STATS", queue_depth=s["queue_depth"],
                     active=s["active_slots"],
                     tokens_per_s=s["tokens_per_s"],
                     free_blocks=s["free_blocks"])
        if self._recorder is not None:
            self._recorder.maybe_flush()
        # a replica decoding flat out may never reach the worker's idle
        # loop: the stats cadence doubles as the fleet report's heartbeat
        if self._reporter is not None:
            self._reporter.maybe_report()


_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16}


def _resolve_dtype(name):
    """A dtype named in a deployment's plain-dict config -> the torch
    dtype (a torch dtype passes through)."""
    if not isinstance(name, str):
        return name
    return _DTYPES[name]


def _server_device(device):
    """``LLMServer``'s device: as every entry point's (``None`` is CUDA),
    except that ``None`` in a runtime worker put on the CPU platform
    (``RAY_TPU_TORCH_PLATFORM=cpu``, which hides every card from it) is
    the CPU."""
    worker = try_global_worker()
    if device is None and getattr(worker, "kind", None) == "worker" \
            and os.environ.get("RAY_TPU_TORCH_PLATFORM") == "cpu":
        return torch.device("cpu")
    return resolve_device(device)


class LLMServer:
    """Deployment-facing engine wrapper. Construct with plain dicts so
    the deployment graph ships cheaply to the replica actor::

        app = serve.deployment(LLMServer, ray_actor_options={
            "num_gpus": 1}).bind(
            model={"d_model": 256, "n_layers": 4, ...},
            engine={"decode_slots": 8, "kv_block_size": 16})
        h = serve.run(app)
        for tok in h.options(stream=True).generate.remote([1, 2, 3]):
            ...

    ``generate`` is an async generator, so each token rides the core
    streaming-generator machinery (per-item objects, backpressure,
    typed failure on replica death).

    The warm-up runs one request end to end before the replica enters
    rotation (on the card it builds and loads the kernel libraries); a
    failure there raises, so the replica's creation fails instead of
    serving from an engine whose kernel did not build.
    """

    def __init__(self, model: Optional[Dict[str, Any]] = None,
                 engine: Optional[Dict[str, Any]] = None,
                 seed: int = 0, warmup: bool = True, device=None):
        from ray_tpu_torch.models import TransformerConfig
        model = dict(model or {})
        model["dtype"] = _resolve_dtype(model.get("dtype", "float32"))
        self.model_config = TransformerConfig(**model)
        self.engine_config = EngineConfig(**(engine or {}))
        self.engine = self._make_engine(_server_device(device), seed)
        if warmup:
            try:
                self.engine.warmup()
            except BaseException:
                self.engine.shutdown()
                raise

    def _make_engine(self, device, seed: int) -> LLMEngine:
        return LLMEngine(self.model_config, self.engine_config, seed=seed,
                         device=device, replica_tag=f"pid:{os.getpid()}")

    @staticmethod
    def _trace_ctx() -> Optional[Dict[str, Any]]:
        """Flatten the router's trace stamp out of the replica call
        context (request_id, sampling verdict, routing annotations), so
        the engine opens the request's trace under the id the client or
        proxy already knows."""
        from ray_tpu_torch.serve._private.replica import \
            get_request_context
        ctx = get_request_context()
        rid = ctx.get("request_id")
        if not rid:
            return None
        return dict(ctx.get("trace") or {}, request_id=rid)

    async def generate(self, prompt_ids: Sequence[int],
                       max_new_tokens: Optional[int] = None,
                       eos_token_id: Optional[int] = None):
        async for tok in self.engine.generate(
                prompt_ids, max_new_tokens, eos_token_id,
                trace_ctx=self._trace_ctx()):
            yield tok

    async def __call__(self, prompt_ids: Sequence[int],
                       max_new_tokens: Optional[int] = None):
        async for tok in self.engine.generate(
                prompt_ids, max_new_tokens,
                trace_ctx=self._trace_ctx()):
            yield tok

    # ------------------------------------------ disagg replica surface
    async def _next_item(self, req: _Request):
        """The next item of ``req``'s stream, polled off the event loop
        on the engine's pool; raises typed errors instead of hanging."""
        eng = self.engine
        loop = asyncio.get_running_loop()
        get = functools.partial(req.out.get, timeout=0.2)
        while True:
            try:
                item = await loop.run_in_executor(eng._poll_pool, get)
            except queue.Empty:
                if eng._dead is not None:
                    raise EngineDeadError(
                        f"engine step loop died: {eng._dead!r}")
                continue
            if isinstance(item, BaseException):
                raise item
            return item

    async def prefill_export(self, prompt_ids: Sequence[int]
                             ) -> Dict[str, Any]:
        """Prefill-fleet actor method: chunked-prefill the prompt and
        return the KV hand-off payload. Its slabs leave this worker as
        bytes through the serializer (a CUDA slab after one copy to the
        host) and reach the decode replica when the router chains this
        call's ObjectRef into ``adopt_generate``."""
        req = self.engine.submit(prompt_ids, max_new_tokens=1,
                                 trace_ctx=self._trace_ctx(), _export=True)
        try:
            while True:
                item = await self._next_item(req)
                if isinstance(item, dict):
                    return item
                if item is _DONE:
                    raise EngineDeadError(
                        "prefill_export ended without a payload")
        finally:
            self.engine.cancel(req)

    async def adopt_generate(self, payload: Dict[str, Any],
                             max_new_tokens: Optional[int] = None,
                             eos_token_id: Optional[int] = None):
        """Decode-fleet actor method: adopt a shipped prefill payload
        and stream tokens, the first token (computed by the prefill
        replica) included, so the stream is exactly what a colocated
        ``generate`` would produce."""
        req = self.engine.submit_adopt(payload, max_new_tokens,
                                       eos_token_id,
                                       trace_ctx=self._trace_ctx())
        try:
            while True:
                item = await self._next_item(req)
                if item is _DONE:
                    return
                yield item
        finally:
            self.engine.cancel(req)

    async def export_warm_prefixes(self, min_hits: int = 1,
                                   max_blocks: int = 0
                                   ) -> Optional[Dict[str, Any]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.engine._poll_pool,
            functools.partial(self.engine.export_warm_prefixes,
                              min_hits, max_blocks))

    async def import_warm_prefixes(self,
                                   payload: Optional[Dict[str, Any]]
                                   ) -> int:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.engine._poll_pool,
            functools.partial(self.engine.import_warm_prefixes,
                              payload))

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def sync_weights(self, packed: Dict[str, Any]) -> int:
        """Apply an int8-packed weight refresh (the
        :mod:`ray_tpu_torch.rlhf.weight_sync` wire format) in flight:
        dequantize on this actor-call thread, on the engine's device,
        into its dtypes, and stage it for the step thread's between-steps
        pointer swap. Returns the staged version. Decode never drains."""
        from ray_tpu_torch._bridge import params_from_jax
        from ray_tpu_torch.rlhf.weight_sync import unpack_weights
        tree, version = unpack_weights(packed, self.engine.device)
        self.engine.stage_weights(params_from_jax(
            tree, self.model_config, self.engine.device), version)
        return version

    def pool_audit(self) -> List[str]:
        return self.engine.pool_audit()

    def kv_block_bytes(self) -> int:
        ec, mc = self.engine_config, self.model_config
        return ec.kv_block_size * ec.kv_bytes_per_token(mc)

    def check_health(self) -> None:
        if self.engine._dead is not None:
            raise EngineDeadError(repr(self.engine._dead))
