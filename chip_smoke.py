#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); without a card it exits
non-zero and prints no result.

Phases (none catches a failure and carries on):

1. The card: name and power limit as ``nvidia-smi`` gives them.
2. Build the four kernel libraries from ``ray_tpu_torch/csrc`` with
   nvcc for ``sm_90a``, one nvcc per source, started together; print each
   build's time and ptxas's register, shared-memory and spill report for
   every kernel, the dynamic shared memory of the wgmma backward kernels,
   and fail on a spill in any ``*_sm90*`` kernel (the bf16 forward, dK/dV
   and dQ).
3. Paged kernel against its plain PyTorch version at the serving path's
   shapes (GPT-J-6B decode and chunked prefill, a GQA shape, an f32
   shape): on the rows the caller keeps (``pos < lens``), the error of
   each (row, head) output vector held to a tolerance relative to that
   vector's own largest element, and ``kernel_ms`` / ``plain_ms`` /
   ``library_ms`` (one ``scaled_dot_product_attention`` call over the
   same live K/V, a yardstick the port never calls) from CUDA events over
   a CUDA graph of many launches, beside ``bound_ms``: the larger of the
   bytes the function needs (the K/V of the keys its rows see, q, O) over
   3.35 TB/s and the attention flops over the dtype's peak; each row also
   carries the achieved share of the bound, GB/s and TFLOP/s, and the
   kernel's split count and row tile at that shape.
4. The server at full GPT-J-6B width: ``LLMEngine`` with the README's
   serving knobs (32 slots, 32-token blocks, 1024-token window, 256-token
   prefill chunks) answers 16 seeded requests, 8 of them sharing a
   256-token prefix, so radix hits and the copy-on-write block copy run.
   Every stream must reach its length, the block pool must audit clean,
   and the kernel's launch count must equal 28 x (prefill chunks + decode
   steps).
5. Kernel path against plain path end to end at full width: one batch
   through ``prefill`` and a few ``decode_step`` calls with
   ``paged_impl="kernel"`` and ``"reference"``; relative L2 error of the
   logits.
6. Where the time goes in serving: ms per decode step and per prefill
   chunk at the server's shapes on both paths, and profiler windows over
   decode steps and over prefill chunks (device busy ms per decode step
   and per prefill chunk, device time by kind, idle share).
   The serving weights and KV pool are released before the trainer's
   phases.
7. The four flash kernels (forward, delta, dK/dV, dQ) against their plain
   versions at GPT-J-6B's training shape (B=2, H=16, S=2048, D=256, bf16,
   causal), ``entry()``'s (B=2, H=4, S=256, D=128, bf16), a cross-length
   causal shape (sq=128, sk=384) and a ragged non-causal f32 shape
   (S=200, D=64), each (row, head) vector of O, dQ, dK, dV held relative
   to that vector's max (floored at 1% of the tensor's max), LSE and delta
   absolutely; at the training shape ``kernel_ms``, ``plain_ms``,
   ``bound_ms`` (from the products each kernel does on the causal pairs
   of this run, or for delta the bytes of O and dO) and ``library_ms``
   (SDPA with ``is_causal=True`` for the forward; SDPA's backward, timed
   as forward+backward minus forward, the median of 5 windows of 20
   calls with their minimum and maximum, for the three backward
   kernels), the achieved share of the bound and TFLOP/s (GB/s for
   delta), and ``flash_backward_total`` (delta + dK/dV + dQ against
   14 x D flops a pair and SDPA's backward); kernels timed over a CUDA
   graph of 20 launches, the others with CUDA events around calls.
8. The trainer: ``make_train_step`` at GPT-J-6B width cut to 8 of its 28
   layers (f32 masters and AdamW moments for all 28 would not fit 80 GB),
   batch 2 x 2048, remat ``"dots"``, lr 1e-4, fused CE in 512-token
   chunks: one warm-up step and 5 timed steps on one seeded batch. Loss
   and grad norm finite, the last loss below the first, and each flash
   kernel launched exactly 8 x steps. Step ms, tokens/s, MFU
   (``flops_per_token`` x tokens/s over 989 TFLOP/s) and peak memory.
9. Trainer end to end: same width, 2 layers, batch 1 x 2048, one loss
   and its gradients through the kernels and through
   ``attn_impl="reference"`` from the same weights: loss relative
   difference and gradient relative L2 (global and worst leaf) within
   stated bounds. A control run with a known attention fault (every row
   past the first tile loses the first 64 keys, as a k loop starting one
   tile late would) must land outside the gradient bounds, so that they
   separate a faulty kernel from a right one.
10. Where the time goes in a train step: one profiler window, device time
    by kind (flash forward, flash backward, matmul, other) and the idle
    share.

The second-to-last line is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # f32 outside tensor cores
# Kernel vs plain version: for every kept (row, head), max |got - want|
# over head_dim <= KERNEL_TOL x max |want| over the same vector. bf16: the
# kernel rounds p to bf16 before P.V and rounds O to bf16 (2^-9 relative
# each); the plain version stays in f32 until its output is rounded.
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
E2E_REL_L2_BOUND = 5e-2
L2_CACHE_BYTES = 50e6
# Flash kernels vs plain versions: every (row, head) vector of O, dQ, dK,
# dV: max |got - want| <= FLASH_TOL x max(max |want| of the vector, 1% of
# the tensor's max |want|); the floor keeps vectors that are zero in
# exact arithmetic (dQ of a causal row that sees one key) from dividing
# noise by noise. bf16: the forward rounds P to bf16 before P.V (as the
# TPU kernel did), the backward rounds P and dS to bf16 for its tensor-
# core products (the TPU kernel kept them in f32), outputs are bf16. f32:
# an exact f32 product in another order. LSE and delta (f32 sums of exact
# products): |got - want| <= FLASH_ABS x (1 + |want|).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
FLASH_ABS = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
# Trainer end to end, kernel path vs reference path from one set of
# weights: |loss_k - loss_r| / loss_r, and the relative L2 of the
# gradients, over all leaves together and leaf by leaf. The paths differ
# only inside attention (bf16 P and dS, another summation order). Each
# bound is a few times the kernel path's reading on the H100 (loss 9.5e-6,
# gradients 4.2e-3, worst leaf 6.5e-3); the gradient bounds must also lie
# below the control's readings. At random init the loss is near
# ln(vocab) whatever attention does, so the gradients carry the check.
TRAIN_LOSS_REL_BOUND = 1e-4
TRAIN_GRAD_REL_L2_BOUND = 1.5e-2
TRAIN_LEAF_REL_L2_BOUND = 2.5e-2
CONTROL_DROPPED_KEYS = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


# --------------------------------------------------------------- timing
def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Milliseconds per call of ``fn(i)``: ``iters`` calls captured in one
    CUDA graph (so host overhead does not pad the device time), timed with
    CUDA events over ``replays`` replays after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


# --------------------------------------------------------------- phase 3
@dataclasses.dataclass
class Shape:
    name: str
    B: int
    C: int
    H: int
    KVH: int
    D: int
    bs: int
    T: int
    dtype: torch.dtype
    lens: list
    starts: list        # first row position per sequence


def kernel_shapes():
    rng = np.random.default_rng(0)
    decode_lens = [0, 1, 1024, 31, 32, 33] + \
        rng.integers(1, 1025, 26).tolist()
    gqa_lens = rng.integers(1, 1025, 32).tolist()
    return [
        # GPT-J-6B decode at the serving knobs: 32 slots, 32-token
        # blocks, 1024-token window, mixed lengths incl. 0 and full
        Shape("gptj6b_decode", 32, 1, 16, 16, 256, 32, 32, torch.bfloat16,
              decode_lens, [max(n - 1, 0) for n in decode_lens]),
        # GPT-J-6B chunked prefill: one 256-token chunk at a start that
        # is not block aligned
        Shape("gptj6b_prefill", 1, 256, 16, 16, 256, 32, 32,
              torch.bfloat16, [300 + 256], [300]),
        # GQA (Llama-2-70B-style heads: 64/8 -> here 32/8) decode
        Shape("gqa_h32_kvh8_d128_decode", 32, 1, 32, 8, 128, 32, 32,
              torch.bfloat16, gqa_lens, [n - 1 for n in gqa_lens]),
        # f32, large staged page (dynamic shared memory past 48 KB)
        Shape("f32_d256_decode", 8, 1, 16, 16, 256, 32, 32, torch.float32,
              [1, 100, 1024, 512, 33, 700, 64, 999],
              [0, 99, 1023, 511, 32, 699, 63, 998]),
    ]


def live_pages(sh: Shape):
    """Pages the kernel reads per sequence: max(ceil(lens / bs), 1)."""
    from ray_tpu_torch.ops import paged_work_pages
    return [int(paged_work_pages(n, sh.bs)) for n in sh.lens]


def bound_ms(sh: Shape):
    """Least time for the work this call's data needs: K and V of each key
    a kept row sees (``min(lens, T * bs)`` per sequence, every kv head)
    read once, q read once, O written once, the table and positions read
    once; flops = 4 * D per (row, key) pair the rows see (QK^T and P.V),
    for every query head. The kernel itself reads whole live pages
    (``live_pages``), a few percent more K/V than this."""
    elt = torch.empty((), dtype=sh.dtype).element_size()
    keys = sum(min(max(n, 0), sh.T * sh.bs) for n in sh.lens)
    kv = 2 * keys * sh.KVH * sh.D * elt
    qo = 2 * sh.B * sh.C * sh.H * sh.D * elt
    meta = 4 * (sh.B * sh.T + sh.B * sh.C + sh.B)
    nbytes = kv + qo + meta
    pairs = 0
    for b in range(sh.B):
        for c in range(sh.C):
            p = sh.starts[b] + c
            pairs += min(p + 1, max(sh.lens[b], 0)) if p >= 0 else 0
    flops = 4 * sh.D * pairs * sh.H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[sh.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops, keys)


def row_errors(got, want, keep):
    """Max abs error, and the worst over kept (row, head) vectors of
    max |got - want| / max |want| within the vector."""
    g, w = got.float()[keep], want.float()[keep]          # [R, H, D]
    check(bool(torch.isfinite(g).all()), "non-finite kernel output")
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return err.max().item(), (err / scale).max().item()


def make_case(sh: Shape, dev, n_sets: int, seed: int):
    """Inputs of one shape. ``n_sets`` block tables over disjoint blocks
    of one pool, so that timing loops cycling over them read more than
    the L2 cache holds, as the model's other layers would leave it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 1 + sh.B * sh.T * n_sets
    kc = torch.randn((n, sh.bs, sh.KVH, sh.D), generator=gen, device=dev,
                     dtype=sh.dtype)
    vc = torch.randn((n, sh.bs, sh.KVH, sh.D), generator=gen, device=dev,
                     dtype=sh.dtype)
    q = torch.randn((sh.B, sh.C, sh.H, sh.D), generator=gen, device=dev,
                    dtype=sh.dtype)
    perm = np.random.default_rng(seed).permutation(sh.B * sh.T * n_sets)
    bts = torch.tensor((1 + perm).reshape(n_sets, sh.B, sh.T),
                       dtype=torch.int32, device=dev)
    pos = (torch.tensor(sh.starts, dtype=torch.int32)[:, None]
           + torch.arange(sh.C, dtype=torch.int32)[None, :]).to(dev)
    lens = torch.tensor(sh.lens, dtype=torch.int32, device=dev)
    return q, kc, vc, bts, pos, lens


def library_inputs(sh: Shape, q, kc, vc, bt, pos, lens):
    """The same live K/V gathered into contiguous [B, KVH, Lmax, D] with
    a boolean mask (key <= row position, key < live length) for one
    ``scaled_dot_product_attention`` call."""
    lmax = max(max(sh.lens), 1)
    pages = -(-lmax // sh.bs)
    k = kc[bt[:, :pages].long()].reshape(sh.B, pages * sh.bs, sh.KVH, sh.D)
    v = vc[bt[:, :pages].long()].reshape(sh.B, pages * sh.bs, sh.KVH, sh.D)
    k = k[:, :lmax].transpose(1, 2).contiguous()
    v = v[:, :lmax].transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()                   # [B, H, C, D]
    key = torch.arange(lmax, device=q.device)
    mask = (key[None, None, :] <= pos[:, :, None].long()) \
        & (key[None, None, :] < lens[:, None, None].long())
    return qt, k, v, mask[:, None]                         # [B, 1, C, L]


def phase_kernels(dev):
    from ray_tpu_torch.ops.paged_flash import (
        default_paged_block_r, paged_flash_attention,
        paged_flash_attention_plain, paged_row_tile, paged_split_plan)
    results = []
    for idx, sh in enumerate(kernel_shapes()):
        elt = torch.empty((), dtype=sh.dtype).element_size()
        pages = live_pages(sh)
        live_bytes = 2 * sum(pages) * sh.bs * sh.KVH * sh.D * elt
        n_sets = max(1, min(16, math.ceil(2 * L2_CACHE_BYTES / live_bytes)))
        q, kc, vc, bts, pos, lens = make_case(sh, dev, n_sets, seed=idx)
        got = paged_flash_attention(q, kc, vc, bts[0], pos, lens)
        want = paged_flash_attention_plain(q, kc, vc, bts[0], pos, lens)
        torch.cuda.synchronize()
        err, row_rel = row_errors(got, want, pos < lens[:, None])
        tol = KERNEL_TOL[sh.dtype]
        check(row_rel <= tol, f"{sh.name}: kernel vs plain error "
                              f"{row_rel} of a (row, head)'s max > {tol}")
        lib = [library_inputs(sh, q, kc, vc, bts[i], pos, lens)
               for i in range(n_sets)]
        iters = 20
        k_ms = graph_ms(lambda i: paged_flash_attention(
            q, kc, vc, bts[i % n_sets], pos, lens), iters)
        p_ms = graph_ms(lambda i: paged_flash_attention_plain(
            q, kc, vc, bts[i % n_sets], pos, lens), iters)
        l_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            lib[i % n_sets][0], lib[i % n_sets][1], lib[i % n_sets][2],
            attn_mask=lib[i % n_sets][3],
            enable_gqa=sh.H != sh.KVH), iters)
        b_ms, b_by, nbytes, flops, keys = bound_ms(sh)
        tile = paged_row_tile(default_paged_block_r(sh.C * (sh.H // sh.KVH)))
        row = {"shape": sh.name, "dtype": str(sh.dtype).split(".")[-1],
               "B": sh.B, "C": sh.C, "H": sh.H, "KVH": sh.KVH, "D": sh.D,
               "bs": sh.bs, "T": sh.T, "live_pages": sum(pages),
               "keys": keys, "bytes": nbytes, "flops": flops,
               "max_abs_err": err, "max_row_rel_err": row_rel,
               "row_rel_tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / k_ms,
               "achieved_gb_s": nbytes / k_ms / 1e6,
               "achieved_tflop_s": flops / k_ms / 1e9,
               "splits": paged_split_plan(sh.T * sh.bs)[0],
               "row_tile": tile}
        results.append(row)
        print("kernel " + json.dumps(row), flush=True)
        del q, kc, vc, bts, lib, got, want
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 4
def make_requests(seed: int, vocab: int):
    """16 prompts, 64-700 tokens; 8 start with one shared 256-token
    prefix (one of them is exactly the prefix: a fully matched,
    block-aligned prompt, so copy-on-write runs)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 256).tolist()
    prompts = [prefix + rng.integers(1, vocab, 180).tolist(), list(prefix)]
    for n in rng.integers(1, 700 - 256 + 1, 6):
        prompts.append(prefix + rng.integers(1, vocab, int(n)).tolist())
    for n in rng.integers(64, 701, 8):
        prompts.append(rng.integers(1, vocab, int(n)).tolist())
    return prompts


async def serve_all(engine, prompts, max_new: int):
    """Stream every prompt through ``LLMEngine.generate``. The first
    request goes alone until its first token (its prompt's full blocks
    are then in the radix trie); the other 15 follow together."""
    ttft = [None] * len(prompts)
    streams = [[] for _ in prompts]
    first_seen = asyncio.Event()

    async def one(i):
        t0 = time.perf_counter()
        async for tok in engine.generate(prompts[i], max_new):
            if not streams[i]:
                ttft[i] = time.perf_counter() - t0
                if i == 0:
                    first_seen.set()
            streams[i].append(tok)

    head = asyncio.ensure_future(one(0))
    seen = asyncio.ensure_future(first_seen.wait())
    await asyncio.wait([head, seen], return_when=asyncio.FIRST_COMPLETED)
    seen.cancel()
    if head.done():
        head.result()            # raises if the first request failed
    await asyncio.wait_for(asyncio.gather(
        head, *[one(i) for i in range(1, len(prompts))]), timeout=900)
    return streams, ttft


def wait_idle(engine, timeout_s: float = 120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = engine.stats()
        if s["free_slots"] == engine.config.decode_slots \
                and s["queue_depth"] == 0 and s["prefilling"] == 0:
            return s
        time.sleep(0.05)
    raise SmokeFailure(f"engine never drained: {engine.stats()}")


def phase_server(dev, card: str, cfg, params, seed: int):
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    from ray_tpu_torch.serve import EngineConfig, LLMEngine
    ec = EngineConfig(decode_slots=32, kv_block_size=32, max_seq_len=1024,
                      prefill_chunk=256, max_new_tokens=48)
    prompts = make_requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    engine = LLMEngine(cfg, ec, params=params, device=dev)
    try:
        kv_gb = ec.resolved_num_blocks * ec.kv_block_size \
            * ec.kv_bytes_per_token(cfg) / 1e9
        paged_flash_attention.kernel_launches = 0
        t0 = time.perf_counter()
        streams, ttft = asyncio.run(serve_all(engine, prompts, 48))
        wall = time.perf_counter() - t0
        launches = paged_flash_attention.kernel_launches
        s = wait_idle(engine)
        audit = engine.pool_audit()
    finally:
        engine.shutdown()
    check(all(len(t) == 48 for t in streams),
          f"stream lengths {[len(t) for t in streams]} != 48")
    check(all(0 <= tok < cfg.vocab_size for t in streams for tok in t),
          "token id out of the vocabulary")
    check(audit == [], f"pool audit after drain: {audit}")
    check(s["prefix_hit_blocks_total"] > 0, "no prefix hits")
    check(s["cow_copies_total"] >= 1, "copy-on-write never ran")
    calls = s["prefill_chunks"] + s["decode_steps"]
    check(launches > 0 and launches == cfg.n_layers * calls,
          f"kernel launches {launches} != {cfg.n_layers} x {calls}")
    tokens = sum(len(t) for t in streams)
    tt = np.asarray(ttft)
    out = {"card": card, "requests": len(prompts),
           "prompt_tokens": sum(len(p) for p in prompts),
           "generated_tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(tt, 50)),
           "ttft_p99_s": float(np.percentile(tt, 99)),
           "prefill_chunks": s["prefill_chunks"],
           "decode_steps": s["decode_steps"],
           "prefill_ms_per_chunk": 1e3 * s["prefill_wall_s"]
           / max(s["prefill_chunks"], 1),
           "decode_ms_per_step": 1e3 * s["decode_wall_s"]
           / max(s["decode_steps"], 1),
           "prefix_hit_blocks": s["prefix_hit_blocks_total"],
           "cow_copies": s["cow_copies_total"],
           "kernel_launches": launches, "kv_pool_gb": kv_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("server " + json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------- phase 5
def _forward_run(cfg, params, impl, toks, bt, lens, dev, feed=None):
    """One prefill chunk then 4 decode steps on a fresh cache. Returns
    the kept logits (flattened, f32) and the decode inputs it used."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill
    B, C = toks.shape
    c = dataclasses.replace(cfg, paged_impl=impl)
    cache = init_kv_cache(c, 1 + bt.numel(), 32, device=dev)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, cache = prefill(c, params, toks, cache, bt, start, lens)
        keep = torch.arange(C, device=dev)[None, :] < lens[:, None]
        outs = [logits[keep].float()]
        nxt = logits[torch.arange(B, device=dev), lens.long() - 1] \
            .argmax(-1).to(torch.int32)
        seq, fed = lens.clone(), []
        for step in range(4):
            tok = feed[step] if feed is not None else nxt
            fed.append(tok)
            logits, cache = decode_step(c, params, tok, cache, bt, seq)
            outs.append(logits.float())
            nxt = logits.argmax(-1).to(torch.int32)
            seq = seq + 1
    return torch.cat([o.reshape(-1) for o in outs]), fed


def phase_e2e(dev, cfg, params, seed: int):
    """Same params, fresh caches: one 256-token prefill chunk over 4
    sequences then 4 decode steps, the kernel path against the
    whole-window reference, both fed the kernel path's tokens."""
    rng = np.random.default_rng(seed + 1)
    B, C, T = 4, 256, 32
    lens = torch.tensor([256, 200, 131, 77], dtype=torch.int32, device=dev)
    toks = torch.tensor(rng.integers(1, cfg.vocab_size, (B, C)),
                        dtype=torch.int32, device=dev)
    bt = torch.tensor(1 + rng.permutation(B * T).reshape(B, T),
                      dtype=torch.int32, device=dev)
    a, fed = _forward_run(cfg, params, "kernel", toks, bt, lens, dev)
    b, _ = _forward_run(cfg, params, "reference", toks, bt, lens, dev, fed)
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "non-finite logits")
    rel = ((a - b).norm() / b.norm()).item()
    check(rel <= E2E_REL_L2_BOUND,
          f"kernel vs reference logits rel L2 {rel} > {E2E_REL_L2_BOUND}")
    out = {"rel_l2": rel, "bound": E2E_REL_L2_BOUND,
           "logits_compared": int(a.numel())}
    print("e2e " + json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------- phase 6
def _kind(name: str) -> str:
    if "paged_attention" in name or "paged_combine" in name:
        return "paged_attention"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "gemv",
                              "cublas", "wgmma", "sm90")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _profile_window(fn, n: int):
    """(wall ms, device ms by kind) of one torch.profiler window over
    ``n`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total", 0) or 0
        if dt > 0 and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            k = _kind(evt.key)
            by_kind[k] = by_kind.get(k, 0.0) + dt / 1e3
    return wall_ms, by_kind


def phase_profile(dev, cfg, params, seed: int):
    """Where the time goes at the server's shapes: ms per decode step
    (32 slots, 64-1000-token contexts) and per 256-token prefill chunk
    (at position 512), kernel path and reference path, from CUDA events;
    then torch.profiler windows over 3 decode steps and over 3 prefill
    chunks of the kernel path: device busy ms per step and per chunk, time
    by kind and the device's idle share."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill
    rng = np.random.default_rng(seed + 2)
    B, bs, T = 32, 32, 32
    lens = torch.tensor(rng.integers(64, 1000, B), dtype=torch.int32,
                        device=dev)
    toks = torch.tensor(rng.integers(1, cfg.vocab_size, B),
                        dtype=torch.int32, device=dev)
    bt = torch.tensor(1 + rng.permutation(B * T).reshape(B, T),
                      dtype=torch.int32, device=dev)
    chunk = torch.tensor(rng.integers(1, cfg.vocab_size, (1, 256)),
                         dtype=torch.int32, device=dev)
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "reference"):
            c = dataclasses.replace(cfg, paged_impl=impl)
            cache = init_kv_cache(c, 1 + B * T, bs, device=dev)

            def step():
                decode_step(c, params, toks, cache, bt, lens)

            def chunk_call():
                prefill(c, params, chunk, cache, bt[:1],
                        torch.tensor([512], dtype=torch.int32, device=dev),
                        torch.tensor([256], dtype=torch.int32, device=dev))

            for fn, key, n in ((step, "decode_step_ms", 10),
                               (chunk_call, "prefill_chunk_ms", 5)):
                fn()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(n):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                out[f"{impl}_{key}"] = e0.elapsed_time(e1) / n
            if impl == "kernel":
                wall_ms, by_kind = _profile_window(step, 3)
                busy = sum(by_kind.values())
                out["profile_decode_steps"] = 3
                out["profile_wall_ms"] = wall_ms
                out["profile_device_ms_by_kind"] = by_kind
                out["profile_device_busy_ms"] = busy
                out["device_busy_ms_per_decode_step"] = busy / 3
                out["paged_ms_per_decode_step"] = \
                    by_kind.get("paged_attention", 0.0) / 3
                _, chunk_kinds = _profile_window(chunk_call, 3)
                out["profile_prefill_device_ms_by_kind"] = chunk_kinds
                out["device_busy_ms_per_prefill_chunk"] = \
                    sum(chunk_kinds.values()) / 3
                out["paged_ms_per_prefill_chunk"] = \
                    chunk_kinds.get("paged_attention", 0.0) / 3
                # the profiler slows the host, so its own window
                # overstates idle time; the share below sets the device
                # busy time per step against the unprofiled step time
                out["profile_idle_share"] = (1 - busy / wall_ms
                                             if busy else None)
                out["idle_share_unprofiled"] = (
                    1 - busy / 3 / out["kernel_decode_step_ms"]
                    if busy else None)
            del cache
            torch.cuda.empty_cache()
    print("profile " + json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------- phase 2
SOURCES = ("paged_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
           "flash_attention.cu")


def ptxas_report(log: str):
    """(kernel, registers, spill bytes, shared bytes) of each entry in
    ptxas's ``-v`` report."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out.append([name, None, 0, 0])
        elif name and "spill stores" in line:
            words = line.replace(",", " ").split()
            out[-1][2] = sum(int(words[i - 2]) for i, w in enumerate(words)
                             if w == "spill")
        elif name and "registers" in line:
            words = line.replace(",", " ").split()
            out[-1][1] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[-1][3] = int(words[words.index("smem") - 2])
    return out


def phase_build():
    from ray_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    for source in SOURCES:
        _build.load_library(source)
        log = _build.build_logs.get(source)
        print(f"build: {source} "
              + (f"built in {log['seconds']:.2f} s" if log
                 else "already built in this checkout"), flush=True)
        if not log:
            continue
        for line in str(log["log"]).splitlines():
            if "warning" in line.lower():
                print("nvcc: " + line.strip(), flush=True)
        for name, regs, spill, smem in ptxas_report(str(log["log"])):
            print(f"ptxas: {source} {name}: {regs} registers, {spill} "
                  f"bytes spilled, {smem} bytes static smem", flush=True)
            check(not ("_sm90" in name and spill),
                  f"ptxas spilled {spill} bytes in {name}")
    lib = _build.load_library("flash_bwd_sm90.cu")
    for kernel, name in enumerate(("flash_dkdv_sm90_kernel",
                                   "flash_dq_sm90_kernel")):
        print(f"smem: {name}: " + ", ".join(
            f"D<={d} {lib.flash_bwd_sm90_smem(kernel, d)} B dynamic"
            for d in (64, 128, 256)), flush=True)
    print(f"build: {len(SOURCES)} libraries loaded in "
          f"{time.perf_counter() - t0:.2f} s (wall)", flush=True)


def serving_phases(dev, card: str, seed: int):
    """Phases 3-6 on GPT-J-6B's serving weights (bf16, 12 GB); the
    weights are released when this returns. Returns the paged kernel's
    record."""
    from ray_tpu_torch.models import get_config, init_params
    shapes = phase_kernels(dev)
    cfg = get_config("gptj-6b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size() for grp in params.values()
                 for t in (grp.values() if isinstance(grp, dict) else [grp]))
    print(f"params: gptj-6b {cfg.num_params / 1e9:.3f} B parameters, "
          f"{pbytes / 1e9:.2f} GB, made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    server = phase_server(dev, card, cfg, params, seed)
    phase_e2e(dev, cfg, params, seed)
    phase_profile(dev, cfg, params, seed)
    main_shape = shapes[0]              # gptj-6b decode: 28 per step
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_flash.py:71",
        "launches": server["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "max_row_rel_err": max(r["max_row_rel_err"] for r in shapes),
        "ms": main_shape["kernel_ms"],
        "kernel_ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "bound_share": main_shape["bound_share"],
        "splits": main_shape["splits"],
        "prefill_ms": shapes[1]["kernel_ms"],
        "prefill_library_ms": shapes[1]["library_ms"],
        "timed_shape": main_shape["shape"],
        "shapes": shapes,
    }


# --------------------------------------------------------------- phase 7
@dataclasses.dataclass
class FlashShape:
    name: str
    B: int
    Sq: int
    Sk: int
    H: int
    D: int
    dtype: torch.dtype
    causal: bool


def flash_shapes():
    return [
        # GPT-J-6B training: the trainer phase's attention calls
        FlashShape("gptj6b_train", 2, 2048, 2048, 16, 256, torch.bfloat16,
                   True),
        # entry()'s model: d_model 512 = 4 heads x 128, seq 256
        FlashShape("entry", 2, 256, 256, 4, 128, torch.bfloat16, True),
        # end-aligned causality with sq < sk
        FlashShape("cross_len_causal", 2, 128, 384, 4, 128, torch.bfloat16,
                   True),
        # ragged tiles (200 = 3 x 64 + 8), non-causal, f32
        FlashShape("ragged_f32", 2, 200, 200, 4, 64, torch.float32, False),
    ]


# where each wrapper's bf16 kernel lives (the others: flash_attention.cu)
FLASH_SOURCES = {"flash_fwd": "ray_tpu_torch/csrc/flash_fwd_sm90.cu",
                 "flash_dkdv": "ray_tpu_torch/csrc/flash_bwd_sm90.cu",
                 "flash_dq": "ray_tpu_torch/csrc/flash_bwd_sm90.cu"}
FLASH_KERNELS = {
    # wrapper name: the TPU kernel it replaces (file:line of its body)
    "flash_fwd": "ray_tpu/ops/flash_attention.py:59",
    "flash_delta": "ray_tpu/ops/flash_attention.py:169",
    "flash_dkdv": "ray_tpu/ops/flash_attention.py:201",
    "flash_dq": "ray_tpu/ops/flash_attention.py:255",
}


def flash_pairs(sh: FlashShape) -> int:
    """(row, key) pairs the rows see, over all batches and heads."""
    if not sh.causal:
        return sh.B * sh.H * sh.Sq * sh.Sk
    off = sh.Sk - sh.Sq
    per = sum(min(i + off + 1, sh.Sk) for i in range(sh.Sq))
    return sh.B * sh.H * per


def flash_bounds(sh: FlashShape):
    """Per kernel: (bound_ms, bound_by, bytes, flops). Bytes: each input
    read once, each output written once. Flops: the products on the
    pairs the rows see (forward 4*D per pair, dK/dV 8*D, dQ 6*D; delta
    2*D per row). ``flash_backward_total`` is the whole backward (delta,
    dK/dV, dQ): q, k, v, O, dO and the LSE in, dQ, dK, dV out, 14*D flops
    a pair."""
    elt = torch.empty((), dtype=sh.dtype).element_size()
    qo = sh.B * sh.Sq * sh.H * sh.D * elt
    kv = sh.B * sh.Sk * sh.H * sh.D * elt
    row = sh.B * sh.H * sh.Sq * 4
    pairs = flash_pairs(sh)
    work = {
        "flash_fwd": (qo + 2 * kv + qo + row, 4 * sh.D * pairs),
        "flash_delta": (2 * qo + row, 2 * sh.D * sh.B * sh.H * sh.Sq),
        "flash_dkdv": (2 * qo + 2 * kv + 2 * row + 2 * kv,
                       8 * sh.D * pairs),
        "flash_dq": (2 * qo + 2 * kv + 2 * row + qo, 6 * sh.D * pairs),
        "flash_backward_total": (4 * qo + 4 * kv + row, 14 * sh.D * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[sh.dtype] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def vec_errors(got, want):
    """Max abs error, and the worst (row, head) vector's max |got - want|
    over max(its max |want|, 1% of the tensor's max |want|)."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "non-finite kernel output")
    check(w.abs().max().item() > 0, "the plain version's output is all 0")
    err = (g - w).abs().amax(-1)
    floor = max(1e-2 * w.abs().max().item(), torch.finfo(torch.float32).tiny)
    scale = w.abs().amax(-1).clamp_min(floor)
    return err.max().item(), (err / scale).max().item()


def abs_errors(got, want):
    """Max abs error, and the worst |got - want| / (1 + |want|)."""
    d = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    return d.max().item(), (d / (1 + want.float().abs())).max().item()


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()`` from CUDA events around ``iters``
    calls after ``warmup`` calls: for calls whose device time dwarfs
    their host time (plain versions, library calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_flash_kernels(dev):
    from ray_tpu_torch.ops.flash_attention import (
        flash_delta, flash_delta_plain, flash_dkdv, flash_dkdv_plain,
        flash_dq, flash_dq_plain, flash_fwd, flash_fwd_plain)
    results = []
    for idx, sh in enumerate(flash_shapes()):
        gen = torch.Generator(device=dev).manual_seed(100 + idx)

        def randn(s):
            return torch.randn((sh.B, s, sh.H, sh.D), generator=gen,
                               device=dev, dtype=sh.dtype)
        q, k, v, do = randn(sh.Sq), randn(sh.Sk), randn(sh.Sk), randn(sh.Sq)
        kw = dict(causal=sh.causal)
        o, lse = flash_fwd(q, k, v, **kw)
        o_p, lse_p = flash_fwd_plain(q, k, v, **kw)
        delta = flash_delta(o_p, do)
        delta_p = flash_delta_plain(o_p, do)
        bwd_in = (q, k, v, do, lse_p, delta_p)
        dk, dv = flash_dkdv(*bwd_in, **kw)
        dk_p, dv_p = flash_dkdv_plain(*bwd_in, **kw)
        dq = flash_dq(*bwd_in, **kw)
        dq_p = flash_dq_plain(*bwd_in, **kw)
        torch.cuda.synchronize()
        tol, atol = FLASH_TOL[sh.dtype], FLASH_ABS[sh.dtype]
        errs = {}
        for name, pairs in (("flash_fwd", [(o, o_p)]),
                            ("flash_dkdv", [(dk, dk_p), (dv, dv_p)]),
                            ("flash_dq", [(dq, dq_p)])):
            e = [vec_errors(g, w) for g, w in pairs]
            errs[name] = (max(a for a, _ in e), max(r for _, r in e))
            check(errs[name][1] <= tol,
                  f"{sh.name}: {name} vs plain error {errs[name][1]} of a "
                  f"(row, head)'s max > {tol}")
        lse_err = abs_errors(lse, lse_p)
        check(lse_err[1] <= atol, f"{sh.name}: LSE error {lse_err}")
        errs["flash_delta"] = abs_errors(delta, delta_p)
        check(errs["flash_delta"][1] <= atol * max(sh.D / 64, 1),
              f"{sh.name}: delta error {errs['flash_delta']}")
        row = {"shape": sh.name, "dtype": str(sh.dtype).split(".")[-1],
               "B": sh.B, "Sq": sh.Sq, "Sk": sh.Sk, "H": sh.H, "D": sh.D,
               "causal": sh.causal, "pairs": flash_pairs(sh),
               "lse_max_abs_err": lse_err[0],
               "errors": {n: {"max_abs_err": a, "max_rel_err": r}
                          for n, (a, r) in errs.items()},
               "row_rel_tol": tol, "abs_tol": atol}
        if idx == 0:   # the trainer's shape: time every kernel
            row["timing"] = time_flash(sh, q, k, v, do, o_p, lse_p, delta_p)
        results.append(row)
        print("flash " + json.dumps(row), flush=True)
        del q, k, v, do, o, o_p, lse, lse_p, delta, delta_p, dk, dv, dq
        del dk_p, dv_p, dq_p, bwd_in
        torch.cuda.empty_cache()
    return results


def time_flash(sh, q, k, v, do, o, lse, delta):
    from ray_tpu_torch.ops.flash_attention import (
        flash_delta, flash_delta_plain, flash_dkdv, flash_dkdv_plain,
        flash_dq, flash_dq_plain, flash_fwd, flash_fwd_plain)
    kw = dict(causal=sh.causal)
    bwd_in = (q, k, v, do, lse, delta)
    calls = {
        "flash_fwd": (lambda: flash_fwd(q, k, v, **kw),
                      lambda: flash_fwd_plain(q, k, v, **kw)),
        "flash_delta": (lambda: flash_delta(o, do),
                        lambda: flash_delta_plain(o, do)),
        "flash_dkdv": (lambda: flash_dkdv(*bwd_in, **kw),
                       lambda: flash_dkdv_plain(*bwd_in, **kw)),
        "flash_dq": (lambda: flash_dq(*bwd_in, **kw),
                     lambda: flash_dq_plain(*bwd_in, **kw)),
    }
    # SDPA (a yardstick the port never calls) on the same inputs laid out
    # [B, H, S, D]; its backward is timed as forward+backward - forward
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=sh.causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=sh.causal)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    # SDPA's backward spreads from window to window: the median of 5
    # windows of 20 calls, each its forward+backward minus the forward
    lib_fwd = events_ms(sdpa_fwd, 20)
    windows = []
    for _ in range(5):
        f = events_ms(sdpa_fwd, 20)
        windows.append(events_ms(sdpa_fwd_bwd, 20) - f)
    lib_bwd = float(np.median(windows))
    bounds = flash_bounds(sh)
    out = {}
    for name, (kernel, plain) in calls.items():
        b_ms, b_by, nbytes, flops = bounds[name]
        # the kernel over a CUDA graph (delta takes ~20 us, less than its
        # wrapper's host time); the plain versions and SDPA are
        # millisecond-scale or one launch, so events around calls do
        k_ms = graph_ms(lambda i: kernel(), 20)
        out[name] = {"kernel_ms": k_ms,
                     "plain_ms": events_ms(plain, 3, warmup=1),
                     "library_ms": lib_fwd if name == "flash_fwd"
                     else lib_bwd,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "flops": flops, "bound_share": b_ms / k_ms,
                     "achieved_tflop_s": flops / k_ms / 1e9,
                     "achieved_gb_s": nbytes / k_ms / 1e6}
    out["library_fwd_bwd_ms"] = lib_fwd + lib_bwd
    out["library_bwd_ms_windows"] = {"median": lib_bwd, "min": min(windows),
                                     "max": max(windows), "all": windows}
    b_ms, b_by, nbytes, flops = bounds["flash_backward_total"]
    k_ms = sum(out[n]["kernel_ms"] for n in ("flash_delta", "flash_dkdv",
                                             "flash_dq"))
    out["flash_backward_total"] = {
        "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops, "bound_share": b_ms / k_ms,
        "achieved_tflop_s": flops / k_ms / 1e9, "library_ms": lib_bwd,
        "ratio_to_library": k_ms / lib_bwd}
    return out


# --------------------------------------------------------------- phase 8
TRAIN_LAYERS = 8
TRAIN_BATCH = 2
TIMED_STEPS = 5


def _flash_launches():
    from ray_tpu_torch.ops.flash_attention import (flash_delta, flash_dkdv,
                                                   flash_dq, flash_fwd)
    return {f.__name__: f for f in (flash_fwd, flash_delta, flash_dkdv,
                                    flash_dq)}


def phase_trainer(dev, card: str, seed: int):
    from ray_tpu_torch.models import get_config, make_train_step
    cfg = get_config("gptj-6b", n_layers=TRAIN_LAYERS)
    S = cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    bundle = make_train_step(cfg, learning_rate=1e-4, remat_policy="dots",
                             ce_chunk_size=512, device=dev)
    t0 = time.perf_counter()
    state = bundle.init(seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      _named(state))
    rng = np.random.default_rng(seed + 3)
    batch = {"input_ids": torch.tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, S)), device=dev)}
    wrappers = _flash_launches()
    for f in wrappers.values():
        f.kernel_launches = 0
    losses, norms, times = [], [], []
    for i in range(1 + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = bundle.step(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    launches = {n: f.kernel_launches for n, f in wrappers.items()}
    steps = 1 + TIMED_STEPS
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for n, c in launches.items():
        check(c == TRAIN_LAYERS * steps,
              f"{n} launched {c} times, not {TRAIN_LAYERS} x {steps}")
    step_s = float(np.mean(times))
    tokens = TRAIN_BATCH * S
    tok_s = tokens / step_s
    flops_tok = cfg.flops_per_token(S)
    out = {"card": card, "config": f"gptj-6b n_layers={TRAIN_LAYERS}",
           "params": cfg.num_params, "batch": [TRAIN_BATCH, S],
           "remat_policy": "dots", "state_gb": state_bytes / 1e9,
           "init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_ms": 1e3 * step_s, "step_ms_min": 1e3 * min(times),
           "step_ms_max": 1e3 * max(times), "tokens_per_s": tok_s,
           "flops_per_token": flops_tok,
           "mfu": flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16],
           "launches": launches, "steps": steps,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("trainer " + json.dumps(out), flush=True)
    return out, bundle, state, batch


def _named(tree, prefix=""):
    """(dotted name, tensor) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


# --------------------------------------------------------------- phase 9
def _dropped_tile_attention(c, q, k, v):
    """Control: causal attention with a fault a kernel could have, its k
    loop starting one tile late, so that every row past the first tile
    loses the first ``CONTROL_DROPPED_KEYS`` keys."""
    from ray_tpu_torch.ops.attention import attention_reference
    i = torch.arange(q.shape[1], device=q.device)
    keep = (i[None, :] >= CONTROL_DROPPED_KEYS) \
        | (i[:, None] < CONTROL_DROPPED_KEYS)
    return attention_reference(q, k, v, causal=True, mask=keep[None, None])


def _grad_rel(gk, gr, names):
    """Relative L2 of the gradients over all leaves, and per leaf."""
    num = sum(((a.float() - b.float()) ** 2).sum().item()
              for a, b in zip(gk, gr))
    den = sum((b.float() ** 2).sum().item() for b in gr)
    leaf_rel = {}
    for n, a, b in zip(names, gk, gr):
        d = (b.float() ** 2).sum().sqrt().item()
        leaf_rel[n] = ((a.float() - b.float()) ** 2).sum().sqrt().item() \
            / max(d, 1e-30)
    return math.sqrt(num / den), leaf_rel


def phase_train_e2e(dev, seed: int):
    """GPT-J-6B width, 2 layers, one 2048-token sequence: loss and
    gradients through the flash kernels, through the reference attention
    and through the faulty control attention, from the same f32 weights."""
    from ray_tpu_torch.models import get_config, init_params, lm_loss
    from ray_tpu_torch.models import transformer
    cfg = get_config("gptj-6b", n_layers=2)
    params = init_params(cfg, seed=seed + 4, device=dev)
    names = [n for n, _ in _named(params)]
    leaves = [t.requires_grad_() for _, t in _named(params)]
    rng = np.random.default_rng(seed + 5)
    batch = {"input_ids": torch.tensor(
        rng.integers(0, cfg.vocab_size, (1, cfg.max_seq_len)), device=dev)}
    wrappers = _flash_launches()
    runs = {}
    for impl in ("auto", "reference", "control"):
        c = dataclasses.replace(cfg, attn_impl="reference" if impl ==
                                "control" else impl, remat=None,
                                remat_policy="dots")
        before = {n: f.kernel_launches for n, f in wrappers.items()}
        attention = transformer._attention
        if impl == "control":
            transformer._attention = _dropped_tile_attention
        try:
            loss, _ = lm_loss(c, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            transformer._attention = attention
        torch.cuda.synchronize()
        used = {n: f.kernel_launches - before[n] for n, f in wrappers.items()}
        runs[impl] = (loss.item(), grads, used)
    check(all(v == 2 for v in runs["auto"][2].values()),
          f"kernel path launches {runs['auto'][2]} (want 2 each)")
    for impl in ("reference", "control"):
        check(all(v == 0 for v in runs[impl][2].values()),
              f"{impl} path launched kernels: {runs[impl][2]}")
    lr, gr, _ = runs["reference"]
    read = {}
    for impl in ("auto", "control"):
        lx, gx, _ = runs[impl]
        check(math.isfinite(lx) and math.isfinite(lr), "non-finite loss")
        grad_rel, leaf_rel = _grad_rel(gx, gr, names)
        worst = max(leaf_rel, key=leaf_rel.get)
        read[impl] = {"loss": lx, "loss_rel": abs(lx - lr) / abs(lr),
                      "grad_rel_l2": grad_rel, "worst_leaf": worst,
                      "worst_leaf_rel_l2": leaf_rel[worst],
                      "leaf_rel_l2": leaf_rel}
    k, ctl = read["auto"], read["control"]
    check(k["loss_rel"] <= TRAIN_LOSS_REL_BOUND,
          f"loss rel diff {k['loss_rel']} > {TRAIN_LOSS_REL_BOUND}")
    check(k["grad_rel_l2"] <= TRAIN_GRAD_REL_L2_BOUND,
          f"grad rel L2 {k['grad_rel_l2']} > {TRAIN_GRAD_REL_L2_BOUND}")
    check(k["worst_leaf_rel_l2"] <= TRAIN_LEAF_REL_L2_BOUND,
          f"leaf {k['worst_leaf']} grad rel L2 {k['worst_leaf_rel_l2']} > "
          f"{TRAIN_LEAF_REL_L2_BOUND}")
    check(ctl["grad_rel_l2"] > TRAIN_GRAD_REL_L2_BOUND
          and ctl["worst_leaf_rel_l2"] > TRAIN_LEAF_REL_L2_BOUND,
          f"the faulty control's gradients (rel L2 {ctl['grad_rel_l2']}, "
          f"worst leaf {ctl['worst_leaf_rel_l2']}) pass the bounds: they "
          f"do not separate a faulty attention")
    out = {"loss_kernel": k["loss"], "loss_reference": lr,
           "loss_rel": k["loss_rel"], "grad_rel_l2": k["grad_rel_l2"],
           "worst_leaf": k["worst_leaf"],
           "worst_leaf_rel_l2": k["worst_leaf_rel_l2"],
           "leaf_rel_l2": k["leaf_rel_l2"],
           "control": {n: ctl[n] for n in ("loss", "loss_rel", "grad_rel_l2",
                                           "worst_leaf", "worst_leaf_rel_l2")},
           "bounds": [TRAIN_LOSS_REL_BOUND, TRAIN_GRAD_REL_L2_BOUND,
                      TRAIN_LEAF_REL_L2_BOUND]}
    print("train_e2e " + json.dumps(out), flush=True)
    return out


# -------------------------------------------------------------- phase 10
def _train_kind(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_forward"
    if any(k in name for k in ("flash_delta_kernel", "flash_dkdv",
                               "flash_dq")):
        return "flash_backward"
    return _kind(name)


def phase_train_profile(bundle, state, batch, step_ms: float):
    """One torch.profiler window over one train step: device time by
    kind and the device's idle share (against the profiled step's wall
    and against the unprofiled step time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, by_name = {}, {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total", 0) or 0
        if dt > 0 and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
            k = _train_kind(evt.key)
            by_kind[k] = by_kind.get(k, 0.0) + dt / 1e3
            by_name[evt.key[:90]] = (by_name.get(evt.key[:90], (0.0, 0))[0]
                                     + dt / 1e3, evt.count)
    busy = sum(by_kind.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {"profile_wall_ms": wall_ms, "device_ms_by_kind": by_kind,
           "device_busy_ms": busy, "profile_idle_share": 1 - busy / wall_ms,
           "idle_share_unprofiled": 1 - busy / step_ms,
           "top_kernels_ms_count": [[n, ms, c] for n, (ms, c) in top]}
    print("train_profile " + json.dumps(out), flush=True)
    return out


def training_phases(dev, card: str, seed: int):
    """Phases 7-10. Returns the four flash kernels' records."""
    flash = phase_flash_kernels(dev)
    trainer, bundle, state, batch = phase_trainer(dev, card, seed)
    phase_train_profile(bundle, state, batch, trainer["step_ms"])
    del bundle, state, batch
    torch.cuda.empty_cache()
    phase_train_e2e(dev, seed)
    timing = flash[0]["timing"]
    records = []
    for name, replaces in FLASH_KERNELS.items():
        t = timing[name]
        records.append({
            "name": name,
            "route": "cuda",
            "source": FLASH_SOURCES.get(
                name, "ray_tpu_torch/csrc/flash_attention.cu"),
            "replaces": replaces,
            "launches": trainer["launches"][name],
            "max_abs_err": max(r["errors"][name]["max_abs_err"]
                               for r in flash),
            "max_rel_err": max(r["errors"][name]["max_rel_err"]
                               for r in flash),
            "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "bound_share": t["bound_share"],
            "timed_shape": flash[0]["shape"],
        })
    return records


# ----------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch.cuda.get_device_name(0)={name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    phase_build()
    kernels = [serving_phases(dev, card, args.seed)]
    torch.cuda.empty_cache()
    print(f"released serving: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB still allocated", flush=True)
    kernels.extend(training_phases(dev, card, args.seed))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
