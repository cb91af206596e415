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
   shapes (GPT-J-6B decode, chunked prefill and the speculative verify of
   32 slots x 5 rows with 0-4 drafts a slot, a GQA shape, an f32
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
   Request 0 goes alone until its first token, then the other 15 at once
   (``gate_burst`` holds the engine at the next step boundary until all
   15 are pending, so the step counts do not hang on arrival timing).
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
6a. Speculative serving: one profiler window over 3 decode steps and one
   over 3 verify calls (``prefill`` at 32 x 5) at the server's shapes
   (device busy per step each); then 16 seeded prompts of 64-700 tokens
   that repeat a 16-48-token segment with ~5% of it replaced, 48 new
   tokens each, through an engine with phase 4's knobs and
   ``spec_tokens=4`` and through a spec-off engine with the same
   weights: tokens/s, TTFT p50/p99, ms per decode (verify) step, drafted
   and accepted tokens, tokens per step. Streams reach their length,
   pools audit clean, drafts were made, paged launches = 28 x (prefill
   chunks + decode steps), and each spec-on stream equals its spec-off
   stream or first leaves it at a near tie (the verify's matmuls have
   5x the rows and may round otherwise): a replay of the spec-off step
   picks the spec-off token, the spec-on token scores within 1% of the
   top logit's magnitude there, and the request served alone through a
   speculative engine picks the spec-on token again; each divergence
   printed.
6b. Log-probabilities and weight staging: ``capture_logprobs=True`` with
   ``detailed`` streams over the same prompts; tokens equal the spec-off
   run's, logprobs finite and <= 0, each first token's logprob within
   2e-2 of a log-softmax of direct ``prefill`` logits; mid-run,
   ``stage_weights(version=1)`` of the tree with its LM head doubled,
   written on a side stream behind a device sleep: every later token is
   stamped 1, its logprob is that of the doubled logits (so the staged
   tree is the one used, and only after the side stream's writes), one
   swap, no sync stall.
6c. KV hand-off: ``prefill_export`` on one engine, ``submit_adopt`` on
   another sharing the weights, for the 4 longest prompts on the bf16
   and the int8 wire: bf16 streams equal the colocated ones and
   ``wire_bytes == kv_ship_bytes``; int8 first tokens exact and each
   quant block's round-trip error within scale/2; export and adopt ms
   and bytes per hand-off.
6d. Tracing: every request sampled on an ``enable_trace=True`` engine;
   each waterfall has QUEUED, ADMITTED, PREFILL, FIRST_TOKEN, DECODE and
   DONE; tokens/s with tracing on against the spec-off (tracing off) run.
   The serving weights and KV pools are released before the runtime's
   phases.
R1. Serialization and the store: phase 6c's longest hand-off slab (k and
   v of 22 blocks over 28 layers, bf16, 323.0 MB, on the card), a small
   f32 tensor and a nested tuple of mixed tensors through the port's
   serializer into the native shared-memory store and back; bits equal
   after the copy back to the card; ms and GB/s of the device-to-host
   copy, the store write, the read and the host-to-device copy. Fails
   unless the native (C++) store served.
R2. The runtime on the card: ``ray_tpu_torch.init`` counts the card as
   ``GPU``; the slab through ``put``/``get``, and as the argument and
   the return of a ``num_gpus=1`` task that moves it to its card (bits
   and per-leaf checksums equal, the worker's card is this card); init
   wall, warm task round trip, the slab's ms and GB/s; three GPU calls
   made after default-shape tasks run on one worker, none of them new
   (the controller keeps a worker that ran a GPU task out of the
   driver's default-shape leases).
R3. GPT-J-6B served from a ``num_gpus=1`` actor: the actor builds the
   engine at full depth with phase 4's knobs from phase 4's seed (its
   weights' checksum equals the driver's) and answers phase 4's 16
   requests, sent as streaming actor calls in phase 4's pattern (the
   actor gates its engine as phase 4's, so that the 15 calls, which
   arrive one at a time, enter one admission). Streams
   reach their length, the pool audits clean, the actor's paged launch
   count equals 28 x (prefill chunks + decode steps), and each stream
   equals phase 4's or first leaves it at a near tie (``near_tie``, the
   replays run in the actor); tokens/s and TTFT beside phase 4's. The
   actor is killed and the runtime shut down; the card's free memory
   comes back.
S1. GPT-J-6B through ``serve.run`` and HTTP, on a runtime of its own:
   ``serve.deployment(LLMServer, ray_actor_options={"num_gpus": 1})``
   with phase 4's model (as a plain dict, ``"dtype": "bfloat16"``),
   knobs (``max_new_tokens=48``) and seed; the replica's weights'
   checksum equals the driver's and it serves from this card. Phase 4's
   16 requests go over HTTP to the proxy in phase 4's pattern, each read
   on its own thread as JSON lines, then one streaming handle call for
   request 0. Streams reach 48 tokens and equal phase 4's or leave them
   at a confirmed near tie (replayed in the replica, reached through the
   runtime's generic actor call), the pool audits clean, and the
   replica's paged launches equal 28 x (prefill chunks + decode steps).
   Tokens/s and TTFT p50/p99 beside phase 4's and R3's, the replica's
   ready time and peak memory.
S2. The disaggregated pair, on a runtime of its own:
   ``deploy_disaggregated(model, engine, num_prefill=1, num_decode=1,
   route_prefix="/pd")`` at phase 4's knobs on the bf16 wire; phase 4's
   4 longest prompts over HTTP as ``{"prompt", "max_new_tokens": 48}``.
   Streams equal phase 4's or leave them at a confirmed near tie, both
   pools audit clean, each replica's paged launches equal 28 x its own
   chunks and steps, and the bytes shipped equal ``kv_ship_bytes``;
   TTFT, and export, ship and adopt ms and bytes a hand-off (the KV goes
   card -> host -> shm -> host -> card). After each of S1 and S2,
   ``serve.shutdown()`` kills the replicas and the runtime is shut down;
   the card's free memory comes back before the RLHF phases.
RL1. RLHF, anakin: ``RLHFTrainer`` with one local PPO learner and one
   rollout engine at GPT-J-6B width cut to 8 of 28 layers (f32 masters,
   gradients and Adam take 32.4 GB; the engine's bf16 weights, a staged
   copy and the pool about 9 GB more), bf16 compute, random weights from
   the seed; a seeded 256-token system prompt and 32-token suffixes, 64
   new tokens, 16 rollouts a round on 16 decode slots (32-token blocks,
   256-token chunks, a 384-token window), minibatches of 4, one round
   (a round with its publish takes about 45 s of host time, most of it
   the numpy int8 pack and unpack of 2.02 B weights).
   Every round: 16 trajectories, prefix hit rate > 0.5, no sync stall,
   staleness <= 1, the engines' version equal to the publishes, wire
   compression > 3.5. Round 1's tokens (all version 0) recomputed from
   the learner's weights before its first update through ``apply`` (the
   flash forward) lie within 2e-2 of the log-probabilities the engine
   captured through the paged kernel on average, each within four bf16
   grid steps of a logit in [4, 8) (``RL_V0_TOKEN_BOUND``), and a
   control read one position late lies outside; the first gradient
   round's ratio_mean is within 1e-2 of 1. After round 1's publish a
   probe prompt is served at version 1, its first token the argmax and
   its log-probability that of direct ``prefill`` logits of
   ``unpack_weights(pack_weights(w))``, farther from version 0's. Paged launches 8 x the engine's prefill chunks and decode
   steps, each flash kernel 8 x ``compute_gradients`` calls. Round,
   rollout, update and publish walls, wire bytes, pack/unpack host time,
   peak memory.
RL2. RLHF, sebulba, on a runtime of its own: 2 remote learners (each
   ``{"num_cpus": 1}``, on the card through ``device=None`` in its
   worker) and 2 engines in the driver at 2 layers; 8 rollouts, one
   gradient round of 4 rows a learner, one round. Both learners used on
   disjoint shards, their weights bit-identical after the round (sha256),
   a publish through the store with no sync stall and staleness <= 1,
   each learner's flash launches 2 x its ``compute_gradients`` calls,
   paged launches 2 x the engines' chunks and steps; the gradient round's
   wall split into compute, gradients out through the store, the host
   mean and the mean back. After each of RL1 and RL2 the card's free
   memory comes back before the trainer's phases.
7. The four flash kernels (forward, delta, dK/dV, dQ) against their plain
   versions at GPT-J-6B's training shape (B=2, H=16, S=2048, D=256, bf16,
   causal), ``entry()``'s (B=2, H=4, S=256, D=128, bf16), a cross-length
   causal shape (sq=128, sk=384), a ragged non-causal f32 shape (S=200,
   D=64), RL1's learner shape (B=4, H=16, S=351, D=256, bf16, causal,
   its last tile partial), a P1 rank's (B=1, H=8, S=2048, D=256, bf16,
   causal) and an M1 rank's (B=1, H=16, S=2048), each (row, head)
   vector of O, dQ, dK, dV held relative to that vector's max (floored
   at 1% of the tensor's max), LSE and delta absolutely; at the training
   shape ``kernel_ms``, ``plain_ms``,
   ``bound_ms`` (from the products each kernel does on the causal pairs
   of this run, or for delta the bytes of O and dO) and ``library_ms``
   (SDPA with ``is_causal=True`` for the forward; one
   ``torch.linalg.vecdot(o, do, dim=-1)`` for delta, which also carries
   SDPA's backward as ``sdpa_backward_ms``; SDPA's backward, timed as
   forward+backward minus forward, the median of 5 windows of 20 calls
   with their minimum and maximum, for dK/dV and dQ), the achieved share
   of the bound and TFLOP/s (GB/s for delta), and
   ``flash_backward_total`` (delta + dK/dV + dQ against 14 x D flops a
   pair and SDPA's backward); kernels timed over a CUDA
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
P1. Sharding, on a runtime of its own: four rank actors (``num_gpus=
    0.25`` each, all on this card) joined into one gloo group through
    ``init_torch_distributed``, each building ``MeshSpec(fsdp=2, tp=2)``
    (``__graft_entry__._factor_mesh(4)``) and ``make_train_step`` at
    GPT-J-6B width cut to 8 layers under ``FSDP_RULES``, remat
    ``"dots"``, lr 1e-4, global batch 2 x 2048 (one row a data rank),
    one warm-up and 3 timed steps. Losses finite, equal on every rank and
    falling; each rank launched each flash kernel 8 x steps (at 8 heads,
    its tp half); each rank's shard shapes are ``FSDP_RULES``'; leaves
    replicated over tp bit-identical across each tp pair. Step wall,
    tokens/s, MFU, each rank's peak memory, and the wall split into
    compute and collectives (``CollectiveClock`` wraps the collective
    layer's one entry into torch.distributed in each rank).
P2. The sharded step against the one-device step at 2 layers, 1 x 2048 a
    data rank, same weights (the sharded init is a slice of the
    one-device init) and batch: loss and gradients (each rank's shards
    against the slices of the one-device gradients; global and worst-leaf
    relative L2) within P2's bounds, a faulty control (wk/wv's gradients
    not summed over tp) outside them; then 3
    steps with ``grad_transport="int8"`` and ``shard_weight_update``
    within JAX's bound (1e-2) of 3 fp32 sharded steps, the int8 bytes the
    scatter legs sent equal to ``tree_wire_bytes`` of what the step
    reduces.
P3. NCCL at world size 1: a rank actor (``num_gpus=1``) runs
    ``init_torch_distributed(backend="nccl")`` and every eager op of the
    collective layer on a CUDA tensor; each result equals its input (the
    quantized ones the input's two-leg round trip) on ``cuda:0``. The card's
    free memory comes back after the group.
M1. Mixture-of-experts over ep, on a runtime of its own with four rank
    actors as P1's: ``make_train_step`` at GPT-J-6B width with 4 experts
    a layer (Switch top-1, capacity factor 1.25, aux weight 0.01; built
    here with ``dataclasses.replace``) at 2 layers on ``MeshSpec(fsdp=2,
    ep=2)``, global batch 2 x 2048, one warm-up and 3 timed steps. P1's
    checks, each flash kernel launched 2 x steps a rank (at 1 row x 16
    heads), the leaves ep does not split bit-identical across each ep
    pair, each layer's dropped share printed and equal within each ep
    pair.
M2. Ring attention over sp: dense GPT-J-6B width at 4 layers on
    ``MeshSpec(fsdp=2, sp=2)``, 1 row x 1024 positions a rank, one
    warm-up and 3 timed steps. P1's checks, the flash kernels launched 0
    times, and the ring's exchanges (host-staged: gloo takes no CUDA
    send) 3 x 4 a step of 2 x 1 x 1024 x 16 x 256 x 4 B each, with their
    seconds.
M3. Gradients against one device at 2 layers on M1's and M2's meshes,
    the ranks' shards mapped into the driver (CUDA IPC): loss relative
    difference and gradient relative L2 (global, worst leaf) within M3's
    bounds, each mesh's control (the ep one sums the leaves ep does not
    split over ep as well, the sp one leaves out the sum over sp)
    outside them. The card's free memory comes back after M1-M3.

Before them the script's total wall is printed. The second-to-last line
is the ``{"kernels": [...]}`` record (the paged kernel's carries the
verify shape's ``verify_*`` fields, R3's ``actor_launches``, S1's
``serve_launches``, S2's ``disagg_launches``, both replicas', and RL1's
and RL2's ``rlhf_launches``; each flash kernel's carries RL1's and each RL2
learner's ``rlhf_learner_launches``, each P1 rank's
``sharded_launches``, each M1 rank's ``moe_launches`` and each M2 rank's
``ring_launches``); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import math
import os
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


def verify_starts(lens, drafts):
    """First row position of each slot of a speculative verify call: a
    slot with ``lens`` live tokens after the call's writes and ``d``
    drafts (cut to ``lens - 1``) has rows ``lens - 1 - d .. lens - 1``
    kept and the rest of its ``C`` rows padded; an idle slot (``lens`` 0)
    sits at position 0 with every row padded."""
    return [max(n - 1 - min(d, n - 1), 0) for n, d in zip(lens, drafts)]


def verify_shape(rng, lens, spec_tokens: int = 4):
    """GPT-J-6B's speculative verify at the serving knobs: 32 slots x
    ``spec_tokens + 1`` rows, each slot a random draft length of 0 to
    ``spec_tokens``, so that some rows are padded."""
    drafts = rng.integers(0, spec_tokens + 1, len(lens)).tolist()
    return Shape("gptj6b_verify", len(lens), spec_tokens + 1, 16, 16, 256,
                 32, 32, torch.bfloat16, list(lens),
                 verify_starts(lens, drafts))


def kernel_shapes():
    rng = np.random.default_rng(0)
    decode_lens = [0, 1, 1024, 31, 32, 33] + \
        rng.integers(1, 1025, 26).tolist()
    gqa_lens = rng.integers(1, 1025, 32).tolist()
    verify = verify_shape(np.random.default_rng(1), decode_lens)
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
        # the speculative verify: decode's lens, 5 rows a slot
        verify,
    ]


def live_pages(sh: Shape):
    """Pages the kernel reads per sequence: max(ceil(lens / bs), 1)."""
    from ray_tpu_torch.ops import paged_work_pages
    return [int(paged_work_pages(n, sh.bs)) for n in sh.lens]


def bound_ms(sh: Shape):
    """Least time for the work this call's data needs: K and V of each key
    a kept row sees (``min(lens, T * bs)`` per sequence, every kv head)
    read once, q read once, O written once, the table and positions read
    once; flops = 4 * D per (row, key) pair the kept rows (``pos <
    lens``) see (QK^T and P.V), for every query head. The kernel itself
    reads whole live pages (``live_pages``), a few percent more K/V than
    this, and computes the padded rows too."""
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
            if 0 <= p < sh.lens[b]:
                pairs += p + 1
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


def gate_burst(engine, n: int) -> None:
    """Phase 4's burst, made exact for an engine stepping on its own
    thread: at the first step boundary after a request has its first
    token, the step thread waits until ``n`` requests are pending, so
    that one admission takes the whole burst however its requests arrive
    (15 streaming actor calls reach R3's engine one at a time). The gate
    opens once and removes itself."""
    inner = engine._step

    def step():
        if any(r is not None and r.generated for r in engine._slots):
            with engine._work:
                arrived = engine._work.wait_for(
                    lambda: len(engine._pending) >= n, ACTOR_TIMEOUT_S)
            del engine._step               # the class's method again
            if not arrived:
                raise SmokeFailure(f"a burst of {n} requests never arrived")
        inner()
    engine._step = step


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
        gate_burst(engine, len(prompts) - 1)
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
    out["streams"] = streams              # phase R3's reference
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


# ------------------------------------------------------ phases 6a - 6d
SPEC_TOKENS = 4
SPEC_NEW = 48
NEAR_TIE_SHARE = 1e-2           # spec-on token within 1% of the top logit
LOGPROB_ABS_TOL = 2e-2
STAGED_CHECKS = 4               # streams whose first staged token is held
STAGE_SLEEP_CYCLES = 100_000_000   # about 50 ms of the staging stream
HANDOFF_PROMPTS = 4
# int8 round trip: |x - q * scale| <= scale / 2, plus the f32 rounding of
# x / scale and of q * scale (each at most 127 * scale * 2^-24)
INT8_ROUND_TRIP = 1 + 2 ** -14
WATERFALL = ("QUEUED", "ADMITTED", "PREFILL", "FIRST_TOKEN", "DECODE",
             "DONE")


def serving_knobs(**kw):
    """Phase 4's engine knobs, with ``kw`` on top."""
    from ray_tpu_torch.serve import EngineConfig
    return EngineConfig(**dict(dict(
        decode_slots=32, kv_block_size=32, max_seq_len=1024,
        prefill_chunk=256, max_new_tokens=SPEC_NEW), **kw))


def make_spec_requests(seed: int, vocab: int, n: int = 16):
    """``n`` prompts of 64-700 tokens, each a seeded 16-48-token segment
    repeated, with about 5% of its tokens replaced: text that prompt
    lookup serves (code edits, answers quoting a retrieved document)."""
    rng = np.random.default_rng(seed + 7)
    prompts = []
    for _ in range(n):
        seg = rng.integers(1, vocab, int(rng.integers(16, 49)))
        length = int(rng.integers(64, 701))
        p = np.resize(seg, length)
        swap = rng.random(length) < 0.05
        p[swap] = rng.integers(1, vocab, int(swap.sum()))
        prompts.append(p.tolist())
    return prompts


def first_divergence(a, b):
    """Index of the first token where two streams differ, None if one is
    a prefix of the other."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def near_tie(off_row, spec_on: int, spec_off: int, on_pick: int):
    """Whether a stream that emits ``spec_on`` with speculation and
    ``spec_off`` without it flipped at a near tie, not at a fault. All
    three must hold: the spec-off step's logits ``off_row`` (replayed at
    its own shapes) pick ``spec_off``; ``spec_on`` scores within
    ``NEAR_TIE_SHARE`` of the top logit's magnitude below it there; and
    the spec-on path replayed (the request alone through a speculative
    engine, so at the verify shape) picks ``spec_on`` (``on_pick``).
    Returns the verdict with its numbers."""
    row = off_row.float()
    top2 = torch.topk(row, 2).values
    top = top2[0].item()
    pick = int(torch.argmax(off_row))
    gap = top - row[spec_on].item()
    return {"top_logit": top, "top2_gap": (top2[0] - top2[1]).item(),
            "spec_on_gap": gap, "replay_off_pick": pick,
            "replay_on_pick": on_pick,
            "near_tie": pick == spec_off and on_pick == spec_on
            and gap < NEAR_TIE_SHARE * abs(top)}


def handoff_bytes(plen: int, wire: str, cfg, block_size: int = 32) -> int:
    """Wire bytes of one hand-off of a ``plen``-token prompt."""
    from ray_tpu_torch.serve import kv_ship_bytes
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    return kv_ship_bytes(-(-plen // block_size), block_size, cfg.kv_heads,
                         cfg.head_dim, cfg.n_layers, wire, dtype_bytes=elt)


def serve_threads(engine, prompts, max_new: int, ctxs=None, on_token=None,
                  detailed: bool = False, timeout_s: float = 600.0):
    """Every prompt through ``generate_sync`` on its own thread, all
    started together; ``on_token(engine, i, n)`` after request ``i``'s
    ``n``-th item. Returns (streams, TTFT s of each, wall s)."""
    import threading
    streams = [[] for _ in prompts]
    ttft = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            t0 = time.perf_counter()
            for item in engine.generate_sync(
                    prompts[i], max_new, detailed=detailed,
                    trace_ctx=ctxs[i] if ctxs else None,
                    timeout_s=timeout_s):
                if ttft[i] is None:
                    ttft[i] = time.perf_counter() - t0
                streams[i].append(item)
                if on_token is not None:
                    on_token(engine, i, len(streams[i]))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client never ended")
    if errors:
        raise errors[0]
    return streams, ttft, wall


def served(engine, cfg, prompts, max_new, streams, ttft, wall, launches,
           name):
    """The run's numbers and its checks: every stream at its length, a
    clean pool, and 28 paged launches per prefill chunk and decode (or
    verify) step."""
    s = wait_idle(engine)
    audit = engine.pool_audit()
    check(all(len(t) == max_new for t in streams),
          f"{name}: stream lengths {[len(t) for t in streams]}")
    check(audit == [], f"{name}: pool audit after drain: {audit}")
    calls = s["prefill_chunks"] + s["decode_steps"]
    check(launches > 0 and launches == cfg.n_layers * calls,
          f"{name}: paged launches {launches} != {cfg.n_layers} x {calls}")
    tokens = sum(len(t) for t in streams)
    slot_steps = sum(k * v for k, v in s["occupancy_hist"].items())
    tt = np.asarray(ttft, dtype=float)
    out = {"requests": len(prompts),
           "prompt_tokens": sum(len(p) for p in prompts),
           "generated_tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(tt, 50)),
           "ttft_p99_s": float(np.percentile(tt, 99)),
           "prefill_chunks": s["prefill_chunks"],
           "decode_steps": s["decode_steps"],
           "decode_ms_per_step": 1e3 * s["decode_wall_s"]
           / max(s["decode_steps"], 1),
           "decode_tokens_per_step": (tokens - len(prompts))
           / max(s["decode_steps"], 1),
           "decode_tokens_per_slot_step": (tokens - len(prompts))
           / max(slot_steps, 1),
           "paged_launches": launches}
    if "spec" in s:
        out["spec"] = s["spec"]
    return out, s


def run_server(dev, cfg, params, prompts, name, ctxs=None, on_token=None,
               detailed: bool = False, **knobs):
    """Build an engine at phase 4's knobs plus ``knobs``, warm it up,
    then serve ``prompts`` with the paged launch count set to 0 just
    before and read just after. Returns (numbers, stats, streams,
    engine); the caller shuts the engine down."""
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    from ray_tpu_torch.serve import LLMEngine
    engine = LLMEngine(cfg, serving_knobs(**knobs), params=params,
                       device=dev)
    try:
        engine.warmup()
        paged_flash_attention.kernel_launches = 0
        streams, ttft, wall = serve_threads(
            engine, prompts, SPEC_NEW, ctxs=ctxs, on_token=on_token,
            detailed=detailed)
        launches = paged_flash_attention.kernel_launches
        toks = [[t[0] for t in st] for st in streams] if detailed \
            else streams
        out, s = served(engine, cfg, prompts, SPEC_NEW, toks, ttft, wall,
                        launches, name)
    except BaseException:
        engine.shutdown()
        raise
    return out, s, streams, engine


def release(engine):
    engine.shutdown()
    del engine._cache
    torch.cuda.empty_cache()


def direct_logits(dev, cfg, params, tokens, chunk: int = 256, feed=(),
                  slots: int = 32):
    """The logits an engine computed for the token after ``tokens`` and
    ``feed``, replayed at the engine's own shapes on a scratch cache:
    ``tokens`` (a prompt) through ``prefill`` calls of ``chunk`` tokens
    of one sequence from position 0, then each token of ``feed`` (the
    tokens the engine generated so far) through a ``decode_step`` over
    ``slots`` slots, the others idle on the trash block."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill
    T = 32
    cache = init_kv_cache(cfg, 1 + T, 32, device=dev)
    bt = torch.zeros((slots, T), dtype=torch.int32, device=dev)
    bt[0] = torch.arange(1, T + 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for start in range(0, len(tokens), chunk):
            part = tokens[start:start + chunk]
            toks = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
            toks[0, :len(part)] = torch.tensor(part, dtype=torch.int32)
            logits, cache = prefill(
                cfg, params, toks, cache, bt[:1],
                torch.tensor([start], dtype=torch.int32, device=dev),
                torch.tensor([len(part)], dtype=torch.int32, device=dev))
        row = logits[0, len(part) - 1]
        for i, tok in enumerate(feed):
            toks = torch.zeros(slots, dtype=torch.int32, device=dev)
            lens = torch.zeros(slots, dtype=torch.int32, device=dev)
            toks[0], lens[0] = int(tok), len(tokens) + i
            logits, cache = decode_step(cfg, params, toks, cache, bt, lens)
            row = logits[0]
        return row.float()


def phase_verify_profile(dev, cfg, params, seed: int):
    """Device busy per decode step against per verify step: one profiler
    window each over 3 calls at the server's shapes (32 slots at
    64-1000-token contexts; the verify with 0-4 drafts a slot), and
    CUDA-event ms per call."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill
    rng = np.random.default_rng(seed + 8)
    B, bs, T, L = 32, 32, 32, SPEC_TOKENS + 1
    lens = torch.tensor(rng.integers(64, 1000, B), dtype=torch.int32,
                        device=dev)
    drafts = torch.tensor(rng.integers(0, L, B), dtype=torch.int32,
                          device=dev)
    toks = torch.tensor(rng.integers(1, cfg.vocab_size, (B, L)),
                        dtype=torch.int32, device=dev)
    bt = torch.tensor(1 + rng.permutation(B * T).reshape(B, T),
                      dtype=torch.int32, device=dev)
    cache = init_kv_cache(cfg, 1 + B * T, bs, device=dev)
    calls = {
        "decode": lambda: decode_step(cfg, params, toks[:, 0], cache, bt,
                                      lens),
        "verify": lambda: prefill(cfg, params, toks, cache, bt, lens,
                                  1 + drafts),
    }
    out = {"drafts_per_slot": drafts.float().mean().item()}
    with torch.inference_mode():
        for name, fn in calls.items():
            out[f"{name}_ms"] = events_ms(fn, 5)
            wall_ms, by_kind = _profile_window(fn, 3)
            busy = sum(by_kind.values())
            check(busy > 0, f"the profiler saw no device time ({name})")
            out[f"device_busy_ms_per_{name}_step"] = busy / 3
            out[f"{name}_device_ms_by_kind"] = {
                k: v / 3 for k, v in by_kind.items()}
    out["verify_over_decode_device"] = \
        out["device_busy_ms_per_verify_step"] \
        / out["device_busy_ms_per_decode_step"]
    del cache
    torch.cuda.empty_cache()
    print("verify_profile " + json.dumps(out), flush=True)
    return out


def phase_spec_server(dev, card: str, cfg, params, seed: int, prompts):
    """6a: the same prompts through a speculative engine (phase 4's knobs
    plus ``spec_tokens=4``) and a spec-off one with the same weights,
    both with tracing off so that they differ only in speculation. Every
    stream reaches its length, the pools audit clean, drafts were made,
    paged launches = 28 x (prefill chunks + decode steps), and each
    spec-on stream equals its spec-off stream or first leaves it at a
    near tie (``near_tie``): the spec-off step's logits are recomputed
    by ``prefill`` over the prompt, then ``decode_step`` over the stream
    up to there (the spec-off engine's own shapes), and the spec-on path
    by serving the request alone through a new speculative engine.
    Returns the spec-off streams (the reference of phases 6b-6d) and the
    numbers."""
    from ray_tpu_torch.serve import LLMEngine
    on, s_on, spec_streams, eng = run_server(
        dev, cfg, params, prompts, "spec_on", spec_tokens=SPEC_TOKENS,
        enable_trace=False)
    release(eng)
    off, _, ref, eng = run_server(dev, cfg, params, prompts, "spec_off",
                                  enable_trace=False)
    release(eng)
    check(s_on["spec"]["drafted"] > 0, "speculation never drafted")
    diverged = [(i, first_divergence(a, b))
                for i, (a, b) in enumerate(zip(spec_streams, ref))]
    diverged = [(i, pos) for i, pos in diverged if pos is not None]
    divergences = []
    if diverged:
        solo = LLMEngine(cfg, serving_knobs(spec_tokens=SPEC_TOKENS,
                                            enable_trace=False),
                         params=params, device=dev)
        try:
            solo.warmup()
            for i, pos in diverged:
                a, b = spec_streams[i], ref[i]
                again = list(solo.generate_sync(prompts[i], SPEC_NEW))
                v = near_tie(direct_logits(dev, cfg, params, prompts[i],
                                           feed=b[:pos]),
                             a[pos], b[pos], again[pos])
                divergences.append(dict(request=i, position=pos,
                                        spec_on=a[pos], spec_off=b[pos],
                                        **v))
                print(f"spec divergence: request {i} position {pos}: "
                      f"spec-on {a[pos]}, spec-off {b[pos]}; the spec-off "
                      f"replay picks {v['replay_off_pick']} (top logit "
                      f"{v['top_logit']:.4f}, top-two gap "
                      f"{v['top2_gap']:.5f}, spec-on token "
                      f"{v['spec_on_gap']:.5f} below), the spec-on "
                      f"replay picks {again[pos]} "
                      f"({'near tie' if v['near_tie'] else 'NOT a near tie'})",
                      flush=True)
        finally:
            release(solo)
    out = {"card": card, "spec_tokens": SPEC_TOKENS, "spec_on": on,
           "spec_off": off, "streams_equal": len(prompts) - len(divergences),
           "divergences": divergences,
           "acceptance_rate": s_on["spec"]["acceptance_rate"],
           "tokens_per_s_ratio": on["tokens_per_s"] / off["tokens_per_s"]}
    print("spec_server " + json.dumps(out), flush=True)
    check(all(d["near_tie"] for d in divergences),
          f"spec-on streams leave spec-off streams away from a near tie: "
          f"{divergences}")
    return ref, out


def doubled_head(params):
    """``params`` with the LM head (weight and bias) doubled: the logits
    double exactly (a power of two commutes with every rounding), so the
    greedy tokens stay and the log-probabilities change."""
    return dict(params, lm_head={k: v * 2
                                 for k, v in params["lm_head"].items()})


def phase_logprobs(dev, cfg, params, prompts, ref):
    """6b: ``capture_logprobs=True`` with ``detailed`` streams: the greedy
    tokens equal the capture-off run's; every logprob is finite and at
    most 0; mid-run, ``stage_weights(version=1)`` of ``doubled_head``'s
    tree, computed on a side stream behind a device sleep and staged from
    it, so the engine reads it only if its stream waits for the staging
    stream. Every stream's stamps go 0 then 1 and never back,
    ``weight_swaps == 1`` and ``sync_stall_s == 0``. Each first token's
    logprob, and the first token stamped 1 of the ``STAGED_CHECKS``
    streams that reach the staged tree soonest, match a log-softmax of
    direct ``prefill`` (then ``decode_step``) logits of the tree of their
    stamp within ``LOGPROB_ABS_TOL``; for the latter the two trees'
    logprobs differ by over 10x that."""
    import threading
    staged = threading.Event()
    side = torch.cuda.Stream(dev)

    def on_token(engine, i, n):
        # request 0's client stages the refresh after its 8th token: the
        # swap lands mid-run; the staged head is still being written on
        # the side stream when stage_weights returns
        if i == 0 and n == 8 and not staged.is_set():
            staged.set()
            with torch.cuda.stream(side):
                torch.cuda._sleep(STAGE_SLEEP_CYCLES)
                engine.stage_weights(doubled_head(params), 1)

    out, s, streams, eng = run_server(
        dev, cfg, params, prompts, "logprobs", on_token=on_token,
        detailed=True, capture_logprobs=True, enable_trace=False)
    release(eng)
    check(staged.is_set(), "weights were never staged")
    toks = [[t for t, _, _ in st] for st in streams]
    check(toks == ref, "capture_logprobs or the staged tree changed the "
          "greedy tokens")
    lps = [lp for st in streams for _, _, lp in st]
    check(all(lp is not None and math.isfinite(lp) and lp <= 0
              for lp in lps), "a logprob is missing, non-finite or > 0")
    stamped = 0
    for st in streams:
        vs = [v for _, v, _ in st]
        check(vs == sorted(vs) and set(vs) <= {0, 1},
              f"version stamps go back or are unknown: {vs}")
        stamped += sum(vs)
    check(stamped > 0, "no token was stamped with the staged version")
    check(s["weight_swaps"] == 1 and s["weight_version"] == 1,
          f"weight swaps {s['weight_swaps']}, version "
          f"{s['weight_version']}")
    check(s["sync_stall_s"] == 0.0, f"sync stall {s['sync_stall_s']} s")

    def want(p, st, j):
        """Logprobs of token ``j`` of ``st`` under the old tree and under
        the tree of its stamp."""
        logits = direct_logits(dev, cfg, params, p,
                               feed=[t for t, _, _ in st[:j]])
        lp = [torch.log_softmax(x * logits, -1)[st[j][0]].item()
              for x in (1, 2)]
        return lp[0], lp[st[j][1]]

    errs = []
    for p, st in zip(prompts, streams):
        errs.append(abs(st[0][2] - want(p, st, 0)[1]))
    check(max(errs) <= LOGPROB_ABS_TOL,
          f"first-token logprob off by {max(errs)} > {LOGPROB_ABS_TOL}")
    swapped = sorted((next(j for j, t in enumerate(st) if t[1]), i)
                     for i, st in enumerate(streams) if st[-1][1])
    swapped = [(j, i) for j, i in swapped if j > 0][:STAGED_CHECKS]
    check(swapped, "no stream decoded a token on the staged tree")
    staged_errs, apart = [], []
    for j, i in swapped:
        old, new = want(prompts[i], streams[i], j)
        staged_errs.append(abs(streams[i][j][2] - new))
        apart.append(abs(new - old))
    check(max(staged_errs) <= LOGPROB_ABS_TOL and
          min(apart) > 10 * LOGPROB_ABS_TOL,
          f"tokens on the staged tree: logprobs off by {staged_errs} "
          f"(the two trees' differ by {apart})")
    out.update({"logprob_first_max_abs_err": max(errs),
                "logprob_staged_max_abs_err": max(staged_errs),
                "logprob_staged_vs_old_min_gap": min(apart),
                "staged_checked_at": [[i, j] for j, i in swapped],
                "logprob_min": min(lps), "logprob_mean": float(np.mean(lps)),
                "tokens_stamped_1": stamped,
                "tokens_total": sum(len(st) for st in streams),
                "weight_swaps": s["weight_swaps"],
                "weight_swap_wall_s": s["weight_swap_wall_s"],
                "sync_stall_s": s["sync_stall_s"]})
    print("logprobs " + json.dumps(out), flush=True)
    return out


def phase_handoff(dev, card: str, cfg, params, prompts, ref):
    """6c: ``prefill_export`` on one engine and ``submit_adopt`` on
    another that shares the weights (smaller pools), for the longest
    ``HANDOFF_PROMPTS`` prompts, on the bf16 and on the int8 wire. bf16:
    each stream equals the colocated (spec-off) stream and ``wire_bytes
    == kv_ship_bytes``. int8: the first token is exact and each quant
    block's round-trip error is within its ``scale / 2``; the first
    divergence from the colocated stream, if any, is printed. Export and
    adopt ms and bytes per hand-off."""
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    from ray_tpu_torch.serve import LLMEngine, unpack_kv_blocks
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    picks = order[:HANDOFF_PROMPTS]
    pool = 1 + HANDOFF_PROMPTS * 32
    engines = {"bf16": LLMEngine(cfg, serving_knobs(
                   decode_slots=4, num_kv_blocks=pool, kv_wire="bf16",
                   enable_trace=False), params=params, device=dev),
               "int8": LLMEngine(cfg, serving_knobs(
                   decode_slots=4, num_kv_blocks=pool, kv_wire="int8",
                   enable_trace=False), params=params, device=dev),
               "adopt": LLMEngine(cfg, serving_knobs(
                   num_kv_blocks=pool, enable_trace=False), params=params,
                   device=dev)}
    out = {"card": card, "prompts": [len(prompts[i]) for i in picks]}
    try:
        for e in engines.values():
            e.warmup()
        paged_flash_attention.kernel_launches = 0
        payloads = {}
        for wire in ("bf16", "int8"):
            exp, dec = engines[wire], engines["adopt"]
            rows = []
            for i in picks:
                a0 = dec.stats()
                payload = exp.prefill_export(prompts[i])
                want_bytes = handoff_bytes(len(prompts[i]), wire, cfg)
                check(payload["wire_bytes"] == want_bytes,
                      f"{wire}: wire_bytes {payload['wire_bytes']} != "
                      f"kv_ship_bytes {want_bytes}")
                toks = list(dec._items(dec.submit_adopt(payload, SPEC_NEW),
                                       "adopt", 600))   # its stream
                a1 = dec.stats()
                rows.append({"prompt_tokens": len(prompts[i]),
                             "blocks": payload["n_blocks"],
                             "wire_bytes": payload["wire_bytes"],
                             "adopt_ms": 1e3 * (a1["kv_adopt_wall_s"]
                                                - a0["kv_adopt_wall_s"]),
                             "first_divergence": first_divergence(
                                 toks, ref[i]),
                             "equal": toks == ref[i]})
                check(len(toks) == SPEC_NEW, f"{wire}: adopted stream "
                      f"of {len(toks)} tokens")
                check(toks[0] == ref[i][0], f"{wire}: first token "
                      f"{toks[0]} != colocated {ref[i][0]}")
                if wire == "bf16":
                    check(toks == ref[i], f"bf16 hand-off stream differs "
                          f"from the colocated stream at "
                          f"{first_divergence(toks, ref[i])}")
                payloads[(wire, i)] = payload
            s = exp.stats()
            out[wire] = {"handoffs": rows,
                         "export_ms_mean": 1e3 * s["kv_export_wall_s"]
                         / s["kv_exports"],
                         "adopt_ms_mean": float(np.mean(
                             [r["adopt_ms"] for r in rows])),
                         "bytes_mean": float(np.mean(
                             [r["wire_bytes"] for r in rows])),
                         "streams_equal": sum(r["equal"] for r in rows)}
        launches = paged_flash_attention.kernel_launches
        calls = sum(e.stats()["prefill_chunks"] + e.stats()["decode_steps"]
                    for e in engines.values())
        check(launches == cfg.n_layers * calls,
              f"hand-off paged launches {launches} != {cfg.n_layers} x "
              f"{calls}")
        for e in engines.values():
            wait_idle(e)
            check(e.pool_audit() == [], "hand-off pool audit")
        # int8 round trip against the bit-exact bf16 slab of one prompt
        i = picks[0]
        worst = 0.0
        for name in ("k", "v"):
            exact = unpack_kv_blocks(payloads[("bf16", i)]["kv"],
                                     dtype=torch.float32, device=dev)
            got = unpack_kv_blocks(payloads[("int8", i)]["kv"],
                                   dtype=torch.float32, device=dev)
            idx = 0 if name == "k" else 1
            x, y = exact[idx].reshape(-1), got[idx].reshape(-1)
            scales = torch.from_numpy(
                payloads[("int8", i)]["kv"][name + "_scales"]).to(dev)
            err = F.pad((x - y).abs(), (0, scales.numel() * 256 - x.numel()))
            share = (err.view(-1, 256).amax(1) / (scales / 2)).max().item()
            worst = max(worst, share)
        check(worst <= INT8_ROUND_TRIP, f"int8 round-trip error "
              f"{worst} x scale/2 > {INT8_ROUND_TRIP}")
        out["int8_round_trip_max_over_half_scale"] = worst
        out["paged_launches"] = launches
    finally:
        for e in engines.values():
            release(e)
    print("handoff " + json.dumps(out), flush=True)
    return out


def phase_tracing(dev, card: str, cfg, params, prompts, ref, off):
    """6d: an engine with ``enable_trace=True``, every request sampled:
    each waterfall in the tracer's local deque has QUEUED, ADMITTED,
    PREFILL, FIRST_TOKEN, DECODE and DONE; the streams equal the spec-off
    (tracing off) run's; tokens/s with tracing on against off."""
    from ray_tpu_torch.serve import new_request_id
    ctxs = [{"request_id": new_request_id(), "sampled": True}
            for _ in prompts]
    on, _, streams, eng = run_server(dev, cfg, params, prompts, "traced",
                                     ctxs=ctxs, enable_trace=True)
    shipped = list(eng._tracer.shipped_local)
    release(eng)
    check(streams == ref, "tracing changed the streams")
    by_id = {p["request_id"]: p for p in shipped}
    check(set(by_id) == {c["request_id"] for c in ctxs},
          f"{len(by_id)} waterfalls shipped for {len(ctxs)} requests")
    spans = []
    for p in by_id.values():
        phases = [s["phase"] for s in p["spans"]]
        missing = set(WATERFALL) - set(phases)
        check(not missing and p["status"] == "DONE",
              f"waterfall {p['request_id']} lacks {sorted(missing)}")
        spans.append(len(phases))
    out = {"card": card, "tokens_per_s_on": on["tokens_per_s"],
           "tokens_per_s_off": off["tokens_per_s"],
           "on_over_off": on["tokens_per_s"] / off["tokens_per_s"],
           "decode_ms_per_step_on": on["decode_ms_per_step"],
           "decode_ms_per_step_off": off["decode_ms_per_step"],
           "waterfalls": len(by_id), "spans_per_waterfall_mean":
           float(np.mean(spans))}
    print("tracing " + json.dumps(out), flush=True)
    return out


def serving_features(dev, card: str, cfg, params, seed: int):
    """Phases 6a-6d on the serving weights."""
    prompts = make_spec_requests(seed, cfg.vocab_size)
    verify = phase_verify_profile(dev, cfg, params, seed)
    ref, spec = phase_spec_server(dev, card, cfg, params, seed, prompts)
    logprobs = phase_logprobs(dev, cfg, params, prompts, ref)
    handoff = phase_handoff(dev, card, cfg, params, prompts, ref)
    tracing = phase_tracing(dev, card, cfg, params, prompts, ref,
                            spec["spec_off"])
    return {"verify_profile": verify, "spec": spec, "logprobs": logprobs,
            "handoff": handoff, "tracing": tracing}


# ------------------------------------------------------ phases R1 - R3
SLAB_BLOCKS = 22      # phase 6c's longest hand-off: 22 blocks of 32 tokens
ACTOR_TIMEOUT_S = 600.0


def weights_checksum(params):
    """One integer per leaf: the sum of its bit patterns (as 16- or
    32-bit integers), summed on the card in int64 a slice of the leading
    axis at a time (a whole stacked leaf in int64 would take 15 GB at
    GPT-J-6B). Equal lists mean the same seed drew the same tree."""
    out = []
    for name, t in sorted(_named(params)):
        ints = torch.int16 if t.element_size() == 2 else torch.int32
        flat = t.detach().contiguous().view(ints)
        rows = flat.reshape(flat.shape[0], -1) if flat.dim() > 1 \
            else flat.reshape(1, -1)
        out.append([name, sum(int(r.sum(dtype=torch.int64))
                              for r in rows)])
    return out


def handoff_slab(dev, cfg, seed: int):
    """k and v of a 22-block GPT-J-6B hand-off on the card (bf16, layers
    x blocks x 32 tokens x KV heads x head_dim each), drawn from seed."""
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    shape = (cfg.n_layers, SLAB_BLOCKS, 32, cfg.kv_heads, cfg.head_dim)
    return {name: torch.randn(shape, generator=g, device=dev).to(cfg.dtype)
            for name in ("k", "v")}


def tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def same_bits(a, b) -> bool:
    """Every tensor of ``a`` and ``b`` (any devices) of one dtype and
    shape with equal bytes."""
    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.detach().cpu().contiguous().reshape(-1).view(torch.uint8),
            y.detach().cpu().contiguous().reshape(-1).view(torch.uint8))
        for x, y in zip(ta, tb))


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def rate(n: int, seconds: float):
    return {"ms": 1e3 * seconds, "gb_per_s": n / seconds / 1e9}


def phase_store(dev, card: str, cfg, seed: int):
    """R1: the 22-block hand-off slab (bf16, on the card), a small f32
    tensor and a nested tuple of mixed tensors through the port's
    serializer into a shared-memory store and back; bits equal after
    ``.cuda()``; ms and GB/s of the device-to-host copy, the store write
    (serialize, which makes that copy, then create + write + seal), the
    read (view, deserialize, which copies out of the store) and the
    host-to-device copy. Fails unless the native store served."""
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.native_store import (NativeShmClient,
                                                 NativeShmStore)
    from ray_tpu_torch.core.serialization import SerializationContext
    from ray_tpu_torch.core.shm_store import make_client, make_store
    slab = handoff_slab(dev, cfg, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    small = torch.randn(64, 64, generator=g, device=dev)
    mixed = (slab["k"][0, :2], (torch.arange(5, device=dev),
                                small.to(torch.float16).cpu()),
             {"mask": small > 0, "i8": small.to(torch.int8)})
    n = nbytes(slab)
    name = f"raytorch-smoke-{os.getpid()}"
    store = make_store(name, 2 * n + (256 << 20))
    client = make_client(name)
    ctx = SerializationContext()
    out = {"card": card, "slab_bytes": n, "slab_shape": list(
        slab["k"].shape), "dtype": str(cfg.dtype)}
    try:
        out["store"] = "native" if isinstance(store, NativeShmStore) \
            and isinstance(client, NativeShmClient) else "python mmap"
        print(f"store: {out['store']} ({type(store).__name__}, "
              f"{type(client).__name__})", flush=True)
        check(out["store"] == "native",
              "the native shm store did not serve (g++ build failed?)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = {k: v.cpu() for k, v in slab.items()}
        out["d2h"] = rate(n, time.perf_counter() - t0)
        for what, value in (("slab", slab), ("small", small),
                            ("mixed", mixed)):
            oid = ObjectID.from_random()
            t0 = time.perf_counter()
            ser = ctx.serialize(value)
            t_ser = time.perf_counter() - t0
            size = ser.total_bytes()
            extent = client.create(oid, size)
            t_create = time.perf_counter() - t0 - t_ser
            ser.write_to(extent)
            del extent
            client.seal(oid)
            store.on_sealed(oid, size)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            view = client.get_view(oid, timeout=5.0)
            check(view is not None, f"{what}: not in the store")
            back, _ = ctx.deserialize_from_view(view)
            del view
            client.release(oid)
            t_read = time.perf_counter() - t0
            check(all(t.device.type == "cpu" for t in tensors_of(back)),
                  f"{what}: a get gave a tensor off the host")
            t0 = time.perf_counter()
            on_card = [t.to(dev) for t in tensors_of(back)]
            torch.cuda.synchronize()
            t_h2d = time.perf_counter() - t0
            check(same_bits(on_card, value), f"{what}: bits differ")
            if what == "slab":
                check(same_bits(back, host), "slab: bits differ on host")
                out["store_write"] = rate(n, t_write)
                out["serialize"] = rate(n, t_ser)     # the d2h copy inside
                out["shm_write"] = rate(n, t_write - t_ser)
                out["shm_create"] = rate(n, t_create)   # pages populated
                out["store_read"] = rate(n, t_read)
                out["h2d"] = rate(n, t_h2d)
                out["wire_bytes"] = size
            store.delete(oid)
    finally:
        client.close()
        store.destroy()
    print("store_phase " + json.dumps(out), flush=True)
    return out


def device_name(dev) -> str:
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def _slab_on_card(slab, device: str):
    """R2's task: move the slab to this worker's card and return its
    per-leaf checksums, the slab (from the card), the card's name and
    this worker's pid."""
    dev = torch.device(device)
    moved = {k: v.to(dev) for k, v in slab.items()}
    sums = {k: int(v.view(torch.int16).sum(dtype=torch.int64))
            for k, v in moved.items()}
    return {"sums": sums, "slab": moved, "device": device_name(dev),
            "pid": os.getpid()}


class _Holder:
    """Holds a worker: three of them start the zygote."""

    def pid(self):
        return os.getpid()


def listening(name: str) -> bool:
    """Whether a session's unix socket (a file, or an abstract name where
    the session dir's path is too long) takes connections."""
    import socket
    from ray_tpu_torch.core import protocol as P
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        conn.connect(P.unix_address(name))
        return True
    except OSError:
        return False
    finally:
        conn.close()


def start_zygote(timeout_s: float = 60.0):
    """The node forks workers from its zygote once demand passes its
    initial pool by two spawns. With no initial or prestarted worker,
    three holder actors are spawns 1-3 (cold: the third starts the
    zygote); wait until it listens, so every later spawn is a fork, and
    until every cold worker is held.
    Returns the holders (alive until the caller kills them, so that no
    cold worker turns idle) and the seconds this took."""
    import ray_tpu_torch
    from ray_tpu_torch import api
    from ray_tpu_torch.core.node import _ForkedWorker
    holder = ray_tpu_torch.remote(num_cpus=0)(_Holder)
    holders = []
    t0 = time.perf_counter()
    for _ in range(3):
        # one at a time: a queue of creations would make the controller
        # spawn ahead, and a spare cold worker would stay idle
        holders.append(holder.remote())
        ray_tpu_torch.get(holders[-1].pid.remote(), timeout=timeout_s)
    node = api._head.node
    while not listening(node._zygote_sock):
        check(time.perf_counter() - t0 < timeout_s,
              "the zygote never listened")
        time.sleep(0.05)
    # the controller may have spawned a spare cold worker ahead of the
    # creations: more holders take the cold workers until each is held
    pids = {ray_tpu_torch.get(h.pid.remote(), timeout=timeout_s)
            for h in holders}

    def unheld_cold():
        return {w.pid for w in list(node.workers.values())
                if not isinstance(w, _ForkedWorker)} - pids

    for _ in range(8):
        if not unheld_cold():
            break
        holders.append(holder.remote())
        pids.add(ray_tpu_torch.get(holders[-1].pid.remote(),
                                   timeout=timeout_s))
    check(not unheld_cold(), f"cold workers {unheld_cold()} stay idle")
    return holders, time.perf_counter() - t0


def forked(pid: int) -> bool:
    """Whether this node's worker ``pid`` was forked from its zygote."""
    from ray_tpu_torch import api
    from ray_tpu_torch.core.node import _ForkedWorker
    return any(isinstance(w, _ForkedWorker) and w.pid == pid
               for w in list(api._head.node.workers.values()))


def phase_runtime(dev, card: str, cfg, seed: int):
    """R2: the runtime on the card. ``init`` counts the card as ``GPU``;
    the zygote is started (no worker boots cold after it); the slab
    through ``put``/``get``, and as the argument and the return of a
    ``num_gpus=1`` task that moves it to its card in a zygote-forked
    worker; bits and per-leaf checksums equal, the worker's card is this
    card. Init wall, the first GPU call (a fork that makes its CUDA
    context), the slab's put/get and task round trip (on the worker
    that made the first call), a warm task round trip, and GPU calls
    made after default-shape tasks (:func:`gpu_calls_after_default_tasks`:
    one worker, none new)."""
    import ray_tpu_torch
    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_cpus=4, _num_initial_workers=0,
                              _system_config={"prestart_workers": 0})
    out = {"card": card, "init_s": time.perf_counter() - t0,
           "session_dir": info["session_dir"]}
    res = ray_tpu_torch.cluster_resources()
    out["resources"] = res
    check(res.get("GPU") == torch.cuda.device_count(),
          f"GPU resource {res.get('GPU')} != {torch.cuda.device_count()}")
    holders, out["zygote_s"] = start_zygote()

    slab = handoff_slab(dev, cfg, seed)
    host = {k: v.cpu() for k, v in slab.items()}
    n = nbytes(slab)
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(slab)
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ray_tpu_torch.get(ref, timeout=60)
    t_get = time.perf_counter() - t0
    check(same_bits({k: v.to(dev) for k, v in got.items()}, slab),
          "put/get: bits differ")
    out["put"], out["get"] = rate(n, t_put), rate(n, t_get)
    del ref, got

    # the slab's GPU calls come first; GPU calls made after
    # default-shape tasks are checked at the end
    on_card = ray_tpu_torch.remote(num_gpus=1)(_slab_on_card)
    t0 = time.perf_counter()
    first = ray_tpu_torch.get(
        on_card.remote({"k": slab["k"][0, 0]}, dev.type),
        timeout=ACTOR_TIMEOUT_S)
    out["gpu_task_first_call_s"] = time.perf_counter() - t0
    check(first["device"] == device_name(dev),
          f"the worker's card {first['device']!r}")
    want = {k: int(v.view(torch.int16).sum(dtype=torch.int64))
            for k, v in slab.items()}
    t0 = time.perf_counter()
    back = ray_tpu_torch.get(on_card.remote(slab, dev.type),
                             timeout=ACTOR_TIMEOUT_S)
    out["task_round_trip"] = rate(2 * n, time.perf_counter() - t0)
    check(back["sums"] == want, f"task checksums {back['sums']} != {want}")
    check(all(t.device.type == "cpu" for t in tensors_of(back["slab"])),
          "a task return came back off the host")
    check(same_bits(back["slab"], host), "task return: bits differ")
    out["worker_device"] = back["device"]
    out["worker_pids"] = [first["pid"], back["pid"]]
    out["worker_forked"] = all(forked(pid) for pid in out["worker_pids"])
    check(out["worker_forked"], "a GPU task's worker was not forked from "
          "the zygote")
    del back, slab
    torch.cuda.empty_cache()

    @ray_tpu_torch.remote
    def noop():
        return os.getpid()

    check(forked(ray_tpu_torch.get(noop.remote(), timeout=ACTOR_TIMEOUT_S)),
          "a task worker booted cold after the zygote listened")
    t0 = time.perf_counter()
    for _ in range(20):
        ray_tpu_torch.get(noop.remote(), timeout=60)
    out["task_round_trip_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    after = out["gpu_after_default_tasks"] = gpu_calls_after_default_tasks(
        on_card, dev, out["worker_pids"])
    check(after["workers"] == 1 and after["new_workers"] == 0,
          f"GPU calls after default-shape tasks ran on {after['workers']} "
          f"workers, {after['new_workers']} of them new")
    for h in holders:
        ray_tpu_torch.kill(h)
    print("runtime " + json.dumps(out), flush=True)
    return out


def gpu_calls_after_default_tasks(on_card, dev, gpu_pids, calls: int = 3):
    """A repaired fault of the runtime, measured: default-shape tasks
    lease idle workers to the driver, and a ``num_gpus=1`` call made
    after them once forked a new worker with a CUDA context of its own.
    The controller now keeps a worker that ran a GPU task out of those
    leases and prefers it for the next one. Three small GPU calls after
    R2's default-shape tasks: the wall of each, how many workers served
    them, how many of those are not the workers of R2's earlier GPU
    calls, and the node's worker count before and after (the caller
    checks one worker, none new)."""
    import ray_tpu_torch
    from ray_tpu_torch import api
    node = api._head.node
    before = len(node.workers)
    probe = {"k": torch.ones(1024, dtype=torch.bfloat16)}
    walls, pids = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        got = ray_tpu_torch.get(on_card.remote(probe, dev.type),
                                timeout=ACTOR_TIMEOUT_S)
        walls.append(time.perf_counter() - t0)
        pids.append(got["pid"])
        check(got["device"] == device_name(dev),
              f"the worker's card {got['device']!r}")
        check(got["sums"] == {"k": 1024 * 0x3F80},
              f"probe checksum {got['sums']}")
    return {"call_s": walls, "workers": len(set(pids)),
            "new_workers": len(set(pids) - set(gpu_pids)),
            "node_workers_before": before,
            "node_workers_after": len(node.workers)}


def engine_ready(engine):
    """What a process serving ``engine`` reports once built: its weights'
    checksum, its card, pid, weight and KV pool sizes, memory held."""
    ec, cfg, dev = engine.config, engine.model_config, engine.device
    return {"checksum": weights_checksum(engine._params),
            "device": device_name(dev), "pid": os.getpid(),
            "weights_gb": nbytes(engine._params) / 1e9,
            "kv_pool_gb": ec.resolved_num_blocks * ec.kv_block_size
            * ec.kv_bytes_per_token(cfg) / 1e9,
            "pool_blocks": ec.resolved_num_blocks,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9
            if dev.type == "cuda" else 0.0}


def reset_launches():
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    paged_flash_attention.kernel_launches = 0


def engine_drained(engine):
    """This process's paged launches, and ``engine``'s stats and pool
    audit once it is idle, with the process's peak card memory."""
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    s = wait_idle(engine)
    return {"stats": s, "launches": paged_flash_attention.kernel_launches,
            "audit": engine.pool_audit(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
            if engine.device.type == "cuda" else 0.0}


def engine_replay(engine, prompt, ref_stream, pos: int, served_tok: int):
    """The near-tie rule at a divergence, replayed in the process that
    served it: phase 4's step at the engine's shapes, and the request
    served alone through ``engine``."""
    again = list(engine.generate_sync(prompt, SPEC_NEW,
                                      timeout_s=ACTOR_TIMEOUT_S))
    row = direct_logits(engine.device, engine.model_config, engine._params,
                        prompt, feed=ref_stream[:pos])
    return near_tie(row, served_tok, ref_stream[pos], again[pos])


class GPTJServer:
    """R3's actor: GPT-J-6B at full depth behind ``LLMEngine`` with phase
    4's knobs, built in its own worker on its own CUDA context."""

    def __init__(self, seed: int, cfg, device: str = "cuda"):
        from ray_tpu_torch.models import init_params
        from ray_tpu_torch.serve import LLMEngine
        dev = torch.device(device)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=seed, device=dev, dtype=cfg.dtype)
        self.engine = LLMEngine(cfg, serving_knobs(), params=params,
                                device=dev)
        self.build_s = time.perf_counter() - t0

    def ready(self):
        return dict(engine_ready(self.engine), build_s=self.build_s)

    def reset_launches(self):
        reset_launches()

    def hold_burst(self, n: int):
        gate_burst(self.engine, n)

    def generate(self, prompt, max_new: int):
        yield from self.engine.generate_sync(prompt, max_new,
                                             timeout_s=ACTOR_TIMEOUT_S)

    def drained(self):
        return engine_drained(self.engine)

    def replay(self, prompt, ref_stream, pos: int, actor_tok: int):
        return engine_replay(self.engine, prompt, ref_stream, pos,
                             actor_tok)


def serve_pattern(open_stream, n: int):
    """Phase 4's pattern: stream 0 alone until its first token reaches
    the driver, then streams 1..n-1 together, each read on its own
    thread. ``open_stream(i)``, called in turn on this thread, gives
    stream i's tokens (a generator defers its own opening to the
    reading thread). Returns (streams, TTFT s of each from its opening,
    wall s)."""
    import threading
    streams = [[] for _ in range(n)]
    ttft = [None] * n
    errors = []
    first = threading.Event()

    def client(i, t0, tokens):
        try:
            for tok in tokens:
                if ttft[i] is None:
                    ttft[i] = time.perf_counter() - t0
                streams[i].append(tok)
                first.set()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            first.set()

    def start(i):
        t0 = time.perf_counter()
        th = threading.Thread(target=client, args=(i, t0, open_stream(i)))
        th.start()
        return th

    t_start = time.perf_counter()
    threads = [start(0)]
    check(first.wait(ACTOR_TIMEOUT_S), "request 0 never produced a token")
    threads += [start(i) for i in range(1, n)]
    for th in threads:
        th.join(ACTOR_TIMEOUT_S)
    wall = time.perf_counter() - t_start
    check(not any(th.is_alive() for th in threads), "a stream never ended")
    if errors:
        raise errors[0]
    return streams, ttft, wall


def serve_actor(actor, prompts, max_new: int):
    """Phase 4's pattern through streaming actor calls."""
    import ray_tpu_torch
    call = actor.generate.options(num_returns="streaming")

    def tokens(gen):
        while True:
            try:
                ref = gen.next_ref(timeout=ACTOR_TIMEOUT_S)
            except StopIteration:
                return
            yield ray_tpu_torch.get(ref, timeout=ACTOR_TIMEOUT_S)

    # each call is made on this thread, as it is opened
    return serve_pattern(
        lambda i: tokens(call.remote(prompts[i], max_new)), len(prompts))


def confirm_divergences(streams, ref, replay, who: str):
    """Each stream's first divergence from phase 4's ``ref`` (same
    indices), replayed by ``replay(i, pos)`` under the near-tie rule;
    every one printed, and each must be a confirmed near tie."""
    divergences = []
    for i, (a, b) in enumerate(zip(streams, ref)):
        pos = first_divergence(a, b)
        if pos is None:
            continue
        v = replay(i, pos)
        divergences.append(dict(request=i, position=pos, served=a[pos],
                                phase4=b[pos], **v))
        print(f"{who} divergence: request {i} position {pos}: "
              f"{divergences[-1]}", flush=True)
    return divergences


def phase_actor_server(dev, card: str, cfg, seed: int, server, checksum):
    """R3: GPT-J-6B served from a ``num_gpus=1`` actor: its weights'
    checksum equals the driver's, phase 4's 16 requests in phase 4's
    pattern; streams at their length, a clean pool, 28 paged launches per
    prefill chunk and decode step in the actor, each stream equal to
    phase 4's or leaving it at a confirmed near tie; tokens/s and TTFT
    beside phase 4's. The actor is killed and the runtime shut down by
    the caller."""
    import ray_tpu_torch
    check(torch.cuda.memory_allocated() < 1e9,
          "the driver still holds serving memory")
    Server = ray_tpu_torch.remote(num_gpus=1, max_concurrency=64)(GPTJServer)
    t0 = time.perf_counter()
    actor = Server.remote(seed, cfg, dev.type)
    info = ray_tpu_torch.get(actor.ready.remote(), timeout=ACTOR_TIMEOUT_S)
    out = {"card": card, "actor_ready_s": time.perf_counter() - t0,
           **{k: v for k, v in info.items() if k != "checksum"}}
    check(info["checksum"] == checksum,
          "the actor's weights differ from the driver's")
    check(info["device"] == device_name(dev),
          f"the actor's card {info['device']!r}")
    out["actor_forked"] = forked(info["pid"])
    check(out["actor_forked"], "the actor's worker was not forked from the "
          "zygote")
    prompts = make_requests(seed, cfg.vocab_size)
    ray_tpu_torch.get(actor.reset_launches.remote(), timeout=60)
    ray_tpu_torch.get(actor.hold_burst.remote(len(prompts) - 1), timeout=60)
    streams, ttft, wall = serve_actor(actor, prompts, 48)
    d = ray_tpu_torch.get(actor.drained.remote(), timeout=ACTOR_TIMEOUT_S)
    s = d["stats"]
    check(all(len(t) == 48 for t in streams),
          f"stream lengths {[len(t) for t in streams]} != 48")
    check(d["audit"] == [], f"pool audit after drain: {d['audit']}")
    calls = s["prefill_chunks"] + s["decode_steps"]
    check(d["launches"] > 0 and d["launches"] == cfg.n_layers * calls,
          f"actor paged launches {d['launches']} != {cfg.n_layers} x "
          f"{calls}")
    ref = server["streams"]
    divergences = confirm_divergences(
        streams, ref, lambda i, pos: ray_tpu_torch.get(actor.replay.remote(
            prompts[i], ref[i], pos, streams[i][pos]),
            timeout=ACTOR_TIMEOUT_S), "actor")
    tokens = sum(len(t) for t in streams)
    tt = np.asarray(ttft, dtype=float)
    out.update({
        "requests": len(prompts), "generated_tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_p50_s": float(np.percentile(tt, 50)),
        "ttft_p99_s": float(np.percentile(tt, 99)),
        "phase4_tokens_per_s": server["tokens_per_s"],
        "phase4_ttft_p50_s": server["ttft_p50_s"],
        "phase4_ttft_p99_s": server["ttft_p99_s"],
        "prefill_chunks": s["prefill_chunks"],
        "decode_steps": s["decode_steps"],
        "phase4_prefill_chunks": server["prefill_chunks"],
        "phase4_decode_steps": server["decode_steps"],
        "paged_launches": d["launches"], "actor_peak_mem_gb":
        d["peak_mem_gb"], "streams_equal":
        len(prompts) - len(divergences), "divergences": divergences})
    print("actor_server " + json.dumps(out), flush=True)
    check(all(v["near_tie"] for v in divergences),
          f"actor streams leave phase 4's away from a near tie: "
          f"{divergences}")
    return actor, out


def runtime_phases(dev, card: str, seed: int, server, checksum):
    """Phases R1-R3 between the serving and the training phases; the
    runtime is shut down and the actor's memory back on the card when
    this returns. Returns R3's record."""
    import ray_tpu_torch
    from ray_tpu_torch.models import get_config
    cfg = get_config("gptj-6b")
    t0 = time.perf_counter()
    phase_store(dev, card, cfg, seed)
    print(f"phase R1 wall: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    actor = None
    try:
        t0 = time.perf_counter()
        phase_runtime(dev, card, cfg, seed)
        print(f"phase R2 wall: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        actor, r3 = phase_actor_server(dev, card, cfg, seed, server,
                                       checksum)
    finally:
        if actor is not None:
            ray_tpu_torch.kill(actor)
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(f"phase R3 wall: {time.perf_counter() - t0:.1f} s; card memory "
          f"free {free0 / 1e9:.2f} GB before R2, {free1 / 1e9:.2f} GB after "
          f"the actor's kill and shutdown", flush=True)
    check(free1 >= free0 - (1 << 30),
          "the actor's card memory did not come back")
    return r3


# ---------------------------------------------------------- phases S1-S2
DISAGG_PROMPTS = 4


def model_dict(cfg):
    """A model config as the plain dict a deployment ships, its dtype by
    name (phase 4's: ``"bfloat16"``)."""
    return dict(dataclasses.asdict(cfg),
                dtype=str(cfg.dtype).split(".")[-1])


def engine_dict(**kw):
    """Phase 4's engine knobs (``kw`` on top) as a plain dict."""
    return dataclasses.asdict(serving_knobs(**kw))


def replicas_of(deployment: str):
    """The replica actors of a serve deployment."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import api as serve_api
    return ray_tpu_torch.get(serve_api._controller_or_none().get_replicas
                             .remote(deployment), timeout=60)


def probe(replica, fn, *args):
    """``fn(engine, *args)`` in a serve replica's process, on the engine
    of the ``LLMServer`` it serves (the runtime's generic actor call)."""
    import ray_tpu_torch
    return ray_tpu_torch.get(replica.__ray_call__.remote(
        lambda rep, *a: fn(rep._instance.engine, *a), *args),
        timeout=ACTOR_TIMEOUT_S)


def http_tokens(url: str, body):
    """POST ``body`` as JSON to the proxy; yields the streamed tokens
    (one JSON value a line) as they arrive."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=ACTOR_TIMEOUT_S) as r:
        check(r.status == 200, f"{url}: HTTP {r.status}")
        for line in r:
            if line.strip():
                yield json.loads(line)


def ready_replicas(deployments, dev, checksum, t0):
    """Each deployment's one replica, once its ``LLMServer`` is built and
    warm: its weights are phase 4's and it serves from this card; its
    paged launch count is then set to 0. Returns (replicas, their ready
    records)."""
    reps, infos = [], []
    for name in deployments:
        (rep,) = replicas_of(name)
        info = probe(rep, engine_ready)
        info["ready_s"] = time.perf_counter() - t0
        check(info.pop("checksum") == checksum,
              f"{name}'s weights differ from phase 4's")
        check(info["device"] == device_name(dev),
              f"{name} serves on {info['device']!r}")
        probe(rep, lambda engine: reset_launches())
        reps.append(rep)
        infos.append(info)
    return reps, infos


def check_drained(name: str, d, n_layers: int):
    """A replica's clean pool and its paged launches: n_layers a prefill
    chunk and a decode step, and more than 0."""
    s = d["stats"]
    check(d["audit"] == [], f"{name} pool audit after drain: {d['audit']}")
    calls = s["prefill_chunks"] + s["decode_steps"]
    check(d["launches"] > 0 and d["launches"] == n_layers * calls,
          f"{name} paged launches {d['launches']} != {n_layers} x {calls}")


def ttft_stats(ttft):
    tt = np.asarray(ttft, dtype=float)
    return {"ttft_p50_s": float(np.percentile(tt, 50)),
            "ttft_p99_s": float(np.percentile(tt, 99))}


def phase_serve_http(dev, card: str, cfg, seed: int, proxy: str, server,
                     actor_server, checksum):
    """S1: GPT-J-6B behind ``serve.run``: one ``LLMServer`` replica with
    ``num_gpus=1``, phase 4's model, knobs and seed; phase 4's 16
    requests over HTTP to the proxy in phase 4's pattern, read as JSON
    lines, then one streaming handle call for request 0. Streams reach
    48 tokens and equal phase 4's or leave them at a confirmed near tie
    (replayed in the replica); a clean pool; 28 paged launches a prefill
    chunk and decode step in the replica. Tokens/s and TTFT beside phase
    4's and R3's, the replica's ready time and peak memory."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import LLMServer
    prompts = make_requests(seed, cfg.vocab_size)
    t0 = time.perf_counter()
    handle = serve.run(serve.deployment(
        LLMServer, name="gptj", ray_actor_options={"num_gpus": 1}).bind(
            model=model_dict(cfg), engine=engine_dict(max_new_tokens=48),
            seed=seed), name="gptj", route_prefix="/gptj")
    (replica,), (info,) = ready_replicas(["gptj"], dev, checksum, t0)
    url = proxy + "/gptj"
    streams, ttft, wall = serve_pattern(
        lambda i: http_tokens(url, prompts[i]), len(prompts))
    again = list(handle.options(stream=True).generate.remote(prompts[0]))
    d = probe(replica, engine_drained)
    s = d["stats"]
    check(all(len(t) == 48 for t in streams + [again]),
          f"stream lengths {[len(t) for t in streams + [again]]} != 48")
    check_drained("S1 replica", d, cfg.n_layers)
    ref = server["streams"]
    served = streams + [again]
    divergences = confirm_divergences(
        served, ref + [ref[0]],
        lambda i, pos: probe(replica, engine_replay,
                             prompts[i % len(prompts)],
                             ref[i % len(prompts)], pos, served[i][pos]),
        "serve")
    tokens = sum(len(t) for t in streams)
    out = {"card": card, **info, "requests": len(prompts),
           "generated_tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, **ttft_stats(ttft),
           "phase4_tokens_per_s": server["tokens_per_s"],
           "phase4_ttft_p50_s": server["ttft_p50_s"],
           "phase4_ttft_p99_s": server["ttft_p99_s"],
           "r3_tokens_per_s": actor_server["tokens_per_s"],
           "r3_ttft_p50_s": actor_server["ttft_p50_s"],
           "r3_ttft_p99_s": actor_server["ttft_p99_s"],
           "prefill_chunks": s["prefill_chunks"],
           "decode_steps": s["decode_steps"],
           "paged_launches": d["launches"],
           "replica_peak_mem_gb": d["peak_mem_gb"],
           "streams_equal": len(served) - len(divergences),
           "handle_stream_equal_http": again == streams[0],
           "divergences": divergences}
    print("serve_http " + json.dumps(out), flush=True)
    check(all(v["near_tie"] for v in divergences),
          f"served streams leave phase 4's away from a near tie: "
          f"{divergences}")
    return out


def phase_disagg(dev, card: str, cfg, seed: int, proxy: str, server,
                 actor_server, checksum):
    """S2: a 1 prefill + 1 decode pair from ``deploy_disaggregated`` at
    phase 4's knobs on the bf16 wire, its replicas reserving no ``GPU``
    (as the JAX package's): phase 4's 4 longest prompts over HTTP to
    ``/pd`` in phase 4's pattern. Streams equal phase 4's or leave them
    at a confirmed near tie (replayed in the decode replica), both pools
    clean, each replica's paged launches 28 a prefill chunk and decode
    step of its own, and the bytes shipped equal ``kv_ship_bytes`` of the
    prompts. TTFT and the hand-off's export, ship and adopt ms and
    bytes. ``deploy_disaggregated`` passes no seed, so its replicas draw
    the weights of seed 0: phase 4's at the script's default seed."""
    from ray_tpu_torch import serve
    prompts = make_requests(seed, cfg.vocab_size)
    longest = sorted(range(len(prompts)),
                     key=lambda i: -len(prompts[i]))[:DISAGG_PROMPTS]
    t0 = time.perf_counter()
    router = serve.deploy_disaggregated(
        model_dict(cfg), engine_dict(max_new_tokens=48), name="pd",
        num_prefill=1, num_decode=1, route_prefix="/pd")
    (pre, dec), (ipre, idec) = ready_replicas(
        ["pd-prefill", "pd-decode"], dev, checksum, t0)
    url = proxy + "/pd"
    streams, ttft, wall = serve_pattern(
        lambda j: http_tokens(url, {"prompt": prompts[longest[j]],
                                    "max_new_tokens": 48}), len(longest))
    dp, dd = probe(pre, engine_drained), probe(dec, engine_drained)
    check(all(len(t) == 48 for t in streams),
          f"stream lengths {[len(t) for t in streams]} != 48")
    check_drained("S2 prefill replica", dp, cfg.n_layers)
    check_drained("S2 decode replica", dd, cfg.n_layers)
    sp, sd = dp["stats"], dd["stats"]
    shipped = sum(handoff_bytes(len(prompts[i]), "bf16", cfg)
                  for i in longest)
    check(sp["kv_exports"] == sd["kv_adopts"] == len(longest),
          f"{sp['kv_exports']} exports, {sd['kv_adopts']} adopts")
    check(sp["kv_export_bytes"] == sd["kv_adopt_bytes"] == shipped,
          f"shipped {sp['kv_export_bytes']} B, adopted "
          f"{sd['kv_adopt_bytes']} B, kv_ship_bytes {shipped} B")
    ref = [server["streams"][i] for i in longest]
    divergences = confirm_divergences(
        streams, ref,
        lambda j, pos: probe(dec, engine_replay, prompts[longest[j]],
                             ref[j], pos, streams[j][pos]), "disagg")
    n = max(len(longest), 1)
    out = {"card": card, "prefill": ipre, "decode": idec,
           "requests": len(longest), "prompt_tokens":
           [len(prompts[i]) for i in longest], "wall_s": wall,
           "tokens_per_s": sum(len(t) for t in streams) / wall,
           **ttft_stats(ttft),
           "phase4_ttft_p50_s": server["ttft_p50_s"],
           "kv_ship_bytes": shipped,
           "export_ms_per_handoff": 1e3 * sp["kv_export_wall_s"] / n,
           "ship_ms_per_handoff": 1e3 * sd["kv_ship_wall_s"] / n,
           "adopt_ms_per_handoff": 1e3 * sd["kv_adopt_wall_s"] / n,
           "ship_gb_s": shipped / max(sd["kv_ship_wall_s"], 1e-9) / 1e9,
           "prefill_chunks": sp["prefill_chunks"],
           "decode_steps": sd["decode_steps"],
           "prefill_launches": dp["launches"],
           "decode_launches": dd["launches"],
           "router_stats": router.stats,
           "peak_mem_gb": [dp["peak_mem_gb"], dd["peak_mem_gb"]],
           "streams_equal": len(streams) - len(divergences),
           "divergences": divergences}
    print("disagg " + json.dumps(out), flush=True)
    check(all(v["near_tie"] for v in divergences),
          f"disaggregated streams leave phase 4's away from a near tie: "
          f"{divergences}")
    return out


def serve_phases(dev, card: str, seed: int, server, actor_server,
                 checksum):
    """Phases S1-S2, after R3, each on a runtime of its own with an HTTP
    proxy; ``serve.shutdown`` kills the replicas and the runtime is shut
    down after each, and the card's free memory must come back. Returns
    the two phases' records."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import get_config
    cfg = get_config("gptj-6b")
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    out = {}
    for name, phase in (("S1", phase_serve_http), ("S2", phase_disagg)):
        t0 = time.perf_counter()
        ray_tpu_torch.init(num_cpus=8, num_gpus=torch.cuda.device_count(),
                           _num_initial_workers=3)
        try:
            serve.start(http_options={"port": 0})
            out[name] = phase(dev, card, cfg, seed, serve.proxy_address(),
                              server, actor_server, checksum)
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
                and time.monotonic() < deadline:
            time.sleep(0.5)
        free1 = torch.cuda.mem_get_info()[0]
        print(f"phase {name} wall: {time.perf_counter() - t0:.1f} s; card "
              f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f}"
              f" GB after serve.shutdown and the runtime's", flush=True)
        check(free1 >= free0 - (1 << 30),
              f"{name}'s replicas' card memory did not come back")
    return out


# ------------------------------------------------------------- RL1, RL2
RL_SYSTEM = 256       # tokens of the system prompt every rollout shares
RL_SUFFIX = 32        # tokens of each rollout's own suffix
RL_NEW = 64           # tokens each rollout generates
RL1_LAYERS = 8        # f32 masters, grads and Adam for 28 layers: 97 GB
RL2_LAYERS = 2        # each learner's f32 grads cross the store both ways
RL1_ROUNDS = 1        # each round's publish: ~40 s of numpy pack/unpack
RL_MINIBATCH = 4
RL_PROBE = 96         # tokens of RL1's probe prompt after the publish
# RL1's version-0 check. The learner's flash path and the engine's paged
# path are two bf16 forwards whose attention outputs round apart: on the
# H100 at RL1's shapes their log-probabilities of one token differ by
# about 7e-3 at the median and up to about 0.04 when the logits are kept
# in f32, and bf16 logits put each on a grid of 2^-5 in [4, 8), so that
# about 1 token in 4 lands a grid step apart and the rest agree within
# 2e-4. The bar LOGPROB_ABS_TOL holds the mean over the round's tokens;
# each token is held to four grid steps. The control (one position late)
# is off by nats.
RL_V0_TOKEN_BOUND = 4 * 2 ** -5


def rl_model(n_layers: int):
    """GPT-J-6B's published width at ``n_layers`` layers, bf16 compute,
    no rematerialization."""
    from ray_tpu_torch.models import get_config
    return get_config("gptj-6b", n_layers=n_layers, remat=None,
                      remat_policy="none")


def rl_config(cfg, seed: int, **kw):
    """The RLHF knobs both phases share: a seeded 256-token system
    prompt and 32-token suffixes, 64 new tokens, phase 4's 32-token
    blocks and 256-token chunks, a 384-token window, 16 decode slots."""
    from ray_tpu_torch.rlhf import RLHFConfig
    rng = np.random.default_rng(seed + 21)
    system = tuple(int(t) for t in rng.integers(2, cfg.vocab_size,
                                                RL_SYSTEM))
    return RLHFConfig(
        system_prompt=system, prompt_len=RL_SYSTEM + RL_SUFFIX,
        max_new_tokens=RL_NEW, model=model_dict(cfg), seed=seed,
        engine=dict(decode_slots=16, kv_block_size=32, max_seq_len=384,
                    prefill_chunk=256), **kw)


def flash_counts():
    return {n: f.kernel_launches for n, f in _flash_launches().items()}


def reset_flash_counts():
    for f in _flash_launches().values():
        f.kernel_launches = 0


def serving_tree(cfg, params):
    """A learner's f32 masters as the serving tree of the same numbers:
    matrices in the compute dtype (the learner casts them at each use),
    norm scales and biases in f32."""
    from ray_tpu_torch._bridge import F32_LEAVES

    def conv(name, v):
        if isinstance(v, dict):
            return {k: conv(k, x) for k, x in v.items()}
        return v.detach().to(torch.float32 if name in F32_LEAVES
                             else cfg.dtype, copy=True)
    return {k: conv(k, v) for k, v in params.items()}


def teacher_forced(cfg, params, batch, dev, rows: int = RL_MINIBATCH):
    """Each generated token's log-probability under ``params``, through
    the port's ``apply`` (the flash forward on the card) on the prompt
    and the trajectory teacher-forced, ``rows`` trajectories a call, as
    the PPO learner reads it (``logits[:, P-1:]``); and the control, the
    same logits read one position late (``logits[:, P:]``), the
    off-by-one of a wrong teacher-forcing index. Returns (lp, control,
    calls)."""
    from ray_tpu_torch.models import apply
    lps, ctl, calls = [], [], 0
    with torch.no_grad():
        for i in range(0, len(batch["tokens"]), rows):
            prompt = torch.as_tensor(batch["prompt"][i:i + rows]).to(dev)
            toks = torch.as_tensor(batch["tokens"][i:i + rows]).to(dev)
            P = prompt.shape[1]
            logits = apply(cfg, params, torch.cat([prompt, toks[:, :-1]], 1))
            calls += 1
            lsm = torch.log_softmax(logits.float(), dim=-1)
            lps.append(lsm[:, P - 1:].gather(
                -1, toks[..., None].long())[..., 0].cpu())
            ctl.append(lsm[:, P:].gather(
                -1, toks[:, :-1, None].long())[..., 0].cpu())
            del logits, lsm
    return torch.cat(lps).numpy(), torch.cat(ctl).numpy(), calls


def watch_learner(learner):
    """Count and time a local PPO learner's calls: each
    ``compute_gradients``'s metrics, each update's wall (synchronised)."""
    log = {"metrics": [], "update_s": []}
    compute, update = learner.compute_gradients, learner.update_from_batch

    def compute_gradients(batch):
        grads, m = compute(batch)
        log["metrics"].append(m)
        return grads, m

    def update_from_batch(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(batch)
        torch.cuda.synchronize()
        log["update_s"].append(time.perf_counter() - t0)
        return out
    learner.compute_gradients = compute_gradients
    learner.update_from_batch = update_from_batch
    return log


def watch_streams(rollout):
    """The block streams a rollout engine hands out, one a round, each
    with the times it opened and its last block was pushed (the
    consumer's wall also holds the learner's updates)."""
    streams, open_round = [], rollout.stream_round

    def stream_round(*a, **kw):
        t0 = time.perf_counter()
        stream = open_round(*a, **kw)
        stream.opened, push = t0, stream.push

        def timed_push(batch, info):
            stream.last_push = time.perf_counter()
            push(batch, info)
        stream.push = timed_push
        streams.append(stream)
        return stream
    rollout.stream_round = stream_round
    return streams


def round_record(out, wall_s, stream):
    s = stream.stats()
    keys = ("round", "trajectories", "rollout_tokens", "prefix_hit_rate",
            "weight_version", "weight_syncs", "wire_compression",
            "sync_stall_s", "staleness_max", "total_loss", "approx_kl",
            "ratio_mean", "grad_norm", "stream_updates", "learners_used")
    rec = {k: out[k] for k in keys if k in out}
    rollout_s = stream.last_push - stream.opened
    rec.update(round_wall_s=wall_s, rollout_wall_s=rollout_s,
               rollout_tokens_per_s=s["rows"] * RL_NEW / rollout_s,
               consume_wall_s=s["wall_s"], bubble=s["bubble"])
    return rec


def check_round(name: str, rec, want: int, publishes: int, lag: int):
    check(rec["trajectories"] == want,
          f"{name}: {rec['trajectories']} trajectories, not {want}")
    check(rec["prefix_hit_rate"] is not None
          and rec["prefix_hit_rate"] > 0.5,
          f"{name}: prefix hit rate {rec['prefix_hit_rate']} <= 0.5")
    check(rec["sync_stall_s"] == 0.0,
          f"{name}: sync stall {rec['sync_stall_s']} s")
    check(rec["staleness_max"] is not None and rec["staleness_max"] <= lag,
          f"{name}: staleness {rec['staleness_max']} > {lag}")
    check(rec["weight_version"] == rec["weight_syncs"] == publishes,
          f"{name}: weight version {rec['weight_version']}, syncs "
          f"{rec['weight_syncs']}, publishes {publishes}")
    check(rec["wire_compression"] > 3.5,
          f"{name}: wire compression {rec['wire_compression']} <= 3.5")


def phase_rl1(dev, card: str, seed: int):
    """RL1: anakin, one local learner, one engine, GPT-J-6B width at 8
    layers, 16 rollouts a round, ``RL1_ROUNDS`` rounds. Every round: 16
    trajectories, prefix hit rate > 0.5, no sync stall, staleness <= 1,
    the engines' version = the publishes, wire compression > 3.5.
    Version 0: every
    token's log-probability recomputed from the learner's weights before
    its first update through ``apply`` (flash forward) within 2e-2 of
    the engine's (paged kernel) on average and ``RL_V0_TOKEN_BOUND``
    each, the one-position-late control outside;
    the first gradient round's ratio_mean within 1e-2 of 1. After round
    1's publish a probe prompt that shares no cached prefix is served at
    the new version, its first token's log-probability that of direct
    ``prefill`` logits from ``unpack_weights(pack_weights(w))``, farther
    from version 0's. Launches: 8 x the engine's prefill chunks and
    decode steps (paged), 8 x ``compute_gradients`` calls (flash)."""
    from ray_tpu_torch._bridge import params_from_jax
    from ray_tpu_torch.rlhf import RLHFTrainer, pack_weights, unpack_weights
    cfg = rl_model(RL1_LAYERS)
    rc = rl_config(cfg, seed, placement="anakin", num_learners=1,
                   num_engines=1, rollouts_per_round=16,
                   minibatch_size=RL_MINIBATCH, num_epochs=1,
                   learning_rate=1e-3, max_weight_lag=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = RLHFTrainer(rc, device=dev)
    build_s = time.perf_counter() - t0
    try:
        learner = trainer.learners._local
        engine = trainer.rollout.engines[0]
        ecfg = engine.model_config
        v0 = serving_tree(ecfg, learner._state["params"])
        log, streams = watch_learner(learner), watch_streams(trainer.rollout)
        rng = np.random.default_rng(seed + 22)
        probe = [int(t) for t in rng.integers(2, cfg.vocab_size, RL_PROBE)]
        reset_launches()
        reset_flash_counts()
        rounds = []
        for r in range(RL1_ROUNDS):
            t1 = time.perf_counter()
            out = trainer.train_round()
            torch.cuda.synchronize()
            rounds.append(round_record(out, time.perf_counter() - t1,
                                       streams[-1]))
            if r == 0:
                served = list(engine.generate_sync(
                    probe, 4, detailed=True, timeout_s=ACTOR_TIMEOUT_S))
                w1 = trainer.learners.get_weights()
        from ray_tpu_torch.ops.paged_flash import paged_flash_attention
        s = wait_idle(engine)
        paged = paged_flash_attention.kernel_launches
        flash = flash_counts()
        pub = trainer.publisher.stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        engine_calls = s["prefill_chunks"] + s["decode_steps"]
        grad_calls = len(log["metrics"])
        # -- the checks' own device work, after the main path's counts
        batch0 = streams[0].full_batch()
        check(bool((batch0["versions"] == 0).all()),
              "round 1 has tokens past version 0")
        lp, ctl, fwd_calls = teacher_forced(ecfg, v0, batch0, dev)
        err = np.abs(lp - batch0["logprobs"])
        ctl_err = np.abs(ctl - batch0["logprobs"][:, :-1])
        t1 = time.perf_counter()
        packed = pack_weights(w1, 1, rc.quant_block_size)
        pack_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        tree = params_from_jax(unpack_weights(packed)[0], ecfg, dev)
        unpack_s = time.perf_counter() - t1
        del w1, packed
        tok = served[0][0]
        ref_row = torch.log_softmax(direct_logits(dev, ecfg, tree, probe),
                                    -1)
        ref_lp, ref_tok = ref_row[tok].item(), int(ref_row.argmax())
        v0_lp = torch.log_softmax(direct_logits(dev, ecfg, v0, probe),
                                  -1)[tok].item()
        del tree
        flash_after = flash_counts()
    finally:
        trainer.shutdown()
        del trainer
        torch.cuda.empty_cache()
    first = log["metrics"][0]
    out = {"card": card, "config": f"gptj-6b n_layers={RL1_LAYERS}",
           "params": cfg.num_params, "build_s": build_s, "rounds": rounds,
           "learner_ms_per_update": [1e3 * x for x in log["update_s"]],
           "compute_gradients_calls": grad_calls,
           "first_round": first,
           "v0_tokens": int(err.size),
           "v0_tokens_over_bar": int((err > LOGPROB_ABS_TOL).sum()),
           "v0_logprob_abs_err_mean": float(err.mean()),
           "v0_logprob_abs_err_median": float(np.median(err)),
           "v0_logprob_abs_err_max": float(err.max()),
           "control_abs_err_mean": float(ctl_err.mean()),
           "control_abs_err_median": float(np.median(ctl_err)),
           "control_abs_err_max": float(ctl_err.max()),
           "probe": {"tokens": [t for t, _, _ in served],
                     "versions": [v for _, v, _ in served],
                     "first_logprob": served[0][2],
                     "published_ref_logprob": ref_lp,
                     "published_ref_token": ref_tok,
                     "v0_logprob": v0_lp},
           "publisher": pub,
           "wire_bytes_per_publish": pub["wire_bytes_total"]
           / max(pub["publishes"], 1),
           "publish_wall_s_per_publish": pub["publish_wall_s"]
           / max(pub["publishes"], 1),
           "check_pack_s": pack_s, "check_unpack_and_stage_s": unpack_s,
           "engine": {k: s[k] for k in ("prefill_chunks", "decode_steps",
                                        "prefix_hit_blocks_total",
                                        "prompt_blocks_total",
                                        "weight_swaps", "tokens_total")},
           "paged_launches": paged, "flash_launches": flash,
           "check_forward_calls": fwd_calls,
           "peak_mem_gb": peak_gb}
    print("rl1 " + json.dumps(out), flush=True)
    for i, rec in enumerate(rounds):
        check_round(f"RL1 round {i + 1}", rec, 16, i + 1, rc.max_weight_lag)
    check(paged > 0 and paged == RL1_LAYERS * engine_calls,
          f"RL1 paged launches {paged} != {RL1_LAYERS} x {engine_calls}")
    for n, c in flash.items():
        check(c > 0 and c == RL1_LAYERS * grad_calls,
              f"RL1 {n} launched {c} times, not {RL1_LAYERS} x {grad_calls}")
    check(flash_after["flash_fwd"] - flash["flash_fwd"]
          == RL1_LAYERS * fwd_calls,
          f"the check's forwards: {flash_after} after {flash}")
    check(err.mean() <= LOGPROB_ABS_TOL and err.max() <= RL_V0_TOKEN_BOUND,
          f"RL1 version-0 logprobs: learner vs engine mean err "
          f"{err.mean()} (bar {LOGPROB_ABS_TOL}), max {err.max()} (bound "
          f"{RL_V0_TOKEN_BOUND})")
    check(np.median(ctl_err) > RL_V0_TOKEN_BOUND,
          f"RL1 control (one position late) median err "
          f"{np.median(ctl_err)} is inside {RL_V0_TOKEN_BOUND}: the check "
          f"does not separate it")
    check(abs(first["ratio_mean"] - 1) <= 1e-2,
          f"RL1 first gradient round ratio_mean {first['ratio_mean']}")
    check(all(math.isfinite(first[k]) for k in ("total_loss", "grad_norm")),
          f"RL1 first gradient round not finite: {first}")
    check(set(v for _, v, _ in served) == {1},
          f"RL1 probe stamped {[v for _, v, _ in served]}, not version 1")
    check(served[0][0] == ref_tok,
          f"RL1 probe served token {served[0][0]}, the published tree's "
          f"argmax {ref_tok}")
    check(abs(served[0][2] - ref_lp) <= LOGPROB_ABS_TOL,
          f"RL1 probe logprob {served[0][2]} vs the published tree's "
          f"{ref_lp}")
    check(abs(served[0][2] - v0_lp) > abs(served[0][2] - ref_lp),
          f"RL1 probe logprob {served[0][2]} is no farther from version "
          f"0's {v0_lp} than from the published tree's {ref_lp}")
    return out


def learner_ready(inst):
    """A remote PPO learner's card, process and memory, and the flash
    launch counts of its process (set to 0 here)."""
    reset_flash_counts()
    dev = inst._learner.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    return {"device": device_name(dev), "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "allocated_gb": torch.cuda.memory_allocated() / 1e9
            if on_card else 0.0}


def learner_after(inst):
    """A remote learner's flash launch counts, call walls, peak memory
    and a sha256 of each of its weights' bytes."""
    import hashlib
    dev = inst._learner.device
    from ray_tpu_torch.models.training import tree_leaves
    digest = hashlib.sha256()
    for t in tree_leaves(inst._learner._state["params"]):
        digest.update(t.detach().cpu().numpy().tobytes())
    return {"launches": flash_counts(), "walls": inst.walls,
            "weights_sha256": digest.hexdigest(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
            if dev.type == "cuda" else 0.0}


def phase_rl2(dev, card: str, seed: int):
    """RL2: sebulba, 2 remote learners (``{"num_cpus": 1}`` each, on the
    card through ``device=None`` in their workers), 2 engines in the
    driver, GPT-J-6B width at 2 layers, 8 rollouts, one gradient round of
    4 rows a learner, one round, on a runtime whose store holds 6 f32
    weight trees. Two learners used on disjoint shards, their weights
    bit-identical after the round, a publish, no sync stall, staleness
    <= 1, each learner's flash launches 2 x its ``compute_gradients``
    calls; the gradient round's wall split into compute, gradients out
    through the store, the host mean, and the mean back."""
    import shutil

    import ray_tpu_torch
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention
    from ray_tpu_torch.rlhf import RLHFTrainer
    cfg = rl_model(RL2_LAYERS)
    rc = rl_config(cfg, seed, placement="sebulba", num_learners=2,
                   num_engines=2, rollouts_per_round=8, minibatch_size=8)
    payload = 4 * cfg.num_params
    shm = shutil.disk_usage("/dev/shm")
    ray_tpu_torch.init(num_cpus=8, num_gpus=torch.cuda.device_count(),
                       _num_initial_workers=3,
                       object_store_memory=6 * payload)
    trainer = None
    try:
        t0 = time.perf_counter()
        trainer = RLHFTrainer(rc)
        build_s = time.perf_counter() - t0
        streams = watch_streams(trainer.rollout)
        actors = trainer.learners._remote
        ready = ray_tpu_torch.get([a.__ray_call__.remote(learner_ready)
                                   for a in actors], timeout=ACTOR_TIMEOUT_S)
        for info in ready:
            check(info["device"] == device_name(dev),
                  f"an RL2 learner runs on {info['device']!r}")
        check(ready[0]["pid"] != ready[1]["pid"],
              "the two RL2 learners share a process")
        reset_launches()
        t0 = time.perf_counter()
        out = trainer.train_round()
        wall = time.perf_counter() - t0
        stats = [wait_idle(e) for e in trainer.rollout.engines]
        paged = paged_flash_attention.kernel_launches
        after = ray_tpu_torch.get([a.__ray_call__.remote(learner_after)
                                   for a in actors], timeout=ACTOR_TIMEOUT_S)
        shard_uids = [list(u) for u in trainer.learners.shard_uids]
        round_walls = list(trainer.learners.round_walls)
        pub = trainer.publisher.stats()
        rec = round_record(out, wall, streams[0])
    finally:
        if trainer is not None:
            trainer.shutdown()
        ray_tpu_torch.shutdown()
    engine_calls = sum(s["prefill_chunks"] + s["decode_steps"]
                       for s in stats)
    split = []
    for i, (gather_s, mean_s, apply_s) in enumerate(round_walls):
        compute = max(a["walls"]["compute_gradients"][i] for a in after)
        to_host = max(a["walls"]["grads_to_host"][i] for a in after)
        applied = max(a["walls"]["apply_gradients"][i] for a in after)
        split.append({"round_s": gather_s + mean_s + apply_s,
                      "compute_s": compute, "grads_to_host_s": to_host,
                      "grads_out_through_store_s": gather_s - compute
                      - to_host,
                      "host_mean_s": mean_s,
                      "mean_back_through_store_s": apply_s - applied,
                      "apply_in_learner_s": applied})
    res = {"card": card, "config": f"gptj-6b n_layers={RL2_LAYERS}",
           "params": cfg.num_params, "grad_payload_bytes": payload,
           "dev_shm_bytes": shm.total, "build_s": build_s,
           "learners": ready, "round": rec,
           "shard_uids": shard_uids, "gradient_rounds": split,
           "publisher": pub, "engine_calls": engine_calls,
           "paged_launches": paged,
           "learner_launches": [a["launches"] for a in after],
           "learner_walls": [a["walls"] for a in after],
           "learner_peak_mem_gb": [a["peak_mem_gb"] for a in after],
           "weights_sha256": [a["weights_sha256"] for a in after]}
    print("rl2 " + json.dumps(res), flush=True)
    check(out["trajectories"] == 8, f"RL2: {out['trajectories']} "
          f"trajectories, not 8")
    check(out["learners_used"] == 2.0,
          f"RL2 learners used: {out['learners_used']}")
    u0, u1 = map(set, shard_uids)
    check(bool(u0) and bool(u1) and not (u0 & u1),
          f"RL2 shards not disjoint: {shard_uids}")
    check(after[0]["weights_sha256"] == after[1]["weights_sha256"],
          "RL2 learners' weights differ after the round")
    check(out["weight_syncs"] >= 1 and out["sync_stall_s"] == 0.0
          and out["staleness_max"] is not None
          and out["staleness_max"] <= rc.max_weight_lag,
          f"RL2 syncs {out['weight_syncs']}, stall {out['sync_stall_s']}, "
          f"staleness {out['staleness_max']}")
    check(paged > 0 and paged == RL2_LAYERS * engine_calls,
          f"RL2 paged launches {paged} != {RL2_LAYERS} x {engine_calls}")
    for i, a in enumerate(after):
        calls = len(a["walls"]["compute_gradients"])
        for n, c in a["launches"].items():
            check(calls > 0 and c == RL2_LAYERS * calls,
                  f"RL2 learner {i}: {n} launched {c} times, not "
                  f"{RL2_LAYERS} x {calls}")
    return res


def rlhf_phases(dev, card: str, seed: int):
    """RL1 and RL2 after S2; the card's free memory must come back after
    each. Returns the two phases' records."""
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    out = {}
    for name, phase in (("RL1", phase_rl1), ("RL2", phase_rl2)):
        t0 = time.perf_counter()
        out[name] = phase(dev, card, seed)
        gc.collect()       # the watchers' wrappers close reference cycles
        torch.cuda.empty_cache()
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
                and time.monotonic() < deadline:
            time.sleep(0.5)
        free1 = torch.cuda.mem_get_info()[0]
        print(f"phase {name} wall: {time.perf_counter() - t0:.1f} s; card "
              f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f}"
              f" GB after", flush=True)
        check(free1 >= free0 - (1 << 30),
              f"{name}'s card memory did not come back")
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
    """Phases 3-6d on GPT-J-6B's serving weights (bf16, 12 GB); the
    weights are released when this returns. Returns the paged kernel's
    record, phase 4's numbers and streams, and the weights' checksum
    (phase R3's references)."""
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
    checksum = weights_checksum(params)
    server = phase_server(dev, card, cfg, params, seed)
    phase_e2e(dev, cfg, params, seed)
    phase_profile(dev, cfg, params, seed)
    serving_features(dev, card, cfg, params, seed)
    by_name = {r["shape"]: r for r in shapes}
    main_shape = by_name["gptj6b_decode"]    # 28 per step
    verify = by_name["gptj6b_verify"]
    return server, checksum, {
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
        "prefill_ms": by_name["gptj6b_prefill"]["kernel_ms"],
        "prefill_library_ms": by_name["gptj6b_prefill"]["library_ms"],
        "verify_ms": verify["kernel_ms"],
        "verify_plain_ms": verify["plain_ms"],
        "verify_library_ms": verify["library_ms"],
        "verify_bound_ms": verify["bound_ms"],
        "verify_bound_by": verify["bound_by"],
        "verify_bound_share": verify["bound_share"],
        "verify_max_row_rel_err": verify["max_row_rel_err"],
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
        # RL1's PPO learner: a minibatch of 4 trajectories teacher-forced
        # over 288 + 64 - 1 = 351 tokens, the last tile partial, bf16
        FlashShape("rl1_learner", RL_MINIBATCH, RL_SYSTEM + RL_SUFFIX
                   + RL_NEW - 1, RL_SYSTEM + RL_SUFFIX + RL_NEW - 1, 16,
                   256, torch.bfloat16, True),
        # P1's ranks: one row a data rank, the tp half of the 16 heads
        FlashShape("p1_rank", SHARD_BATCH // SHARD_MESH["fsdp"], 2048, 2048,
                   16 // SHARD_MESH["tp"], 256, torch.bfloat16, True),
        # M1's ranks: one row a data rank, all 16 heads (ep splits no head)
        FlashShape("m1_rank", SHARD_BATCH // MOE_MESH["fsdp"], 2048, 2048,
                   16, 256, torch.bfloat16, True),
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
    # delta's own library call: one vecdot of O and dO over head_dim on
    # the same bf16 inputs (the kernel's rowsum is f32, vecdot's bf16)
    lib_delta = events_ms(lambda: torch.linalg.vecdot(o, do, dim=-1), 20)
    library = {"flash_fwd": lib_fwd, "flash_delta": lib_delta}
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
                     "library_ms": library.get(name, lib_bwd),
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "flops": flops, "bound_share": b_ms / k_ms,
                     "achieved_tflop_s": flops / k_ms / 1e9,
                     "achieved_gb_s": nbytes / k_ms / 1e6}
    out["flash_delta"]["sdpa_backward_ms"] = lib_bwd
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
        if "sdpa_backward_ms" in t:
            records[-1]["sdpa_backward_ms"] = t["sdpa_backward_ms"]
    return records


# ------------------------------------------------------- phases P1-P3
# Sharding and collectives. The ranks are actors of the port's runtime,
# four processes (num_gpus=0.25 each) on the one card, joined into one
# gloo group: NCCL refuses two ranks on one device, so the collectives
# between ranks cross host memory through gloo (the collective layer
# copies CUDA tensors through a host buffer where gloo does not take
# them) while the flash kernels and the matmuls run on the card. NCCL is
# driven at world size 1 (P3).
SHARD_MESH = {"fsdp": 2, "tp": 2}   # __graft_entry__._factor_mesh(4)
SHARD_BATCH = 2                     # global rows: 1 x 2048 a data rank
P1_LAYERS = 8
P1_TIMED_STEPS = 3
P2_LAYERS = 2
P2_STEPS = 3
P3_BACKEND = "nccl"
# P2's bounds: the sharded step sums bf16 partial products across the
# heads axis (row-parallel outputs, the vocab-parallel loss) where one
# device accumulates in one matmul, so its bf16 activations round apart
# from the one-device step's at each block; the control (wk/wv's
# gradients not summed over tp) drops half of their columns.
P2_LOSS_REL_BOUND = 2e-3
P2_GRAD_REL_L2_BOUND = 3e-2
P2_LEAF_REL_L2_BOUND = 6e-2
# JAX's own acceptance bound for int8 transport (tests/models/
# test_sharded_update.py:64): |loss - fp32 loss| < 1e-2, still learning.
INT8_LOSS_BOUND = 1e-2


def shard_model(n_layers: int):
    """GPT-J-6B's published width at ``n_layers`` layers, bf16 compute."""
    from ray_tpu_torch.models import get_config
    return get_config("gptj-6b", n_layers=n_layers)


class CollectiveClock:
    """Wraps the collective layer's one entry into torch.distributed
    (``collective._run``) in this process: seconds and bytes sent per op,
    the card synchronised before and after each call so that the time is
    the collective's alone."""

    def __init__(self, cuda: bool):
        from ray_tpu_torch.parallel import collective
        self.mod, self.cuda = collective, cuda
        self.inner = collective._run
        self.reset()

    def reset(self):
        self.seconds, self.bytes, self.calls = {}, {}, {}

    def __enter__(self):
        def run(op, fn, out, *inputs, pg):
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.inner(op, fn, out, *inputs, pg=pg)
            if self.cuda:
                torch.cuda.synchronize()
            sent = inputs[0] if inputs else out
            self.seconds[op] = self.seconds.get(op, 0.0) \
                + time.perf_counter() - t0
            self.bytes[op] = self.bytes.get(op, 0) \
                + sent.numel() * sent.element_size()
            self.calls[op] = self.calls.get(op, 0) + 1
        self.mod._run = run
        return self

    def __exit__(self, *exc):
        self.mod._run = self.inner

    def snapshot(self):
        return {"seconds": dict(self.seconds), "bytes": dict(self.bytes),
                "calls": dict(self.calls)}


def _rank_mesh(rank, dev_str: str, mesh_kw=None):
    """Build (once) this rank's mesh over ``mesh_kw`` (SHARD_MESH by
    default) on the device's type; returns it. A rank told to run on the
    card that finds none raises."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    mesh_kw = SHARD_MESH if mesh_kw is None else mesh_kw
    key = ("mesh",) + tuple(sorted(mesh_kw.items()))
    if key not in rank.state:
        dev = torch.device(dev_str)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {os.getpid()} finds no CUDA device")
            torch.cuda.set_device(dev)
        rank.state[key] = build_mesh(MeshSpec(**mesh_kw),
                                     device_type=dev.type)
    return rank.state[key]


def _rank_release(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _replicated_sha(params, specs, axis: str):
    """sha256 of the bytes of every leaf that no spec entry splits over
    ``axis``."""
    import hashlib
    from ray_tpu_torch.parallel.sharding import spec_axes
    out = {}
    for name, t in _named(params):
        spec = specs
        for k in name.split("."):
            spec = spec[k]
        if not any(axis in spec_axes(e) for e in spec):
            out[name] = hashlib.sha256(
                t.detach().cpu().contiguous().view(torch.uint8)
                .numpy().tobytes()).hexdigest()
    return out


def train_rank(rank, cfg, mesh_kw, dev_str: str, seed: int,
               timed_steps: int):
    """P1, M1 and M2 on one rank: the sharded trainer over ``mesh_kw``,
    one warm-up step and ``timed_steps`` timed ones on one seeded batch
    of SHARD_BATCH x max_seq_len."""
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.models.transformer import param_shapes
    from ray_tpu_torch.parallel.mesh import axis_sizes, mesh_coordinate
    from ray_tpu_torch.parallel.sharding import FSDP_RULES, local_shape
    dev = torch.device(dev_str)
    cuda = dev.type == "cuda"
    mesh = _rank_mesh(rank, dev_str, mesh_kw)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bundle = make_train_step(cfg, mesh, FSDP_RULES, learning_rate=1e-4,
                             remat_policy="dots", ce_chunk_size=512,
                             device=dev)
    t0 = time.perf_counter()
    state = bundle.init(seed=seed)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S = cfg.max_seq_len
    rng = np.random.default_rng(seed + 3)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (SHARD_BATCH, S))}
    reset_flash_counts()
    losses, norms, walls, split, moe = [], [], [], [], []
    with CollectiveClock(cuda) as clock:
        for _ in range(1 + timed_steps):
            if cuda:
                torch.cuda.synchronize()
            clock.reset()
            t0 = time.perf_counter()
            state, m = bundle.step(state, batch)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            if cuda:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            split.append(clock.snapshot())
            if cfg.n_experts:
                moe.append({"aux": m["moe_aux"].item(),
                            "dropped": m["moe_dropped"].tolist()})
    sizes = axis_sizes(mesh)
    shapes = param_shapes(cfg)
    specs = bundle.state_shardings["params"]
    shard_shapes, want = {}, {}
    for name, t in _named(state["params"]):
        shard_shapes[name] = list(t.shape)
        shape, spec = shapes, specs
        for k in name.split("."):
            shape, spec = shape[k], spec[k]
        want[name] = list(local_shape(shape, spec, sizes))
    out = {"coordinate": mesh_coordinate(mesh), "pid": os.getpid(),
           "device": device_name(dev), "init_s": init_s, "losses": losses,
           "grad_norms": norms, "walls_s": walls, "collectives": split,
           "launches": flash_counts(), "shard_shapes": shard_shapes,
           "want_shapes": want,
           "state_gb": nbytes(state) / 1e9, "moe": moe,
           "replicated_sha": {a: _replicated_sha(state["params"], specs, a)
                              for a in ("tp", "ep") if sizes[a] > 1},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
           if cuda else 0.0}
    del state, bundle
    _rank_release(dev)
    return out


def phase_p1(dev, card: str, seed: int, actors):
    """P1: ``make_train_step`` at GPT-J-6B width cut to P1_LAYERS layers
    on MeshSpec(fsdp=2, tp=2) over four rank processes sharing the card,
    global batch 2 x 2048; losses finite, equal on every rank and
    falling, each flash kernel launched P1_LAYERS x steps on each rank,
    FSDP_RULES' shard shapes, leaves replicated over tp bit-identical
    across each tp pair; step wall, tokens/s, MFU, peak memory a rank and
    the wall split into compute and collectives."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    cfg = shard_model(P1_LAYERS)
    t0 = time.perf_counter()
    outs = run_on_ranks(actors, train_rank, cfg, SHARD_MESH, str(dev),
                        seed, P1_TIMED_STEPS)
    res = train_record("P1", card, cfg, SHARD_MESH, outs,
                       time.perf_counter() - t0)
    print("p1 " + json.dumps(res), flush=True)
    check_train_ranks("P1", dev, outs, SHARD_MESH, P1_LAYERS * (
        1 + P1_TIMED_STEPS))
    return res


def train_record(name: str, card: str, cfg, mesh_kw, outs, wall: float):
    """A sharded trainer phase's record: step wall (the slowest rank's,
    over the timed steps), tokens/s, MFU, the wall split into compute and
    collectives, the collectives by op, each rank's losses, launches and
    peak memory."""
    S = cfg.max_seq_len
    steps = len(outs[0]["walls_s"])
    timed = [max(o["walls_s"][i] for o in outs) for i in range(1, steps)]
    step_s = float(np.mean(timed))
    tok_s = SHARD_BATCH * S / step_s
    flops_tok = cfg.flops_per_token(S)
    coll = [float(np.mean([sum(o["collectives"][i]["seconds"].values())
                           for i in range(1, steps)])) for o in outs]
    return {"phase": name, "card": card,
            "config": f"gptj-6b n_layers={cfg.n_layers}"
            + (f" n_experts={cfg.n_experts}" if cfg.n_experts else ""),
            "mesh": mesh_kw, "backend": "gloo", "params": cfg.num_params,
            "batch": [SHARD_BATCH, S], "remat_policy": "dots",
            "phase_wall_s": wall, "step_s": step_s,
            "step_s_min": min(timed), "step_s_max": max(timed),
            "tokens_per_s": tok_s, "flops_per_token": flops_tok,
            "mfu": flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16],
            "compute_s_per_step": [step_s - c for c in coll],
            "collective_s_per_step": coll,
            "collectives_by_op_last_step": [o["collectives"][-1]
                                            for o in outs],
            "ranks": [{k: o[k] for k in (
                "coordinate", "pid", "device", "init_s", "losses",
                "grad_norms", "walls_s", "launches", "state_gb",
                "peak_mem_gb", "moe")} for o in outs]}


def check_train_ranks(name: str, dev, outs, mesh_kw, flash: int):
    """The checks of a sharded trainer phase: losses and grad norms
    finite, the losses equal on every rank and falling, every rank on
    this card with the rules' shard shapes and each flash kernel
    launched ``flash`` times, and the leaves that a model axis (tp, ep)
    does not split bit-identical across each group of that axis."""
    losses = [o["losses"] for o in outs]
    check(all(math.isfinite(x) for row in losses for x in row)
          and all(math.isfinite(x) for o in outs for x in o["grad_norms"]),
          f"{name} non-finite loss or grad norm: {losses}")
    check(all(row == losses[0] for row in losses),
          f"{name} losses differ between ranks: {losses}")
    check(losses[0][-1] < losses[0][0],
          f"{name} loss did not fall: {losses[0]}")
    for i, o in enumerate(outs):
        check(o["device"] == device_name(dev),
              f"{name} rank {i} runs on {o['device']!r}")
        for n, c in o["launches"].items():
            check(c == flash, f"{name} rank {i}: {n} launched {c} times, "
                  f"not {flash}")
        check(o["shard_shapes"] == o["want_shapes"],
              f"{name} rank {i}: shard shapes {o['shard_shapes']} are not "
              f"FSDP_RULES' {o['want_shapes']}")
    for axis in outs[0]["replicated_sha"]:
        groups = {}
        for o in outs:
            key = tuple(v for a, v in sorted(o["coordinate"].items())
                        if a != axis)
            groups.setdefault(key, []).append(o["replicated_sha"][axis])
        for key, shas in groups.items():
            check(len(shas) == mesh_kw[axis] and shas[0]
                  and all(sh == shas[0] for sh in shas),
                  f"{name} leaves replicated over {axis} differ across the "
                  f"{axis} group at {key}")


def p2_rank(rank, cfg, dev_str: str, seed: int, steps: int):
    """P2 on one rank: the gradients of one sharded step (this rank's
    shards, summed over the data axes each leaf is replicated over) and
    of the faulty control, then ``steps`` fp32 steps and ``steps`` int8
    steps with the sharded weight update from the same weights."""
    from ray_tpu_torch.models import lm_loss, make_train_step
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.training import (_paths, int8_wire_lengths,
                                               leaf_plans)
    from ray_tpu_torch.parallel.collective import psum_tree
    from ray_tpu_torch.parallel.quantization import tree_wire_bytes
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    dev = torch.device(dev_str)
    cuda = dev.type == "cuda"
    mesh = _rank_mesh(rank, dev_str)
    S = cfg.max_seq_len
    rng = np.random.default_rng(seed + 5)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (SHARD_BATCH, S))}
    bundle = make_train_step(cfg, mesh, FSDP_RULES, remat_policy="dots",
                             device=dev)
    params = bundle.init(seed + 4)["params"]
    local = bundle.local_batch(batch)
    plans = leaf_plans(cfg, mesh, FSDP_RULES, False)
    paths = _paths(params)
    leaves = [t.requires_grad_() for _, t in _named(params)]
    out = {}
    kv = transformer._kv_weight_to_tp
    for run in ("sharded", "control"):
        if run == "control":     # the tp sum of wk/wv's gradients left out
            transformer._kv_weight_to_tp = lambda w, group: w
        try:
            loss, _ = lm_loss(cfg, params, local, mesh=mesh,
                              rules=FSDP_RULES)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            transformer._kv_weight_to_tp = kv
        reduced = {}
        for path, g in zip(paths, grads):
            if run == "control" and path[-1] not in ("wk", "wv"):
                continue        # the control changes wk/wv's alone
            group = plans[path].replicated
            reduced[".".join(path)] = (psum_tree(g, group)
                                       if group.size > 1 else g) \
                .detach().float().cpu().numpy()
        out[run] = {"loss": loss.item(), "grads": reduced,
                    "counts": {".".join(p): plans[p].counts
                               for p in paths}}
        del grads
    del params, leaves, bundle
    _rank_release(dev)
    for name, kw in (("fp32", {}), ("int8", {"grad_transport": "int8",
                                             "shard_weight_update": True})):
        b = make_train_step(cfg, mesh, FSDP_RULES, learning_rate=1e-4,
                            remat_policy="dots", device=dev, **kw)
        state = b.init(seed + 4)
        losses = []
        with CollectiveClock(cuda) as clock:
            for _ in range(steps):
                state, m = b.step(state, batch)
                losses.append(m["loss"].item())
        out[name] = {"losses": losses, "collectives": clock.snapshot()}
        del state, b
        _rank_release(dev)
    lengths = int8_wire_lengths(cfg, mesh, FSDP_RULES, True)
    out["int8"]["want_wire_bytes"] = steps * tree_wire_bytes(lengths)
    out["int8"]["wire_bytes"] = out["int8"]["collectives"]["bytes"].get(
        "all_to_all", 0)
    return out


def phase_p2(dev, card: str, seed: int, actors):
    """P2: the sharded step against the one-device step at P2_LAYERS
    layers, 1 x 2048 a data rank, same weights (the sharded init is a
    slice of the one-device init from the seed) and batch: loss relative
    difference and gradient relative L2 (global, worst leaf) within the
    P2 bounds, the faulty control outside them; then int8 transport with
    the sharded weight update for P2_STEPS steps within INT8_LOSS_BOUND
    of the fp32 sharded run, its int8 wire bytes equal to
    ``tree_wire_bytes`` of what it reduces."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    cfg = dataclasses.replace(shard_model(P2_LAYERS), remat=None,
                              remat_policy="dots")
    t0 = time.perf_counter()
    outs = run_on_ranks(actors, p2_rank, cfg, str(dev), seed, P2_STEPS)
    ranks_s = time.perf_counter() - t0
    loss_ref, ref, specs = one_device_grads(cfg, seed, dev)

    def got(o, run, n):
        grads = o[run]["grads"]
        return torch.from_numpy(np.array(
            grads[n] if n in grads else o["sharded"]["grads"][n])).to(dev)
    read = {run: grad_errors(outs, run, ref, loss_ref, specs,
                             SHARD_MESH, got)
            for run in ("sharded", "control")}
    fp32 = outs[0]["fp32"]["losses"]
    int8 = outs[0]["int8"]["losses"]
    res = {"card": card, "config": f"gptj-6b n_layers={P2_LAYERS}",
           "mesh": SHARD_MESH, "loss_one_device": loss_ref,
           "sharded": read["sharded"],
           "control": {k: read["control"][k] for k in
                       ("loss", "loss_rel", "grad_rel_l2", "worst_leaf",
                        "worst_leaf_rel_l2")},
           "bounds": [P2_LOSS_REL_BOUND, P2_GRAD_REL_L2_BOUND,
                      P2_LEAF_REL_L2_BOUND],
           "fp32_losses": [o["fp32"]["losses"] for o in outs],
           "int8_losses": [o["int8"]["losses"] for o in outs],
           "int8_loss_diff_last": abs(int8[-1] - fp32[-1]),
           "int8_wire_bytes": [o["int8"]["wire_bytes"] for o in outs],
           "int8_want_wire_bytes": [o["int8"]["want_wire_bytes"]
                                    for o in outs],
           "fp32_collectives": outs[0]["fp32"]["collectives"],
           "int8_collectives": outs[0]["int8"]["collectives"],
           "ranks_s": ranks_s}
    print("p2 " + json.dumps(res), flush=True)
    k, ctl = read["sharded"], read["control"]
    check(k["loss_rel"] <= P2_LOSS_REL_BOUND,
          f"P2 loss rel {k['loss_rel']} > {P2_LOSS_REL_BOUND}")
    check(k["grad_rel_l2"] <= P2_GRAD_REL_L2_BOUND,
          f"P2 grad rel L2 {k['grad_rel_l2']} > {P2_GRAD_REL_L2_BOUND}")
    check(k["worst_leaf_rel_l2"] <= P2_LEAF_REL_L2_BOUND,
          f"P2 leaf {k['worst_leaf']} grad rel L2 {k['worst_leaf_rel_l2']}"
          f" > {P2_LEAF_REL_L2_BOUND}")
    check(ctl["grad_rel_l2"] > P2_GRAD_REL_L2_BOUND
          or ctl["worst_leaf_rel_l2"] > P2_LEAF_REL_L2_BOUND,
          f"the faulty control's gradients (rel L2 {ctl['grad_rel_l2']}, "
          f"worst leaf {ctl['worst_leaf_rel_l2']}) pass P2's bounds")
    check(all(o["fp32"]["losses"] == fp32 and o["int8"]["losses"] == int8
              for o in outs), "P2 losses differ between ranks")
    check(all(math.isfinite(x) for x in fp32 + int8)
          and int8[-1] < int8[0] and fp32[-1] < fp32[0],
          f"P2 runs did not learn: fp32 {fp32}, int8 {int8}")
    check(res["int8_loss_diff_last"] < INT8_LOSS_BOUND,
          f"P2 int8 loss {int8[-1]} is {res['int8_loss_diff_last']} from "
          f"fp32's {fp32[-1]} (bound {INT8_LOSS_BOUND})")
    for i, o in enumerate(outs):
        check(o["int8"]["wire_bytes"] == o["int8"]["want_wire_bytes"] > 0,
              f"P2 rank {i}: int8 wire bytes {o['int8']['wire_bytes']} != "
              f"tree_wire_bytes {o['int8']['want_wire_bytes']}")
    return res


def one_device_grads(cfg, seed: int, dev):
    """The one-device loss and gradients (by leaf name) of ``cfg`` from
    the init of ``seed + 4`` on the seeded batch of SHARD_BATCH rows that
    P2's and M3's ranks take, and each leaf's FSDP_RULES spec."""
    from ray_tpu_torch.models import init_params, lm_loss
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    params = init_params(cfg, seed=seed + 4, device=dev)
    names = [n for n, _ in _named(params)]
    leaves = [t.requires_grad_() for _, t in _named(params)]
    rng = np.random.default_rng(seed + 5)
    batch = {"input_ids": torch.tensor(rng.integers(
        0, cfg.vocab_size, (SHARD_BATCH, cfg.max_seq_len)), device=dev)}
    loss, _ = lm_loss(cfg, params, batch)
    ref = dict(zip(names, torch.autograd.grad(loss, leaves)))
    specs = {n: FSDP_RULES.spec_for(a) for n, a in
             _named_axes(logical_axes(cfg))}
    return loss.item(), ref, specs


def _named_axes(tree, prefix=""):
    """(dotted name, logical axes) of every leaf of a logical-axes tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_axes(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def grad_errors(outs, run: str, ref, loss_ref: float, specs, mesh_kw,
                got):
    """Run ``run`` of the ranks' losses and gradient shards (``got(o,
    run, name)``, rank ``r``'s reduced gradient of a leaf on the device)
    against the one-device loss and gradients ``ref`` (by leaf name),
    each rank's shard held to the slice its spec gives it and each
    replica counted once: the loss's relative difference, the gradients'
    relative L2 over every leaf and per leaf, and the worst leaf."""
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    from ray_tpu_torch.parallel.sharding import local_slices
    sizes = {a: mesh_kw.get(a, 1) for a in AXIS_ORDER}
    num = den = 0.0
    leaf = {}
    for n in ref:
        ln = ld = 0.0
        for r, o in enumerate(outs):
            if not o[run]["counts"][n]:       # each replica once
                continue
            coord = dict(zip(AXIS_ORDER, np.unravel_index(
                r, [sizes[a] for a in AXIS_ORDER])))
            want = ref[n][local_slices(ref[n].shape, specs[n], sizes,
                                       coord)].float()
            ln += ((got(o, run, n) - want) ** 2).sum().item()
            ld += (want ** 2).sum().item()
        num, den = num + ln, den + ld
        leaf[n] = math.sqrt(ln / max(ld, 1e-30))
    worst = max(leaf, key=leaf.get)
    lx = outs[0][run]["loss"]
    return {"loss": lx, "loss_rel": abs(lx - loss_ref) / abs(loss_ref),
            "grad_rel_l2": math.sqrt(num / den), "worst_leaf": worst,
            "worst_leaf_rel_l2": leaf[worst], "leaf_rel_l2": leaf}


def p3_rank(rank, dev_str: str, seed: int):
    """P3 in a one-rank group: every eager op of the collective layer on
    a tensor on the device; the results and their devices."""
    from ray_tpu_torch.parallel import collective as col
    from ray_tpu_torch.parallel.quantization import (dequantize_int8,
                                                     quantize_int8)
    dev = torch.device(dev_str)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    x = torch.randn((64, 300), generator=g, device=dev)
    name = "p3"
    got = {
        "allreduce_sum": col.allreduce(x, name),
        "allreduce_mean": col.allreduce(x, name, op="mean"),
        "allreduce_max": col.allreduce(x, name, op="max"),
        "allgather": col.allgather(x, name)[0],
        "reducescatter": col.reducescatter(x, name),
        "reduce": col.reduce(x, 0, name),
        "broadcast": col.broadcast(x, 0, name),
        "quantized_allreduce": col.quantized_allreduce(x, name),
        "quantized_reducescatter": col.quantized_reducescatter(x, name),
    }
    col.barrier(name)
    # world 1: the reduction of one rank's tensor is the tensor; the
    # quantized ones carry both wire legs' rounding
    leg = dequantize_int8(*quantize_int8(x, jitted_scales=True))
    want_q = dequantize_int8(*quantize_int8(leg, jitted_scales=True),
                             shape=x.shape)
    out = {}
    for op, t in got.items():
        want = want_q if op.startswith("quantized") else x
        out[op] = {"device": str(t.device), "shape": list(t.shape),
                   "equal": bool(torch.equal(t, want)),
                   "max_abs_err": float((t - want).abs().max())}
    import torch.distributed as dist
    out["backend"] = str(dist.get_backend())
    out["world_size"] = dist.get_world_size()
    return out


def phase_p3(dev, card: str, seed: int):
    """P3: ``init_torch_distributed(backend=P3_BACKEND)`` at world size 1
    in a rank process on the card, and every eager op on a CUDA tensor:
    each result equals its input (the quantized ones the input's two-leg
    round trip) and stays on the card."""
    from ray_tpu_torch.parallel.dryrun import (run_on_ranks, start_ranks,
                                               stop_ranks)
    actors = start_ranks(1, P3_BACKEND, group_name="p3",
                         num_gpus=1.0 if dev.type == "cuda" else 0.0)
    try:
        out = run_on_ranks(actors, p3_rank, str(dev), seed)[0]
    finally:
        stop_ranks(actors)
    res = {"card": card, **out}
    print("p3 " + json.dumps(res), flush=True)
    check(out["backend"] == P3_BACKEND and out["world_size"] == 1,
          f"P3 group: {out['backend']} world {out['world_size']}")
    for op, r in out.items():
        if isinstance(r, dict):
            check(r["equal"] and r["device"] == str(
                torch.device(dev.type, 0) if dev.type == "cuda" else dev),
                f"P3 {op}: {r}")
    return res


def sharding_phases(dev, card: str, seed: int):
    """P1-P3 on a runtime of their own, after the training phases; the
    card's free memory must come back after them. Returns their
    records."""
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    n = SHARD_MESH["fsdp"] * SHARD_MESH["tp"]
    ray_tpu_torch.init(num_cpus=8, num_gpus=torch.cuda.device_count(),
                       _num_initial_workers=0)
    out = {}
    try:
        actors = start_ranks(n, "gloo", group_name="shard",
                             num_gpus=1.0 / n if dev.type == "cuda"
                             else 0.0)
        try:
            out["P1"] = phase_p1(dev, card, seed, actors)
            out["P2"] = phase_p2(dev, card, seed, actors)
        finally:
            stop_ranks(actors)
        out["P3"] = phase_p3(dev, card, seed)
    finally:
        ray_tpu_torch.shutdown()
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(f"phases P1-P3 wall: {time.perf_counter() - t0:.1f} s; card "
          f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f} GB "
          f"after", flush=True)
    check(free1 >= free0 - (1 << 30),
          "P1-P3's card memory did not come back")
    return out


# ------------------------------------------------------- phases M1-M3
# Mixture-of-experts over ep and ring attention over sp, on four rank
# processes sharing the card over gloo, as P1-P3's. The ring's K/V
# exchange is a send and a receive, which gloo cannot take on a CUDA
# tensor: it crosses a host buffer, so M2's ring seconds time host copies.
MOE_MESH = {"fsdp": 2, "ep": 2}
RING_MESH = {"fsdp": 2, "sp": 2}
M1_LAYERS = 2
M2_LAYERS = 4
M_TIMED_STEPS = 3
M3_LAYERS = 2
# M3's bounds, P2's and for P2's reasons: the sharded step's bf16
# products run at other shapes than one device's (a rank's rows, its
# chunk of the sequence; the ring's f32 blocks where the flash kernels
# round P to bf16) and round apart from them, and a token at a near tie
# of its router may go to another expert. The controls double or halve
# whole leaves: the ep one sums the gradients of the leaves that ep does
# not split over ep as well (ep is a model axis, and each of its ranks
# holds the whole gradient of those leaves already); the sp one leaves
# out the sum over sp (a data axis: each rank holds its chunk's share).
M3_LOSS_REL_BOUND = 2e-3
M3_GRAD_REL_L2_BOUND = 3e-2
M3_LEAF_REL_L2_BOUND = 6e-2


def moe_model(n_layers: int):
    """GPT-J-6B's widths at ``n_layers`` layers with moe-tiny's expert
    structure: 4 experts a layer in place of the dense MLP, Switch top-1
    routing, capacity factor 1.25, aux weight 0.01; bf16 compute."""
    return dataclasses.replace(shard_model(n_layers), n_experts=4,
                               capacity_factor=1.25, moe_aux_weight=0.01)


def ring_step_bytes(cfg, mesh_kw) -> int:
    """Bytes one ring step of one layer sends from a rank: its K and V
    chunk in f32, (2, rows, seq / sp, heads, head_dim)."""
    rows = SHARD_BATCH // (mesh_kw.get("dp", 1) * mesh_kw.get("fsdp", 1))
    heads = cfg.n_heads // mesh_kw.get("tp", 1)
    return 2 * rows * (cfg.max_seq_len // mesh_kw["sp"]) * heads \
        * cfg.head_dim * 4


def phase_m1(dev, card: str, seed: int, actors):
    """M1: ``make_train_step`` at ``moe_model(M1_LAYERS)`` on
    ``MeshSpec(fsdp=2, ep=2)`` under FSDP_RULES over four rank processes
    sharing the card, global batch 2 x 2048, one warm-up and
    M_TIMED_STEPS timed steps. P1's checks (losses, shard shapes: each
    rank holds 2 of the 4 experts and half of their embed dim), each
    flash kernel launched M1_LAYERS x steps, the leaves that ep does not
    split (router, attention, embedding, head, norms) bit-identical
    across each ep pair, and each layer's share of tokens dropped for
    capacity printed and equal within each ep pair."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    cfg = moe_model(M1_LAYERS)
    t0 = time.perf_counter()
    outs = run_on_ranks(actors, train_rank, cfg, MOE_MESH, str(dev), seed,
                        M_TIMED_STEPS)
    res = train_record("M1", card, cfg, MOE_MESH, outs,
                       time.perf_counter() - t0)
    res["moe_aux"] = [m["aux"] for m in outs[0]["moe"]]
    res["dropped_share_by_layer"] = [m["dropped"] for m in outs[0]["moe"]]
    res["moe_wi_shard"] = outs[0]["shard_shapes"]["layers.moe_wi"]
    print("m1 " + json.dumps(res), flush=True)
    check_train_ranks("M1", dev, outs, MOE_MESH, M1_LAYERS * (
        1 + M_TIMED_STEPS))
    for o in outs:
        other = [p for p in outs if all(
            p["coordinate"][a] == v for a, v in o["coordinate"].items()
            if a != "ep")]
        check(all(p["moe"] == o["moe"] for p in other),
              f"M1 aux terms or dropped shares differ within the ep pair "
              f"at {o['coordinate']}")
    return res


def phase_m2(dev, card: str, seed: int, actors):
    """M2: dense GPT-J-6B width at M2_LAYERS layers on ``MeshSpec(fsdp=2,
    sp=2)``, global batch 2 x 2048 (1 row x 1024 positions a rank),
    attention through the ring over sp. P1's checks (losses, shard
    shapes), the flash kernels launched 0 times (the ring replaced
    them), and the ring's host-staged exchanges: each carries
    ``ring_step_bytes`` (2 x 1 x 1024 x 16 x 256 x 4 B), and a step makes
    3 x M2_LAYERS of them (the ring's forward, its recompute under the
    "dots" remat in the backward, and the reverse ring), printed beside
    their seconds."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    cfg = shard_model(M2_LAYERS)
    t0 = time.perf_counter()
    outs = run_on_ranks(actors, train_rank, cfg, RING_MESH, str(dev), seed,
                        M_TIMED_STEPS)
    res = train_record("M2", card, cfg, RING_MESH, outs,
                       time.perf_counter() - t0)
    per_call = ring_step_bytes(cfg, RING_MESH)
    calls = 3 * M2_LAYERS * (RING_MESH["sp"] - 1)
    ring = [[(st["calls"].get("ppermute", 0), st["bytes"].get(
        "ppermute", 0), st["seconds"].get("ppermute", 0.0))
        for st in o["collectives"]] for o in outs]
    res["ring"] = {"bytes_per_exchange": per_call,
                   "exchanges_per_step": calls,
                   "want_bytes_per_step": calls * per_call,
                   "by_rank_and_step": ring}
    print("m2 " + json.dumps(res), flush=True)
    check_train_ranks("M2", dev, outs, RING_MESH, 0)
    for i, steps in enumerate(ring):
        check(all(c == calls and b == calls * per_call
                  for c, b, _ in steps),
              f"M2 rank {i}: ring exchanges (calls, bytes, s) {steps}, not "
              f"{calls} of {per_call} B a step")
    return res


def share(t: torch.Tensor):
    """``t`` for the driver: on the card, a CUDA IPC handle (the driver
    maps this process's memory, nothing is copied; the tensor must stay
    alive until it is done), else a numpy copy."""
    if t.is_cuda:
        from torch.multiprocessing.reductions import reduce_tensor
        return reduce_tensor(t)
    return t.numpy().copy()


def shared(x, dev) -> torch.Tensor:
    """The tensor :func:`share` gave, on ``dev``."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(dev)
    rebuild, args = x
    return rebuild(*args)


def m3_rank(rank, cfg, mesh_kw, dev_str: str, seed: int, control: str):
    """M3 on one rank: one sharded loss over ``mesh_kw`` and its
    gradients, this rank's shards reduced as the step reduces them
    (summed over the data axes each leaf is replicated over), and the
    ``control``'s reduction: ``"ep"`` sums the gradients of the leaves
    that ep does not split over ep as well, ``"sp"`` leaves out the sum
    over sp. Both stay on this rank (``rank.state["m3"]``) until
    ``m3_release``; the driver reads them through :func:`share`."""
    from ray_tpu_torch.models import lm_loss, make_train_step
    from ray_tpu_torch.models.training import _paths, leaf_plans
    from ray_tpu_torch.parallel.collective import psum_tree
    from ray_tpu_torch.parallel.mesh import axis_group
    from ray_tpu_torch.parallel.sharding import FSDP_RULES, spec_axes
    dev = torch.device(dev_str)
    mesh = _rank_mesh(rank, dev_str, mesh_kw)
    bundle = make_train_step(cfg, mesh, FSDP_RULES, remat_policy="dots",
                             device=dev)
    params = bundle.init(seed + 4)["params"]
    rng = np.random.default_rng(seed + 5)
    local = bundle.local_batch({"input_ids": rng.integers(
        0, cfg.vocab_size, (SHARD_BATCH, cfg.max_seq_len))})
    plans = leaf_plans(cfg, mesh, FSDP_RULES, False)
    paths = _paths(params)
    leaves = [t.requires_grad_() for _, t in _named(params)]
    loss, _ = lm_loss(cfg, params, local, mesh=mesh, rules=FSDP_RULES)
    grads = torch.autograd.grad(loss, leaves)
    del params, leaves
    runs = {"sharded": {}, "control": {}}
    for path, g in zip(paths, grads):
        plan, name = plans[path], ".".join(path)
        mine = psum_tree(g, plan.replicated).detach().float()
        runs["sharded"][name] = mine
        if control == "ep" and not any("ep" in spec_axes(e)
                                       for e in plan.spec):
            runs["control"][name] = psum_tree(mine, axis_group(mesh, "ep"))
        elif control == "sp":
            runs["control"][name] = psum_tree(g, axis_group(mesh, tuple(
                a for a in plan.replicated.axes if a != "sp"))).float()
    del grads
    rank.state["m3"] = runs
    counts = {".".join(p): plans[p].counts for p in paths}
    return {run: {"loss": loss.item(), "counts": counts,
                  "grads": {n: share(t) for n, t in g.items()}}
            for run, g in runs.items()}


def m3_release(rank, dev_str: str):
    rank.state.pop("m3", None)
    _rank_release(torch.device(dev_str))


def phase_m3(dev, card: str, seed: int, actors):
    """M3: M1's and M2's meshes at M3_LAYERS layers against the one-device
    step from the same weights (the sharded init is a slice of the
    one-device init) and batch: the loss's relative difference and the
    gradients' relative L2 (global and worst leaf) within the M3 bounds,
    fixed before the first run; each mesh's control outside them. The
    ranks' gradients stay on the card, mapped into the driver."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    res = {"card": card, "bounds": [M3_LOSS_REL_BOUND, M3_GRAD_REL_L2_BOUND,
                                    M3_LEAF_REL_L2_BOUND]}
    for name, cfg, mesh_kw, control in (
            ("ep", moe_model(M3_LAYERS), MOE_MESH, "ep"),
            ("sp", shard_model(M3_LAYERS), RING_MESH, "sp")):
        cfg = dataclasses.replace(cfg, remat=None, remat_policy="dots")
        t0 = time.perf_counter()
        outs = run_on_ranks(actors, m3_rank, cfg, mesh_kw, str(dev), seed,
                            control)
        try:
            loss_ref, ref, specs = one_device_grads(cfg, seed, dev)

            def got(o, run, n):
                grads = o[run]["grads"]
                return shared(grads[n] if n in grads
                              else o["sharded"]["grads"][n], dev)
            read = {run: grad_errors(outs, run, ref, loss_ref, specs,
                                     mesh_kw, got)
                    for run in ("sharded", "control")}
            del ref
        finally:
            gc.collect()
            run_on_ranks(actors, m3_release, str(dev))
        rec = {"config": f"gptj-6b n_layers={M3_LAYERS}" + (
            f" n_experts={cfg.n_experts}" if cfg.n_experts else ""),
            "mesh": mesh_kw, "loss_one_device": loss_ref,
            "sharded": read["sharded"],
            "control": {k: read["control"][k] for k in (
                "loss", "loss_rel", "grad_rel_l2", "worst_leaf",
                "worst_leaf_rel_l2")}, "wall_s": time.perf_counter() - t0}
        res[name] = rec
        print(f"m3 {name} " + json.dumps(rec), flush=True)
        k, ctl = read["sharded"], read["control"]
        check(k["loss_rel"] <= M3_LOSS_REL_BOUND,
              f"M3 {name} loss rel {k['loss_rel']} > {M3_LOSS_REL_BOUND}")
        check(k["grad_rel_l2"] <= M3_GRAD_REL_L2_BOUND,
              f"M3 {name} grad rel L2 {k['grad_rel_l2']} > "
              f"{M3_GRAD_REL_L2_BOUND}")
        check(k["worst_leaf_rel_l2"] <= M3_LEAF_REL_L2_BOUND,
              f"M3 {name} leaf {k['worst_leaf']} grad rel L2 "
              f"{k['worst_leaf_rel_l2']} > {M3_LEAF_REL_L2_BOUND}")
        check(ctl["grad_rel_l2"] > M3_GRAD_REL_L2_BOUND
              or ctl["worst_leaf_rel_l2"] > M3_LEAF_REL_L2_BOUND,
              f"M3 {name}: the control's gradients (rel L2 "
              f"{ctl['grad_rel_l2']}, worst leaf "
              f"{ctl['worst_leaf_rel_l2']}) pass the bounds")
    return res


def moe_ring_phases(dev, card: str, seed: int):
    """M1-M3 on a runtime of their own, after P1-P3; the card's free
    memory must come back after them. Returns their records."""
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    n = MOE_MESH["fsdp"] * MOE_MESH["ep"]
    ray_tpu_torch.init(num_cpus=8, num_gpus=torch.cuda.device_count(),
                       _num_initial_workers=0)
    out = {}
    try:
        actors = start_ranks(n, "gloo", group_name="moe-ring",
                             num_gpus=1.0 / n if dev.type == "cuda"
                             else 0.0)
        try:
            for name, phase in (("M1", phase_m1), ("M2", phase_m2),
                                ("M3", phase_m3)):
                t1 = time.perf_counter()
                out[name] = phase(dev, card, seed, actors)
                print(f"phase {name} wall: {time.perf_counter() - t1:.1f} s",
                      flush=True)
        finally:
            stop_ranks(actors)
    finally:
        ray_tpu_torch.shutdown()
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(f"phases M1-M3 wall: {time.perf_counter() - t0:.1f} s; card "
          f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f} GB "
          f"after", flush=True)
    check(free1 >= free0 - (1 << 30),
          "M1-M3's card memory did not come back")
    return out


# ----------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
    server, checksum, paged = serving_phases(dev, card, args.seed)
    kernels = [paged]
    torch.cuda.empty_cache()
    print(f"released serving: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB still allocated", flush=True)
    r3 = runtime_phases(dev, card, args.seed, server, checksum)
    paged["actor_launches"] = r3["paged_launches"]
    served = serve_phases(dev, card, args.seed, server, r3, checksum)
    paged["serve_launches"] = served["S1"]["paged_launches"]
    paged["disagg_launches"] = served["S2"]["prefill_launches"] \
        + served["S2"]["decode_launches"]
    rl = rlhf_phases(dev, card, args.seed)
    paged["rlhf_launches"] = {name: rl[name]["paged_launches"]
                              for name in ("RL1", "RL2")}
    flash = training_phases(dev, card, args.seed)
    for rec in flash:
        rec["rlhf_learner_launches"] = {
            "RL1": rl["RL1"]["flash_launches"][rec["name"]],
            "RL2": [n[rec["name"]] for n in rl["RL2"]["learner_launches"]]}
    kernels.extend(flash)
    sharded = sharding_phases(dev, card, args.seed)
    moe_ring = moe_ring_phases(dev, card, args.seed)
    for rec in flash:
        rec["sharded_launches"] = [r["launches"][rec["name"]]
                                   for r in sharded["P1"]["ranks"]]
        rec["moe_launches"] = [r["launches"][rec["name"]]
                               for r in moe_ring["M1"]["ranks"]]
        rec["ring_launches"] = [r["launches"][rec["name"]]
                                for r in moe_ring["M2"]["ranks"]]

    print(f"total wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
