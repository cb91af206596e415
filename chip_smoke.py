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
S2. The disaggregated pair, on a runtime of its own that every later
   phase shares (RL1, 7-10 and P1 onwards):
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
   rollout engine at GPT-J-6B width cut to 1 of 28 layers (f32 masters,
   gradients and Adam take 9.8 GB; the engine's bf16 weights, a staged
   copy and the pool about 3 GB more), bf16 compute, random weights from
   the seed; a seeded 256-token system prompt and 32-token suffixes, 64
   new tokens, 16 rollouts a round on 16 decode slots (32-token blocks,
   256-token chunks, a 384-token window), minibatches of 4, one round
   (most of a round's host time is its publish: the numpy int8 pack and
   unpack of 0.61 B weights).
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
   ``unpack_weights(pack_weights(w))``, farther from version 0's. Paged
   launches 1 x the engine's prefill chunks and decode steps, each flash
   kernel 1 x ``compute_gradients`` calls. Round,
   rollout, update and publish walls, wire bytes, pack/unpack host time,
   peak memory.
RL2. RLHF, sebulba, on S2's runtime (its learners fork from the zygote
   S2's first spawn booted; its store at least 6 f32 weight trees of
   RL2's model): 2 remote learners (each
   ``{"num_cpus": 1}``, on the card through ``device=None`` in its
   worker) and 2 engines in the driver at 1 layer; 8 rollouts, one
   gradient round of 4 rows a learner, one round. Both learners used on
   disjoint shards, their weights bit-identical after the round (sha256),
   a publish through the store with no sync stall and staleness <= 1,
   each learner's flash launches 1 x its ``compute_gradients`` calls,
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
P1. Sharding, on the runtime S2-JC1 share: four rank
    actors (``num_gpus=0.25`` each, all on this card) joined into one
    gloo group through
    ``init_torch_distributed``, each building ``MeshSpec(fsdp=2, tp=2)``
    (``__graft_entry__._factor_mesh(4)``) and ``make_train_step`` at
    GPT-J-6B width cut to P1_LAYERS layer under ``FSDP_RULES``, remat
    ``"dots"``, lr 1e-4, global batch 2 x 2048 (one row a data rank),
    one warm-up and 1 timed step. Losses finite, equal on every rank and
    falling; each rank launched each flash kernel 1 x steps (at 8 heads,
    its tp half); each rank's shard shapes are ``FSDP_RULES``'; leaves
    replicated over tp bit-identical across each tp pair. Step wall,
    tokens/s, MFU, each rank's peak memory, and the wall split into
    compute and collectives (``CollectiveClock`` wraps the collective
    layer's one entry into torch.distributed in each rank).
P2. The sharded step against the one-device step at 1 layer, 1 x 2048 a
    data rank, same weights (the sharded init is a slice of the
    one-device init) and batch: loss and gradients (each rank's shards
    against the slices of the one-device gradients; global and worst-leaf
    relative L2) within P2's bounds, a faulty control (wk/wv's gradients
    not summed over tp) outside them; then 2
    steps with ``grad_transport="int8"`` and ``shard_weight_update``
    within JAX's bound (1e-2) of 2 fp32 sharded steps, the int8 bytes the
    scatter legs sent equal to ``tree_wire_bytes`` of what the step
    reduces.
P3. NCCL at world size 1: a rank actor (``num_gpus=1``) runs
    ``init_torch_distributed(backend="nccl")`` and every eager op of the
    collective layer on a CUDA tensor; each result equals its input (the
    quantized ones the input's two-leg round trip) on ``cuda:0``. The card's
    free memory comes back after the group.
M1. Mixture-of-experts over ep, on P1-P3's runtime (its ranks forked
    from the zygote P1's first spawn booted) with four rank actors as
    P1's: ``make_train_step`` at GPT-J-6B width with 4 experts
    a layer (Switch top-1, capacity factor 1.25, aux weight 0.01; built
    here with ``dataclasses.replace``) at 1 layer on ``MeshSpec(fsdp=2,
    ep=2)``, global batch 2 x 2048, one warm-up and 1 timed step. P1's
    checks, each flash kernel launched 1 x steps a rank (at 1 row x 16
    heads), the leaves ep does not split bit-identical across each ep
    pair, each layer's dropped share printed and equal within each ep
    pair.
M2. Ring attention over sp: dense GPT-J-6B width at 1 layer on
    ``MeshSpec(fsdp=2, sp=2)``, 1 row x 1024 positions a rank, one
    warm-up and 1 timed step. P1's checks, the flash kernels launched 0
    times, and the ring's exchanges (host-staged: gloo takes no CUDA
    send) 3 x 1 a step of 2 x 1 x 1024 x 16 x 256 x 4 B each, with their
    seconds.
M3. Gradients against one device at 1 layer on M1's and M2's meshes,
    the ranks' shards mapped into the driver (CUDA IPC): loss relative
    difference and gradient relative L2 (global, worst leaf) within M3's
    bounds, each mesh's control (the ep one sums the leaves ep does not
    split over ep as well, the sp one leaves out the sum over sp)
    outside them. The card's free memory comes back after M1-M3.
PL1. Pipelines, on P1-P3's runtime: ``ParallelPlan(pp=2,
    n_microbatches=4).build`` at GPT-J-6B width and 4 layers (two stage
    actors of 2 layers sharing the card, ``num_gpus=0.5`` each; their
    activations and gradients cross the object store), global batch 4 x
    2048, one warm-up and 3 timed steps: step wall, tokens/s, MFU over one
    card, the measured bubble beside the analytic 0.2, each stage's busy,
    idle, forward, backward and optimizer seconds in the first and the
    last step, the hops' bytes and seconds, each stage's peak memory.
    Losses finite and falling, each flash kernel launched 8 times a stage
    a step, and no gradient reaching the driver (the bytes it takes a
    step).
PL2. PL1 interleaved (``virtual=2``), 2 timed steps: the same checks,
    the analytic bubble 1/9, the first loss equal to PL1's.
PL3. At 2 layers, ``ParallelPlan(pp=2)``'s pipeline: its first step,
    the optimizer off, against the one-device loss and gradients (P2's
    bounds), a control seeding every microbatch's backward with 1
    outside them (the gap of its gradients' norm to the one-device norm,
    a lower bound of their distance, already passes the bound); then a
    step, its checkpoint, and the next step: the checkpoint loaded back
    into the pipeline and into the one-device plan gives the same next
    loss.
PL4. ``pipeline_apply`` over MeshSpec(pp=4) on four rank actors
    (``num_gpus=0.25``, gloo), one GPT-J-6B-width layer a rank, x 4 x
    2048 x 4096 bf16, M=4: output and gradients against the sequential
    layers on one device with the all-reduce-backward control outside;
    each flash kernel launched 7 times a rank (garbage ticks included);
    the exchanges' host-staged bytes and seconds. The card's free memory
    comes back after PL1-PL4.
PL5. The nested ``mpmd3d`` pipeline, PL5, PL6 and EL1 on P1-P3's
    runtime (their actors fork from the zygote P1's first spawn booted)
    with the card's free memory back after each:
    ``MPMDPipeline(n_stages=2, dp=2, n_microbatches=4, train=False)`` at
    2 layers, four rank actors (``num_gpus=0.25``; each stage's pair in
    a gloo group), a seeded 8 x 2048 batch (one row a rank a
    microbatch): the loss and the stages' reduced gradients against the
    one-device step on the same weights (P2's bounds), a control that
    seeds each rank with n_i / N without its share n_loc / n_mb outside
    them with its gradient norm about twice the reference's; each rank's
    f32 reduction bytes and seconds; each flash kernel launched 4 times a
    rank.
PL6. ``ParallelPlan(pp=2, dp=2, n_microbatches=4, grad_transport="int8",
    shard_weight_update=True)`` at 4 layers (two a stage), one warm-up
    and one timed step: PL1's record and checks (8 launches a kernel a
    rank a step),
    each rank's int8 reduction seconds and wire bytes under a third of
    its f32 gradient's, its Adam bytes about half the plain layout's,
    the params of a stage's two ranks bit-identical (sha256) after the
    last step.
EL1. ``ElasticTrainer(ParallelPlan(pp=2, dp=2, n_microbatches=4),
    snapshot_interval=8)`` at 2 layers with a ``SliceManager`` over an
    in-memory ``FakeSliceProvider`` sending its drain notice, beside the
    one-device ``ParallelPlan()`` from the same weights: 2 steps, a
    maintenance notice (the slice drains and is released), step 3
    folding live to pp=2 x dp=1 (0 steps lost), step 4, a stage actor
    killed while step 5 runs (recovered on the same grid from the fold's
    snapshot, steps 3-4 replayed: 3 lost). Every loss within
    P2's loss bound of the one-device plan's; the two recoveries'
    triggers, plans, steps lost and seconds; SLICE_DRAIN, SLICE_DOWN
    and the four ELASTIC_* events; each program's flash launches.
RLL1. rllib's PPO on the runtime P1-EL1 share: ``PPOConfig()`` on the gym-free
    ``RandomEnv(obs_dim=8, n_actions=4)`` with 2 env-runner actors (their
    policies on the CPU, by design), hiddens (256, 256) (RLlib's
    ``MODEL_DEFAULTS``), otherwise the JAX package's defaults (train batch
    4000, minibatch 128, 8 epochs, lr 3e-4, grad clip 0.5), the learner
    on the card: 2 iterations, then one with ``streaming_rollouts``. Every
    learner tensor on ``cuda:0``, metrics finite, 256 updates an
    iteration; the runners hold the learner's weights (sha256) after each
    iteration; ``save`` before the streamed iteration and ``restore``
    after it give back the saved weights bit for bit, on the runners too;
    iteration 2's first update repeated on the CPU from the card's state
    before it: the loss within 1e-5 relative, the parameters' update
    within 1e-3 relative L2, the CPU's update on the next minibatch (the
    control) outside it. Env steps/s, sampling share, learner ms an
    update (CUDA events), peak memory.
RLL2. On the same runtime, one iteration each of PG, IMPALA, APPO and
    multi-agent PPO (two policies over two ``RandomEnv`` agents) at
    RLL1's env and width, the learners on the card; V-trace on the card
    against the CPU on APPO's batch within 1e-5; then a ``LearnerGroup``
    of 2 remote learners (0.5 of the card each) updated once on 512 rows:
    the replicas bit-identical (sha256), the update within 1e-3 relative
    L2 of one learner's on the whole batch, one learner's on the first
    half (the control) outside it.
RLL3. On the same runtime, rllib's off-policy and offline learners at
    RLL1's width, on the card, the JAX package's defaults otherwise:
    ``DQNConfig()`` with 2 runner actors on ``RandomEnv`` past learning
    starts to 504 updates (its target equal to the online params bit for
    bit after update 500, unmoved at 501); discrete SAC on
    ``RandomEnv`` and continuous SAC on a numpy ``Pendulum``
    (gymnasium's ``Pendulum-v1`` dynamics), and TD3 on it, 2 iterations
    past learning starts (the targets at their polyak step within 1e-6,
    TD3's policy and its Adam count still across an odd update and moved
    across an even one); ``update_many(8)`` against 8 single updates
    within 1e-6; ``JsonWriter`` files of both envs read back bit for
    bit, then CQL (Pendulum), BC and MARWIL (``RandomEnv``) 2 iterations
    each, IS with the behaviour policy as target within 1e-6 of the
    behaviour value, WIS, and DM and DR over FQE trained on the card.
    Update 2 of DQN, continuous SAC, TD3 and CQL repeated on the CPU
    from the card's state with the card's minibatch and draws: the loss
    within 1e-5 relative, the update within 1e-3 relative L2, update 3's
    (the control) outside it. Env steps/s, learner ms an update (CUDA
    events), the burst's ms, peak memory (the ``rll3`` line).
TR1. ``TorchTrainer`` on the same runtime: two workers (``GPU`` 0.5
    each, both on this card, one gloo process group formed by
    ``TorchConfig(backend="gloo")``) build ``make_train_step`` at
    GPT-J-6B width cut to TR_LAYERS layers over ``MeshSpec(fsdp=2)``,
    global batch 2 x 2048 seeded by the step (tokens from an eighth of
    the vocabulary), steps 0-2. After step 0 rank 0 reports the
    gathered params and Adam moments through ``Checkpoint.from_torch``
    (``num_to_keep=1``); on the first attempt rank 1 writes its death
    time and exits after the step-2 update; the trainer restarts the
    gang from the step-0 checkpoint (``max_failures=1``) and steps 1-2
    run again. No error, one restart, the re-run steps' losses within
    TR_RESUME_REL of the killed attempt's (step 1's reads the restored
    params, step 2's the restored Adam state through step 1's update),
    losses equal on both ranks and falling,
    every worker on ``cuda:0``, each flash kernel launched TR_LAYERS x
    the attempt's steps on each rank of each attempt, the final
    checkpoint loading back through ``Checkpoint.to_torch`` with its
    step. Fit wall, gang start (spawn and rendezvous) first and after
    the restart, each step's wall and tokens/s, the checkpoint's GB and
    its gather, write and copy seconds, restart seconds (death to the
    first step after), peak GB a rank (the ``tr1`` line).
TN1. ``Tuner`` over a ``TorchTrainer`` of one worker (``GPU`` 0.5)
    sweeping lr over TN_LRS with ``grid_search``: each trial trains
    GPT-J-6B width at TN_LAYERS layer, 1 x 2048, TN_STEPS steps and
    reports its loss a step. No error, two trials, the best result the
    trial with the lower last loss, world size 1, each trial on
    ``cuda:0`` with each flash kernel launched TN_LAYERS x TN_STEPS
    times. Fit wall, each trial's wall and first step, whether the
    trials overlapped in time (the ``tn1`` line).
D1. ``ray_tpu_torch.data`` into a ``TorchTrainer`` on the same runtime:
    ``range(6, parallelism=3)`` -> ``map_batches`` (each row's 2048
    tokens ``tr_batch``'s for the row's id, the ``id`` kept) ->
    ``random_shuffle(seed=...)``, passed as ``datasets={"train": ...}``
    to two workers (``GPU`` 0.5 each, gloo) at GPT-J-6B width and
    D1_LAYERS layer over ``MeshSpec(fsdp=2)``; each worker steps on one
    row of its ``streaming_split`` shard at a time
    (``iter_batches(batch_size=1)``), its rows of the global batch. The
    fit returns within D1_FIT_S with no error, every id consumed once and
    3 a rank, each rank's row bit-equal to the one rebuilt from its id,
    the losses equal on both ranks, finite and falling, step 0's loss
    within P2_LOSS_REL_BOUND of a one-device step from the same initial
    state on the two ranks' rows in rank order, each flash kernel
    launched D1_LAYERS x 3 times a rank on ``cuda:0``, the store's live
    GB back within 0.1 GB. Fit wall, the pipeline's wall to the first
    batch, each step's wall, the rows' bytes (the ``d1`` line).
TN2. ``PopulationBasedTraining`` on the same runtime: two trials of a
    class ``tune.Trainable`` (``GPU`` 0.5 each) at lr TN2_LRS, each
    holding a one-device GPT-J-6B train state at TN2_LAYERS layer;
    synchronous rounds every 2 iterations, the bottom half exploiting
    the top half (the whole state, params and Adam moments, through
    ``Checkpoint.from_torch``), its lr moved to a neighbour in
    TN2_MUTATIONS; a trial stops once its state has taken TN2_STEPS
    steps; no save at a trial's end. At least one exploit, the target's
    state after the restore bit-equal (checksums on the card) to what
    the source saved, the target's lr a neighbour of the source's, its
    next loss bit-equal to the source's from the same state and batch,
    the restore's peak within one state and TN2_LOAD_SLACK_GB, each
    flash kernel launched TN2_LAYERS x the steps of each trial actor.
    Fit wall, each save's and restore's seconds and GB, each trial's
    losses, step walls and peak GB (the ``tn2`` line).
DG1. A compiled DAG on the same runtime: ``InputNode -> s0.forward ->
    s1.loss`` over two stage actors (``GPU`` 0.5 each), each holding its
    ``stage_slice_params`` slice of the seeded GPT-J-6B-width model at
    DG_LAYERS layers (one a stage, bf16) on ``cuda:0``; stage 0 returns
    ``(stage_forward(...), input_ids)``, stage 1 ``stage_loss``'s loss
    and count, both under ``torch.inference_mode()``; the DAG's
    ``channel_capacity`` is a hop's pickled size (1 x 2048 x 4096 bf16
    and the ids). ``experimental_compile()``, then DG_ROWS rows of 2048
    tokens seeded as ``tr_batch`` seeds them, all submitted before the
    first ``get``. The channel pipeline was built (an RPC fallback
    fails), each loss is bit-equal to the two stage functions run here
    on ``cuda:0`` from the same seed and row, finite, and ``get`` gives
    it as a CPU tensor; the flash forward launched DG_ROWS times a stage
    on ``cuda:0`` and the backward kernels not at all; after
    ``teardown()`` no channel file is left in ``/dev/shm``, both actors
    are dead and the store's live GB is back within 0.1 GB. The first
    execute's wall, each later one's, a hop's bytes (the ``dg1`` line).
JC1. A job and a ``ray://`` client on the same runtime: a
    ``ClientServer`` on port 0, the dashboard's address from the
    session's ``dashboard.json``, then at once a job submitted through
    ``JobSubmissionClient`` (its driver's ``init()`` finds the cluster
    in its environment and runs one ``num_gpus=0.5`` task calling the
    flash forward's wrapper at GPT-J-6B's attention shape, 1 x 2048 x 16
    x 256 bf16 causal, on seeded inputs), a client process that creates
    a ``num_gpus=0.5`` actor running the same kernel on the same inputs
    and ``get``s the 16 MB output, and a second job (a 600 s sleep)
    stopped once it runs. The first job SUCCEEDED and the second STOPPED
    within JC_JOB_S, the stopped job's processes gone; the job's
    checksum equals the driver's own launch's, the client's tensor is
    bit-equal to the driver's output and a CPU tensor; each remote
    process launched the kernel once on ``cuda:0``;
    ``/api/cluster_status`` lists ``GPU`` 1.0; after the client
    disconnects its actor is released and a ``num_gpus=1`` task runs.
    Submit to SUCCEEDED, connect to first result and the phase's wall
    (the ``jc1`` line). A task that finds no card fails the phase.
AR1. Serving and training share the card on the same runtime, and the
    slice arbiter moves the slice: a ``SliceManager`` over an in-memory
    ``FakeSliceProvider`` with two slice types (a host each, ``GPU``
    0.5), a ``SliceArbiter`` with no ``gauges_fn`` (it reads the live
    metrics plane) at the JAX colocation test's policy (AR_POLICY); the
    serve slice claimed ``kind="serve", priority=10`` holds one
    ``serve.run`` ``LLMServer`` replica (no ``GPU`` reserved) at
    GPT-J-6B width and AR_LAYERS layer with S1's knobs, the train slice
    claimed ``kind="train", priority=0`` an ``ElasticTrainer(
    ParallelPlan(dp=2))`` at AR_LAYERS layer, AR_ROWS x 2048, with the
    slice manager and a ``slice_filter``, telemetry at its default
    interval, beside the one-device ``ParallelPlan()`` from the same
    weights. Two steps; phase 4's 16 prompts over HTTP, request 0 first,
    held at ``gate_burst``'s gate while the arbiter (updated every
    AR_TICK_S) sees the engine's own queue depth at or above 4 past
    ``sustain_s`` and preempts the train slice; the gate opens; the
    trainer folds to dp=1 at its next step; the burst drains, each
    prompt is served alone, the slice is released and, the queue at or
    below 1 past ``ebb_s``, a slice is returned; the next step regrows
    to dp=2, then one more. Every loss within EL1_LOSS_REL of the
    one-device plan's, the recoveries' triggers and plans, one
    preemption (reason ``queue-depth``) and one return with their
    ``ARBITER_*`` events, only the serve and the regrown train slice
    UP, ``/api/v0/arbiter`` listing both claims, the trainer's rank 0
    fleet row with ``train_tokens_per_s`` above 0 and the replica's with
    a queue depth of at least 4 during the burst, the burst's streams
    equal the single-request ones or leave them at a confirmed near
    tie, the replica's paged launches AR_LAYERS a prefill chunk and
    decode step, each flash kernel AR_LAYERS a step on each rank of
    each dp=2 program and in the driver. Pressure to the drain notice,
    the notice to the folded step, the return to the regrown step, the
    burst's TTFT (the ``ar1`` line).
WF1. A durable workflow on the card on the same runtime: q, k, v at
    GPT-J-6B's attention shape drawn from the seed -> the flash forward
    -> a reduce, each a ``num_gpus=0.5`` task; the reduce raises on its
    first attempt (a marker file under the workflow's storage), the run
    ends FAILED and ``workflow.resume`` runs the reduce only: the flash
    step ran once (its launch log unchanged), the stored output
    bit-equal to a straight ``workflow.run`` of the same DAG and to the
    driver's own flash forward, ``get_status`` SUCCESSFUL, ``list_all``
    listing it until ``delete``, a ``TimerListener`` event step
    completing (the ``wf1`` line).
CL1. The command line on the card's host, beside AR1 and WF1 on a
    thread of its own (its clusters are runtimes of their own; AR1's
    and WF1's times and its rates are taken under each other's load):
    ``python -m ray_tpu_torch.scripts.cli`` ``up -y`` on a cluster YAML
    for the local launcher (a head counting the card, whose slice
    monitor brings up one one-host slice), ``submit`` of a script
    running the flash forward in a ``num_gpus=0.5`` task,
    ``job submit``/``job status``, ``status`` and ``list nodes`` (two
    nodes alive, one a slice host), ``down -y``: then the head's process
    group and every process of the cluster are gone, and none holds the
    card; then ``microbenchmark`` at its default counts on a runtime of
    its own, its PPO learner on the card where ``gymnasium`` is
    installed (its JSON lines in the record, one a ``BASELINES`` key at
    least) (the ``cl1`` line).

Before them the script's ``phase walls`` line (the build's wall, each
phase's and the total, CL1's overlapping AR1's and WF1's, their group
``AR1-CL1``; around each phase on the shared runtime the
store's live GB, the driver's resident GB outside the store's segment
and the segment's pages resident in the driver, EL1's store held to
within 0.1 GB of its value before) and its total wall are printed. The second-to-last line
is the ``{"kernels": [...]}`` record (the paged kernel's carries the
verify shape's ``verify_*`` fields, R3's ``actor_launches``, S1's
``serve_launches``, S2's ``disagg_launches``, both replicas', and RL1's
and RL2's ``rlhf_launches``, AR1's replica's ``arbiter_launches``;
each flash kernel's carries RL1's and each RL2
learner's ``rlhf_learner_launches``, each P1 rank's
``sharded_launches``, each M1 rank's ``moe_launches``, each M2 rank's
``ring_launches``, each PL1 and PL2 stage's ``pipeline_launches``,
each PL4 rank's ``gpipe_launches``, each PL5 and PL6 rank's
``mpmd3d_launches``, each rank of each program EL1 built
``elastic_launches``, each TR1 rank's, each TN1 trial's, each D1
rank's and each TN2 trial actor's ``trainer_launches``, each DG1
stage's ``dag_launches``, JC1's job task's ``job_launches`` and
client actor's ``client_launches``, AR1's ranks' and driver's
``arbiter_launches``, WF1's flash steps' ``workflow_launches`` and
CL1's submitted task's ``cli_launches``); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import shlex
import subprocess
import sys
import time
import weakref

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
#: each phase's wall in seconds, in run order, and the walls of the
#: groups that share a runtime (the ``phase walls`` line)
WALLS: dict = {}
GROUP_WALLS: dict = {}
#: GB the runtime's object store holds (live objects) before and after
#: each phase that :func:`on_own_runtime` runs; the driver's resident GB
#: outside the store's shared segment before it, after it, and after the
#: C allocator gave its free pages back (``malloc_trim``: what remains is
#: live); and the segment's pages resident in the driver's mapping before
#: and after it (tmpfs pages a freed object leaves for the next to reuse)
STORE_GB: dict = {}
DRIVER_GB: dict = {}
SEGMENT_GB: dict = {}


def malloc_trim() -> None:
    """Hand the C allocator's free heap pages back to the system."""
    import ctypes
    import ctypes.util
    try:
        ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    except (OSError, AttributeError):
        pass


def resident_gb():
    """(the driver's resident GB outside the object store's shared
    segments, the segments' resident GB in its mappings), from
    ``/proc/self/smaps``; (its whole resident set, 0.0) where that cannot
    be read."""
    import psutil
    own = seg = 0
    try:
        with open("/proc/self/smaps") as f:
            path = ""
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if not parts[0].endswith(":"):       # a mapping's header
                    path = parts[5] if len(parts) > 5 else ""
                elif parts[0] == "Rss:":
                    if path.startswith("/dev/shm/raytorch-"):
                        seg += int(parts[1])
                    else:
                        own += int(parts[1])
    except (OSError, ValueError, IndexError):
        return psutil.Process().memory_info().rss / 1e9, 0.0
    return own * 1024 / 1e9, seg * 1024 / 1e9


def phase_wall(name: str, t0: float, group: bool = False) -> str:
    """Records the wall of phase (or group of phases) ``name`` since
    ``t0`` and returns its printed form."""
    s = time.perf_counter() - t0
    (GROUP_WALLS if group else WALLS)[name] = round(s, 1)
    return f"phase{'s' if group else ''} {name} wall: {s:.1f} s"

def walled(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall recorded as phase ``name``'s."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    WALLS[name] = round(time.perf_counter() - t0, 1)
    return out


@contextlib.contextmanager
def runtime(object_store_memory=None):
    """The runtime the phases inside run on: the running one where a
    caller shares one across phases (their later programs' actors then
    fork from the zygote the first program booted), else a fresh one
    (the card counted as ``GPU``, no initial worker, the store
    ``object_store_memory`` bytes where given), shut down after them."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        yield
        return
    ray_tpu_torch.init(num_cpus=8, num_gpus=torch.cuda.device_count(),
                       _num_initial_workers=0,
                       object_store_memory=object_store_memory)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()



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


def gate_burst(engine, n: int, hold=None) -> None:
    """Phase 4's burst, made exact for an engine stepping on its own
    thread: at the first step boundary after a request has its first
    token, the step thread waits until ``n`` requests are pending, so
    that one admission takes the whole burst however its requests arrive
    (15 streaming actor calls reach R3's engine one at a time). With
    ``hold``, it then also waits while ``hold()`` is true, publishing the
    engine's stats (its queue depth among them) every AR_TICK_S, and the
    first step after it publishes again. The gate opens once and removes
    itself."""
    inner = engine._step

    def step():
        if any(r is not None and r.generated for r in engine._slots):
            with engine._work:
                arrived = engine._work.wait_for(
                    lambda: len(engine._pending) >= n, ACTOR_TIMEOUT_S)
            del engine._step               # the class's method again
            if not arrived:
                raise SmokeFailure(f"a burst of {n} requests never arrived")
            if hold is not None:
                deadline = time.monotonic() + ACTOR_TIMEOUT_S
                while hold() and time.monotonic() < deadline:
                    engine._emit_stats(interval_s=0.0)
                    time.sleep(AR_TICK_S)
                engine._last_stats_emit = 0.0
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
    """Holds a worker (the first one's spawn starts the zygote)."""

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
    """The node starts its zygote at the first spawn past its initial
    pool, and spawns that find it booting wait for it. With no initial
    or prestarted worker, three holder actors are spawns 1-3: wait until
    the zygote listens, so every later spawn is a fork, and until every
    cold worker (one a spawn that gave up waiting would boot) is held.
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
    print(phase_wall("R1", t0), flush=True)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    actor = None
    try:
        t0 = time.perf_counter()
        phase_runtime(dev, card, cfg, seed)
        print(phase_wall("R2", t0),
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
    print(phase_wall("R3", t0) + f"; card memory "
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
                 checksum, names=("S1", "S2")):
    """Phases ``names`` of S1-S2, after R3, each with an HTTP proxy, on
    the caller's runtime where it shares one (one phase a runtime: serve
    does not start again on a runtime it was shut down on), else each on
    a runtime of its own; ``serve.shutdown`` kills the replicas after
    each (and the runtime is shut down where it is the phase's own), and
    the card's free memory must come back. Returns the phases'
    records."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import get_config
    cfg = get_config("gptj-6b")
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    out = {}
    phases = {"S1": phase_serve_http, "S2": phase_disagg}
    for name in names:
        phase = phases[name]
        t0 = time.perf_counter()
        with runtime():
            try:
                serve.start(http_options={"port": 0})
                out[name] = phase(dev, card, cfg, seed,
                                  serve.proxy_address(), server,
                                  actor_server, checksum)
            finally:
                serve.shutdown()
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
                and time.monotonic() < deadline:
            time.sleep(0.5)
        free1 = torch.cuda.mem_get_info()[0]
        print(phase_wall(name, t0) + f"; card "
              f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f}"
              f" GB after serve.shutdown", flush=True)
        check(free1 >= free0 - (1 << 30),
              f"{name}'s replicas' card memory did not come back")
    return out


# ------------------------------------------------------------- RL1, RL2
RL_SYSTEM = 256       # tokens of the system prompt every rollout shares
RL_SUFFIX = 32        # tokens of each rollout's own suffix
RL_NEW = 64           # tokens each rollout generates
RL1_LAYERS = 1        # 8, then 2, until the 900 s budget; 28: 97 GB of state
RL2_LAYERS = 1        # each learner's f32 grads cross the store both ways
#                       (2 until the 900 s budget)
RL1_ROUNDS = 1        # each round ends in a publish: numpy int8 pack/unpack
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
            "prompt_blocks_total", "rewarm_blocks",
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
    """RL1: anakin, one local learner, one engine, GPT-J-6B width at
    RL1_LAYERS layers, 16 rollouts a round, ``RL1_ROUNDS`` rounds. Every round: 16
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
                                        "rewarm_blocks",
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


def rl2_store_bytes() -> int:
    """RL2's store: 6 f32 weight trees of its model."""
    return 6 * 4 * rl_model(RL2_LAYERS).num_params


def store_capacity() -> int:
    """Bytes the running runtime's object store was given."""
    from ray_tpu_torch import api
    return api._head.node.store.capacity


def phase_rl2(dev, card: str, seed: int):
    """RL2: sebulba, 2 remote learners (``{"num_cpus": 1}`` each, on the
    card through ``device=None`` in their workers), 2 engines in the
    driver, GPT-J-6B width at RL2_LAYERS layers, 8 rollouts, one
    gradient round of 4 rows a learner, one round, on a runtime whose
    store holds 6 f32 weight trees (its own, sized so), or on the
    caller's where it shares one (its store at least that). Two learners used on disjoint
    shards, their weights bit-identical after the round, a publish, no
    sync stall, staleness <= 1, each learner's flash launches RL2_LAYERS
    x its ``compute_gradients``
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
    with runtime(rl2_store_bytes()):
        check(store_capacity() >= rl2_store_bytes(),
              f"RL2's store holds {store_capacity()} B, under 6 f32 weight "
              f"trees ({rl2_store_bytes()} B)")
        trainer = None
        try:
            t0 = time.perf_counter()
            trainer = RLHFTrainer(rc)
            build_s = time.perf_counter() - t0
            streams = watch_streams(trainer.rollout)
            actors = trainer.learners._remote
            ready = ray_tpu_torch.get(
                [a.__ray_call__.remote(learner_ready) for a in actors],
                timeout=ACTOR_TIMEOUT_S)
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
            after = ray_tpu_torch.get(
                [a.__ray_call__.remote(learner_after) for a in actors],
                timeout=ACTOR_TIMEOUT_S)
            shard_uids = [list(u) for u in trainer.learners.shard_uids]
            round_walls = list(trainer.learners.round_walls)
            pub = trainer.publisher.stats()
            rec = round_record(out, wall, streams[0])
        finally:
            if trainer is not None:
                trainer.shutdown()
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
        print(phase_wall(name, t0) + f"; card "
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
    WALLS["build"] = round(time.perf_counter() - t0, 1)
    print(f"build: {len(SOURCES)} libraries loaded in "
          f"{time.perf_counter() - t0:.2f} s (wall)", flush=True)


def serving_phases(dev, card: str, seed: int):
    """Phases 3-6d on GPT-J-6B's serving weights (bf16, 12 GB); the
    weights are released when this returns. Returns the paged kernel's
    record, phase 4's numbers and streams, and the weights' checksum
    (phase R3's references)."""
    from ray_tpu_torch.models import get_config, init_params
    shapes = walled("3", phase_kernels, dev)
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
    server = walled("4", phase_server, dev, card, cfg, params, seed)
    walled("5", phase_e2e, dev, cfg, params, seed)
    walled("6", phase_profile, dev, cfg, params, seed)
    walled("6a-6d", serving_features, dev, card, cfg, params, seed)
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
    flash = walled("7", phase_flash_kernels, dev)
    trainer, bundle, state, batch = walled("8", phase_trainer, dev, card,
                                           seed)
    walled("10", phase_train_profile, bundle, state, batch,
           trainer["step_ms"])
    del bundle, state, batch
    torch.cuda.empty_cache()
    walled("9", phase_train_e2e, dev, seed)
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
P1_LAYERS = 1                       # 4, then 2, until the 900 s budget
P1_TIMED_STEPS = 1                  # 3, then 2, until the 900 s budget
P2_LAYERS = 1                       # 2 until the 900 s budget
P2_STEPS = 2                        # 3 until the 900 s budget
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
    """P1-P3 after the training phases, on a runtime of their own or the
    one the caller shares; the card's free memory must come back after
    them. Returns their records."""
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    n = SHARD_MESH["fsdp"] * SHARD_MESH["tp"]
    out = {}
    with runtime():
        actors = start_ranks(n, "gloo", group_name="shard",
                             num_gpus=1.0 / n if dev.type == "cuda"
                             else 0.0)
        try:
            out["P1"] = phase_p1(dev, card, seed, actors)
            out["P2"] = phase_p2(dev, card, seed, actors)
        finally:
            stop_ranks(actors)
        out["P3"] = phase_p3(dev, card, seed)
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(phase_wall("P1-P3", t0) + f"; card "
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
M1_LAYERS = 1                       # 2 until the 900 s budget
M2_LAYERS = 1                       # 4, then 2, until the 900 s budget
M_TIMED_STEPS = 1                   # 3, then 2, until the 900 s budget
M3_LAYERS = 1                       # 2 until the 900 s budget
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
    """M1-M3 after P1-P3, on their runtime (the caller shares it) or one
    of their own; the card's free memory must come back after them.
    Returns their records."""
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    n = MOE_MESH["fsdp"] * MOE_MESH["ep"]
    out = {}
    with runtime():
        actors = start_ranks(n, "gloo", group_name="moe-ring",
                             num_gpus=1.0 / n if dev.type == "cuda"
                             else 0.0)
        try:
            for name, phase in (("M1", phase_m1), ("M2", phase_m2),
                                ("M3", phase_m3)):
                t1 = time.perf_counter()
                out[name] = phase(dev, card, seed, actors)
                print(phase_wall(name, t1),
                      flush=True)
        finally:
            stop_ranks(actors)
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(phase_wall("M1-M3", t0, group=True) + f"; card "
          f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f} GB "
          f"after", flush=True)
    check(free1 >= free0 - (1 << 30),
          "M1-M3's card memory did not come back")
    return out


# ------------------------------------------------------- phases PL1-PL4
# Pipelines. PL1-PL3 drive the MPMD pipeline of stage actors through
# ParallelPlan: two stage actors share the card (num_gpus=0.5 each, as
# MPMDPipeline asks where the runtime counts fewer cards than stages) and
# their activations and gradients cross the object store (a copy to the
# host, the shared-memory write, a copy to the receiving stage's card).
# PL4 drives the GPipe pipeline_apply over MeshSpec(pp=4) on four rank
# actors sharing the card over gloo: each tick's exchange crosses a host
# buffer (collective._GLOO_CUDA_OPS).
PIPE_LAYERS = 4                    # 2 a stage: about 0.61 B params each
PIPE_BATCH = 4                     # 4 x 2048: microbatches of 1 x 2048
PIPE_MICROBATCHES = 4
PL1_TIMED_STEPS = 3
PL2_TIMED_STEPS = 2
PL3_LAYERS = 2                     # one layer a stage
PL4_STAGES = 4
# PL2's first step against PL1's: the same weights and batch, bf16 hops
# that carry the activations bit for bit; only the chunking differs.
PL2_FIRST_LOSS_REL = 1e-3
# PL3: P2's bounds (the pipeline's microbatches round their bf16 products
# apart from the one-device batch's); its control seeds every
# microbatch's backward with 1 where the step seeds n_i / N, so its
# gradients are about 4x the step's. PL3's reloads: the next step's loss
# within PL3_RELOAD_LOSS_REL of the source pipeline's.
PL3_RELOAD_LOSS_REL = 2e-3
# PL4 against the sequential 4 layers on one device: bf16 layers, the
# same products per microbatch; the control sums the output over pp in
# the backward as well, which multiplies every gradient by 4.
PL4_OUT_REL_L2 = 1e-2
PL4_GRAD_REL_L2 = 3e-2


def pipe_model(n_layers: int):
    """GPT-J-6B's published width at ``n_layers`` layers, bf16 compute,
    remat "dots", the fused LM-head loss in 512-token chunks."""
    return dataclasses.replace(shard_model(n_layers), remat=None,
                               remat_policy="dots", ce_chunk_size=512)


def pipe_batch(cfg, seed: int, rows: int = PIPE_BATCH):
    rng = np.random.default_rng(seed + 9)
    return {"input_ids": rng.integers(0, cfg.vocab_size,
                                      (rows, cfg.max_seq_len))}


def stage_probe(stage, what: str):
    """In a stage actor: ``"reset"`` zeroes its flash launch counts and
    its card's peak memory; ``"read"`` returns them."""
    cuda = stage.device.type == "cuda"
    if what == "reset":
        reset_flash_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        return None
    return {"launches": flash_counts(), "device": device_name(stage.device),
            "pid": os.getpid(), "peak_gb": torch.cuda.max_memory_allocated()
            / 1e9 if cuda else 0.0}


def on_stages(pipe, what: str):
    import ray_tpu_torch
    return ray_tpu_torch.get([a.__ray_call__.remote(stage_probe, what)
                              for a in pipe.stages], timeout=ACTOR_TIMEOUT_S)


def driver_bytes() -> float:
    """Bytes the runtime materialized in this (the driver's) process."""
    from ray_tpu_torch.core.metric_defs import runtime_metrics
    return float(sum(runtime_metrics().materialized_bytes._values.values()))


def pipe_run(name: str, card: str, cfg, plan, seed: int, steps: int,
             rows: int = PIPE_BATCH, probe=None):
    """``plan.build(cfg)`` and ``steps`` steps on ``rows`` x 2048 (the
    first a warm-up): the step wall, tokens/s and MFU over one card, the
    measured bubble beside the analytic one, each stage's (each rank's,
    on a stage mesh) busy, idle, forward, backward and optimizer seconds,
    the hops' bytes and seconds and the stage reduction's, its launches
    in the last step and its peak memory (at init and over the steps),
    and the bytes the driver took while stepping; ``probe(prog)`` adds
    its entries before the program shuts down."""
    from ray_tpu_torch.parallel.mpmd_pipeline import analytic_bubble
    t0 = time.perf_counter()
    prog = plan.build(cfg, learning_rate=1e-4, seed=seed)
    build_s = time.perf_counter() - t0
    try:
        init = on_stages(prog.pipeline, "read")
        on_stages(prog.pipeline, "reset")
        batch = pipe_batch(cfg, seed, rows)
        res, walls, bytes0 = [], [], driver_bytes()
        for i in range(steps):
            if i == steps - 1:
                on_stages(prog.pipeline, "reset")
            t1 = time.perf_counter()
            res.append(prog.step(batch))
            walls.append(time.perf_counter() - t1)
        took = driver_bytes() - bytes0
        after = on_stages(prog.pipeline, "read")
        extra = probe(prog) if probe is not None else {}
    finally:
        prog.shutdown()
    S = cfg.max_seq_len
    timed = walls[1:]
    step_s = float(np.mean(timed))
    tok_s = rows * S / step_s
    flops_tok = cfg.flops_per_token(S)
    stats = [r.detail.stage_stats for r in res]
    rec = {"phase": name, "card": card,
           "config": f"gptj-6b n_layers={cfg.n_layers}",
           "plan": plan.describe(), "stage_gpus": prog.pipeline.stage_gpus,
           "params": cfg.num_params, "batch": [rows, S],
           "microbatches": plan.n_microbatches, "build_s": build_s,
           "losses": [r.loss for r in res],
           "grad_norms": [r.grad_norm for r in res], "walls_s": walls,
           "step_s": step_s, "tokens_per_s": tok_s,
           "mfu_one_card": flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16],
           "bubble": [r.bubble_fraction for r in res],
           "bubble_analytic": analytic_bubble(plan.pp, plan.n_microbatches,
                                              plan.virtual),
           **{f"stages_{which}_step": [{k: st[k] for k in (
               "stage", "rank", "busy_s", "idle_s", "fwd_s", "bwd_s",
               "opt_s", "ops", "sent_bytes", "sent_s", "recv_bytes",
               "to_device_s", "reduce_s", "reduce_bytes")}
               for st in stats[j]] for which, j in (("first", 0),
                                                    ("last", -1))},
           "launches_last_step": [a["launches"] for a in after],
           "peak_gb_init": [a["peak_gb"] for a in init],
           "peak_gb_steps": [a["peak_gb"] for a in after],
           "devices": [a["device"] for a in after],
           "driver_bytes_per_step": took / steps, **extra}
    print(f"{name.lower()} " + json.dumps(rec), flush=True)
    return rec


def check_pipe_run(name: str, dev, rec, layers_a_stage: int):
    losses = rec["losses"]
    check(all(math.isfinite(x) for x in losses + rec["grad_norms"]),
          f"{name} non-finite loss or grad norm: {losses}")
    check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
    want = layers_a_stage * PIPE_MICROBATCHES
    for s, counts in enumerate(rec["launches_last_step"]):
        check(rec["devices"][s] == device_name(dev),
              f"{name} stage {s} runs on {rec['devices'][s]!r}")
        for n, c in counts.items():
            check(c == want, f"{name} stage {s}: {n} launched {c} times in "
                  f"a step, not {want}")
    # the driver takes M loss dicts, the stages' stats and scalars a step;
    # one stage's gradients would be gigabytes
    check(rec["driver_bytes_per_step"] < 1e6,
          f"{name}: the driver took {rec['driver_bytes_per_step']} B a "
          f"step: gradients or params reached it")


def phase_pl1(dev, card: str, seed: int):
    """PL1: ``ParallelPlan(pp=2, n_microbatches=4)`` at GPT-J-6B width and
    PIPE_LAYERS layers, one warm-up and PL1_TIMED_STEPS timed steps."""
    from ray_tpu_torch.parallel.plan import ParallelPlan
    rec = pipe_run("PL1", card, pipe_model(PIPE_LAYERS), ParallelPlan(
        pp=2, n_microbatches=PIPE_MICROBATCHES), seed, 1 + PL1_TIMED_STEPS)
    check_pipe_run("PL1", dev, rec, PIPE_LAYERS // 2)
    return rec


def phase_pl2(dev, card: str, seed: int, pl1):
    """PL2: PL1 interleaved, ``virtual=2``: one warm-up and
    PL2_TIMED_STEPS timed steps; the first step's loss equals PL1's."""
    from ray_tpu_torch.parallel.plan import ParallelPlan
    rec = pipe_run("PL2", card, pipe_model(PIPE_LAYERS), ParallelPlan(
        pp=2, virtual=2, n_microbatches=PIPE_MICROBATCHES), seed,
        1 + PL2_TIMED_STEPS)
    rel = abs(rec["losses"][0] - pl1["losses"][0]) / abs(pl1["losses"][0])
    rec["first_loss_rel_to_pl1"] = rel
    print(f"pl2 first loss {rec['losses'][0]} against PL1's "
          f"{pl1['losses'][0]}: rel {rel}", flush=True)
    check_pipe_run("PL2", dev, rec, PIPE_LAYERS // 2)
    check(rel <= PL2_FIRST_LOSS_REL, f"PL2's first loss is {rel} from "
          f"PL1's (bound {PL2_FIRST_LOSS_REL})")
    return rec


def control_grad_norm(pipe, batch) -> float:
    """The control of PL3: the serial chunk walk over the pipeline's
    stages with every microbatch's backward seeded with 1; the L2 norm of
    the gradients it leaves in the stages (one scalar a stage reaches
    the driver, as in a train step's clip)."""
    import ray_tpu_torch
    ids_mb, mask_mb, _ = pipe._split(batch)
    K, S = pipe.n_chunks, pipe.n_stages
    get = lambda r: ray_tpu_torch.get(r, timeout=ACTOR_TIMEOUT_S)  # noqa
    get([a.reset_step.remote() for a in pipe.stages])
    for i in range(pipe.n_microbatches):
        act = ids_mb[i]
        for ch in range(K):
            st = pipe.stages[ch % S]
            act = get(st.forward_one.remote(ch, i, act, ids_mb[i],
                                            mask_mb[i]) if ch == K - 1
                      else st.forward_one.remote(ch, i, act))
        g = np.float32(1.0)
        for ch in range(K - 1, -1, -1):
            g = get(pipe.stages[ch % S].backward_one.remote(ch, i, g))
    return math.sqrt(sum(get([a.grad_sq_norm.remote()
                              for a in pipe.stages])))


def merged_grad_errors(cfg, parts, ref, loss, loss_ref, dev):
    """Stage gradients (numpy trees by chunk) merged into the one-device
    tree, against ``ref`` (by leaf name, on ``dev``)."""
    from ray_tpu_torch.models.transformer import merge_stage_params
    merged = dict(_named(merge_stage_params(cfg, dict(enumerate(parts)))))
    num = den = 0.0
    leaf = {}
    for n, want in ref.items():
        got = torch.from_numpy(merged[n]).to(dev)
        ln = ((got - want.float()) ** 2).sum().item()
        ld = (want.float() ** 2).sum().item()
        num, den = num + ln, den + ld
        leaf[n] = math.sqrt(ln / max(ld, 1e-30))
    worst = max(leaf, key=leaf.get)
    return {"loss": loss, "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "grad_rel_l2": math.sqrt(num / den), "worst_leaf": worst,
            "worst_leaf_rel_l2": leaf[worst]}


def phase_pl3(dev, card: str, seed: int):
    """PL3 at PL3_LAYERS layers on ``ParallelPlan(pp=2)``'s pipeline. Its
    first step, ``pipeline.train`` off so that ``grads()`` reads the
    step's gradients as a ``train=False`` pipeline's, is held against the
    one-device loss and gradients from the same weights and batch (P2's
    bounds). The seed-1 control's gradients stay in the stages: the
    difference of their norm and the one-device norm, over the one-device
    norm, is at most their relative L2 distance, and it alone must pass
    the bound. Then the pipeline takes a step, saves its checkpoint and
    takes the next step; the checkpoint loads back into the pipeline and
    into the one-device plan: their next losses equal the pipeline's."""
    import psutil
    from ray_tpu_torch.models import init_params, lm_loss
    from ray_tpu_torch.parallel.plan import ParallelPlan
    cfg = pipe_model(PL3_LAYERS)
    batch = pipe_batch(cfg, seed)
    res = {"card": card, "config": f"gptj-6b n_layers={PL3_LAYERS}",
           "bounds": [P2_LOSS_REL_BOUND, P2_GRAD_REL_L2_BOUND,
                      P2_LEAF_REL_L2_BOUND]}
    host = {}

    def note(what):
        host[what] = psutil.virtual_memory().used / 1e9
    t0 = time.perf_counter()
    got = {}
    prog = ParallelPlan(pp=2, n_microbatches=PIPE_MICROBATCHES).build(
        cfg, learning_rate=1e-4, seed=seed)
    try:
        pipe = prog.pipeline
        pipe.train = False
        step = pipe.step(batch)
        grads = pipe.grads()
        ctl_norm = control_grad_norm(pipe, batch)
        pipe.train = True
        prog.step(batch)
        t1 = time.perf_counter()
        note("before_save")
        ck = prog.save_checkpoint()
        save_s = time.perf_counter() - t1
        note("saved")
        want = prog.step(batch).loss
        t1 = time.perf_counter()
        prog.load_checkpoint(ck)
        load_s = time.perf_counter() - t1
        note("pp2_v1_loaded")
        got["pp2_v1"] = prog.step(batch).loss
    finally:
        prog.shutdown()
    params = init_params(cfg, seed, dev)
    names = [n for n, _ in _named(params)]
    leaves = [t.requires_grad_() for _, t in _named(params)]
    loss, _ = lm_loss(cfg, params, {"input_ids": torch.tensor(
        batch["input_ids"], device=dev)})
    ref = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del params, leaves
    k = merged_grad_errors(cfg, grads, ref, step.loss, loss.item(), dev)
    ref_norm = math.sqrt(sum((g.float() ** 2).sum().item()
                             for g in ref.values()))
    c = {"grad_norm": ctl_norm, "grad_norm_one_device": ref_norm,
         "grad_rel_l2_at_least": abs(ctl_norm - ref_norm) / ref_norm}
    del ref, grads
    gc.collect()
    torch.cuda.empty_cache()
    one = ParallelPlan().build(cfg, learning_rate=1e-4, seed=seed + 1,
                               device=dev)
    one.load_checkpoint(ck)
    note("one_device_loaded")
    got["pp1"] = one.step(batch).loss
    del one
    gc.collect()
    torch.cuda.empty_cache()
    rel = {k2: abs(x - want) / abs(want) for k2, x in got.items()}
    res.update(pipeline=k, control=c, reload={
        "checkpoint_bytes": nbytes_np(ck), "save_s": save_s,
        "load_pp2_v1_s": load_s, "host_used_gb": host,
        "next_loss_source": want, "next_loss": got, "rel": rel},
        wall_s=time.perf_counter() - t0)
    print("pl3 " + json.dumps(res), flush=True)
    check(k["loss_rel"] <= P2_LOSS_REL_BOUND,
          f"PL3 loss rel {k['loss_rel']} > {P2_LOSS_REL_BOUND}")
    check(k["grad_rel_l2"] <= P2_GRAD_REL_L2_BOUND,
          f"PL3 grad rel L2 {k['grad_rel_l2']} > {P2_GRAD_REL_L2_BOUND}")
    check(k["worst_leaf_rel_l2"] <= P2_LEAF_REL_L2_BOUND,
          f"PL3 leaf {k['worst_leaf']} grad rel L2 "
          f"{k['worst_leaf_rel_l2']} > {P2_LEAF_REL_L2_BOUND}")
    check(c["grad_rel_l2_at_least"] > P2_GRAD_REL_L2_BOUND,
          f"PL3: the control's gradients (rel L2 at least "
          f"{c['grad_rel_l2_at_least']}) may pass the bounds")
    for k2, r in rel.items():
        check(r <= PL3_RELOAD_LOSS_REL, f"PL3 reload into {k2}: next loss "
              f"{got[k2]} is {r} from the source's {want}")
    return res


def nbytes_np(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes_np(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


class _SumBothWays(torch.autograd.Function):
    """PL4's control: the output summed over pp in the backward too."""

    @staticmethod
    def forward(ctx, x, group):
        from ray_tpu_torch.parallel.collective import _all_reduce
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        from ray_tpu_torch.parallel.collective import _all_reduce
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def gpipe_input(cfg, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    return torch.randn((PIPE_BATCH, cfg.max_seq_len, cfg.d_model),
                       generator=g, device=dev).to(cfg.dtype)


def gpipe_layers(cfg, seed: int, dev, keep=None):
    """The stacked layer leaves of ``init_params(cfg, seed)`` (layers
    ``keep`` only), drawn leaf by leaf."""
    from ray_tpu_torch.models.transformer import init_leaves
    out = {}
    for path, full in init_leaves(cfg, seed, dev):
        if path[0] == "layers":
            out[path[1]] = full if keep is None else full[keep].clone()
        del full
    return out


def gpipe_rank(rank, cfg, dev_str: str, seed: int, control: bool):
    """PL4 on one rank: its layer of ``cfg`` through ``pipeline_apply``
    over MeshSpec(pp=PL4_STAGES) with PIPE_MICROBATCHES microbatches,
    forward and the backward of mean(out.float() ** 2); the output, its
    layer's gradients (shared with the driver), the flash launches, the
    exchanges' seconds and bytes, the wall and the peak memory."""
    from ray_tpu_torch.models.transformer import run_layers
    from ray_tpu_torch.ops import pipeline
    from ray_tpu_torch.parallel.mesh import axis_group
    dev = torch.device(dev_str)
    cuda = dev.type == "cuda"
    mesh = _rank_mesh(rank, dev_str, {"pp": PL4_STAGES})
    s = axis_group(mesh, "pp").rank
    mine = {k: v.unsqueeze(0).requires_grad_() for k, v in gpipe_layers(
        cfg, seed, dev, slice(s, s + 1)).items()}
    x = gpipe_input(cfg, seed, dev)
    inner = pipeline.reduce_from_region
    if control:
        pipeline.reduce_from_region = _SumBothWays.apply
    reset_flash_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with CollectiveClock(cuda) as clock:
            out = pipeline.pipeline_apply(
                lambda p, h: run_layers(cfg, p, h)[0], mine, x, mesh,
                PIPE_MICROBATCHES)
            loss = (out.float() ** 2).mean()
            loss.backward()
            if cuda:
                torch.cuda.synchronize()
            coll = clock.snapshot()
    finally:
        pipeline.reduce_from_region = inner
    wall = time.perf_counter() - t0
    grads = {k: t.grad[0] for k, t in mine.items()}
    out = out.detach().float()
    rank.state["pl4"] = (out, grads)       # alive while the driver reads
    return {"stage": s, "loss": loss.item(), "wall_s": wall,
            "launches": flash_counts(), "collectives": coll,
            "device": device_name(dev),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else 0.0,
            "out": share(out),
            "grads": {k: share(g) for k, g in grads.items()}}


def pl4_release(rank, dev_str: str):
    rank.state.pop("pl4", None)
    _rank_release(torch.device(dev_str))


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def phase_pl4(dev, card: str, seed: int, actors):
    """PL4: ``pipeline_apply`` over MeshSpec(pp=4), one GPT-J-6B-width
    layer a rank (``run_layers`` over a 1-layer slice), x 4 x 2048 x 4096
    bf16 from the seed, M=4: forward and backward of mean(out.float() **
    2). Output and gradients against the sequential 4 layers on one
    device (rel L2 within PL4_OUT_REL_L2 and PL4_GRAD_REL_L2), the
    control's gradients outside; each flash kernel launched M + S - 1 = 7
    times a rank (the schedule's garbage ticks included); the exchanges'
    host-staged bytes and seconds."""
    from ray_tpu_torch.models.transformer import run_layers
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    cfg = pipe_model(PL4_STAGES)
    t0 = time.perf_counter()
    layers = {k: v.requires_grad_() for k, v in gpipe_layers(
        cfg, seed, dev).items()}
    x = gpipe_input(cfg, seed, dev)
    ref_out, _ = run_layers(cfg, layers, x)
    ref_loss = (ref_out.float() ** 2).mean()
    names = list(layers)
    ref = dict(zip(names, torch.autograd.grad(ref_loss,
                                              [layers[n] for n in names])))
    ref_out = ref_out.detach()
    del layers
    res = {"card": card, "config": f"gptj-6b layer a stage, pp={PL4_STAGES}",
           "x": list(x.shape), "microbatches": PIPE_MICROBATCHES,
           "bounds": [PL4_OUT_REL_L2, PL4_GRAD_REL_L2],
           "loss_sequential": ref_loss.item()}
    for run, control in (("gpipe", False), ("control", True)):
        outs = run_on_ranks(actors, gpipe_rank, cfg, str(dev), seed,
                            control)
        try:
            outs = sorted(outs, key=lambda o: o["stage"])
            out_err = max(rel_l2(shared(o["out"], dev), ref_out)
                          for o in outs)
            num = den = 0.0
            for n, want in ref.items():
                got = torch.cat([shared(o["grads"][n], dev) for o in outs])
                num += ((got.float() - want.float()) ** 2).sum().item()
                den += (want.float() ** 2).sum().item()
            rec = {"loss": outs[0]["loss"], "out_rel_l2": out_err,
                   "grad_rel_l2": math.sqrt(num / den),
                   "wall_s": [o["wall_s"] for o in outs],
                   "exchanges": [{k: o["collectives"][k].get("ppermute")
                                  for k in ("seconds", "bytes", "calls")}
                                 for o in outs],
                   "sum_over_pp": [{k: o["collectives"][k].get("all_reduce")
                                    for k in ("seconds", "bytes", "calls")}
                                   for o in outs]}
            if not control:
                rec.update(
                    launches=[o["launches"] for o in outs],
                    peak_gb=[o["peak_gb"] for o in outs],
                    devices=[o["device"] for o in outs])
            res[run] = rec
        finally:
            del outs
            gc.collect()
            run_on_ranks(actors, pl4_release, str(dev))
    res["wall_s"] = time.perf_counter() - t0
    print("pl4 " + json.dumps(res), flush=True)
    k, c = res["gpipe"], res["control"]
    check(k["out_rel_l2"] <= PL4_OUT_REL_L2,
          f"PL4 output rel L2 {k['out_rel_l2']} > {PL4_OUT_REL_L2}")
    check(k["grad_rel_l2"] <= PL4_GRAD_REL_L2,
          f"PL4 grad rel L2 {k['grad_rel_l2']} > {PL4_GRAD_REL_L2}")
    check(c["grad_rel_l2"] > PL4_GRAD_REL_L2,
          f"PL4: the control's gradients (rel L2 {c['grad_rel_l2']}) pass "
          f"the bound")
    ticks = PIPE_MICROBATCHES + PL4_STAGES - 1
    for i, counts in enumerate(k["launches"]):
        check(k["devices"][i] == device_name(dev),
              f"PL4 rank {i} runs on {k['devices'][i]!r}")
        for n, cnt in counts.items():
            check(cnt == ticks, f"PL4 rank {i}: {n} launched {cnt} times, "
                  f"not {ticks}")
    return res


def pipeline_phases(dev, card: str, seed: int):
    """PL1-PL4 after M1-M3, on a runtime of their own or the one the
    caller shares; the card's free memory must come back after them.
    Returns their records."""
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    out = {}
    with runtime():
        for name, phase in (("PL1", phase_pl1), ("PL2", phase_pl2),
                            ("PL3", phase_pl3)):
            t1 = time.perf_counter()
            out[name] = phase(dev, card, seed, *(
                (out["PL1"],) if name == "PL2" else ()))
            print(phase_wall(name, t1),
                  flush=True)
        t1 = time.perf_counter()
        actors = start_ranks(PL4_STAGES, "gloo", group_name="gpipe",
                             num_gpus=1.0 / PL4_STAGES
                             if dev.type == "cuda" else 0.0)
        try:
            out["PL4"] = phase_pl4(dev, card, seed, actors)
        finally:
            stop_ranks(actors)
        print(phase_wall("PL4", t1),
              flush=True)
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(phase_wall("PL1-PL4", t0, group=True) + f"; card "
          f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f} GB "
          f"after", flush=True)
    check(free1 >= free0 - (1 << 30),
          "PL1-PL4's card memory did not come back")
    return out


# Stage meshes and elastic training. PL5 and PL6 drive the mpmd3d
# lowering: a dp x fsdp mesh inside each pipeline stage, here dp=2, so
# four rank actors (two a stage, num_gpus=0.25 each) share the card, each
# stage's two ranks in a gloo group of their own (NCCL refuses two ranks
# on one device): each rank takes one row of every 2 x 2048 microbatch,
# and a stage's gradient reduction crosses host memory through gloo.
# EL1 drives ElasticTrainer over ParallelPlan(pp=2, dp=2), a SliceManager
# feeding it a drain notice, and a stage actor killed mid-step.
MESH_ROWS = 8                      # 8 x 2048 in 4 microbatches: 1 a rank
MESH_MICROBATCHES = 4
MESH_DP = 2
PL5_LAYERS = 2                     # one a stage
PL6_LAYERS = 4                     # two a stage
PL6_TIMED_STEPS = 1                # 2 before the 900 s budget
EL1_LAYERS = 2
EL1_STEPS = 5                      # 6 until the 900 s budget
EL1_SNAPSHOT_INTERVAL = 8
# PL5's control seeds each rank's backward with the microbatch's n_i / N,
# without the rank's share n_loc / n_mb of its tokens (1/2 here): the
# stage's summed gradients are twice the step's.
PL5_CONTROL_RATIO = 2.0
PL5_CONTROL_RATIO_TOL = 0.1
# EL1's losses against the one-device plan's at the same step: P2's loss
# bound (the ranks' microbatches round their bf16 products apart from the
# one-device batch's).
EL1_LOSS_REL = P2_LOSS_REL_BOUND
#: a phase of STORE_BACK_PHASES must give the store back to within
#: STORE_BACK_GB of its live GB before it (EL1's trainer holds a 10.4 GB
#: snapshot in the store); the after value is read once the runtime's
#: free grace window and STORE_WAIT_S have passed
STORE_BACK_GB = 0.1
STORE_BACK_PHASES = ("EL1", "D1", "DG1", "AR1", "WF1")
STORE_WAIT_S = 3.0


def mesh_control_grad_norm(pipe, batch) -> float:
    """PL5's control: the serial chunk walk over the stage meshes with
    every rank's backward seeded with its microbatch's n_i / N, the share
    n_loc / n_mb of the microbatch's tokens left out (the rank applies
    it, so the driver feeds n_i / N * n_mb / n_loc: N with no mask); the
    L2 norm of the reduced gradients it leaves in the stages (one
    squared norm a stage reaches the driver)."""
    import ray_tpu_torch
    ids_mb, _, ns = pipe._split(batch)
    total = sum(ns)
    K, S, N = pipe.n_chunks, pipe.n_stages, pipe.n_ranks
    get = lambda r: ray_tpu_torch.get(r, timeout=ACTOR_TIMEOUT_S)  # noqa
    get([a.reset_step.remote() for a in pipe.stages])
    for i in range(pipe.n_microbatches):
        ids = [pipe.rows(ids_mb[i], r) for r in range(N)]
        acts = get([a.forward_one.remote(0, i, ids[r])
                    for r, a in enumerate(pipe.ranks[0])])
        for ch in range(1, K):
            acts = get([a.forward_one.remote(ch, i, acts[r], ids[r])
                        if ch == K - 1 else
                        a.forward_one.remote(ch, i, acts[r])
                        for r, a in enumerate(pipe.ranks[ch % S])])
        gs = [np.float32(ns[i] / total * N)] * N
        for ch in range(K - 1, -1, -1):
            gs = get([a.backward_one.remote(ch, i, gs[r])
                      for r, a in enumerate(pipe.ranks[ch % S])])
    sq = get([a.grad_sq_norm.remote() for a in pipe.stages])
    return math.sqrt(sum(sq[s * N] for s in range(S)))


def phase_pl5(dev, card: str, seed: int):
    """PL5: ``MPMDPipeline(n_stages=2, dp=2, n_microbatches=4,
    train=False)`` at GPT-J-6B width and PL5_LAYERS layers, four ranks
    sharing the card: the step's loss and the stages' reduced gradients
    against the one-device step on the same weights and batch (P2's
    bounds), the control outside with its gradient norm near twice the
    reference's; each rank's f32 reduction bytes and seconds; each flash
    kernel launched 1 layer x 4 microbatches = 4 times a rank."""
    import ray_tpu_torch
    from ray_tpu_torch.models import init_params, lm_loss
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline
    cfg = pipe_model(PL5_LAYERS)
    batch = pipe_batch(cfg, seed, MESH_ROWS)
    t0 = time.perf_counter()
    pipe = MPMDPipeline(cfg, n_stages=2, n_microbatches=MESH_MICROBATCHES,
                        seed=seed, dp=MESH_DP, learning_rate=1e-4)
    build_s = time.perf_counter() - t0
    try:
        on_stages(pipe, "reset")
        step = pipe.step(batch)
        launches = on_stages(pipe, "read")
        grads = pipe.grads()
        stats = ray_tpu_torch.get([a.step_stats.remote()
                                   for a in pipe.stages],
                                  timeout=ACTOR_TIMEOUT_S)
        ctl_norm = mesh_control_grad_norm(pipe, batch)
        gpus = pipe.stage_gpus
    finally:
        pipe.shutdown()
    params = init_params(cfg, seed, dev)
    names = [n for n, _ in _named(params)]
    leaves = [t.requires_grad_() for _, t in _named(params)]
    loss, _ = lm_loss(cfg, params, {"input_ids": torch.tensor(
        batch["input_ids"], device=dev)})
    ref = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del params, leaves
    k = merged_grad_errors(cfg, grads, ref, step.loss, loss.item(), dev)
    ref_norm = math.sqrt(sum((g.float() ** 2).sum().item()
                             for g in ref.values()))
    del ref, grads
    gc.collect()
    c = {"grad_norm": ctl_norm, "grad_norm_one_device": ref_norm,
         "ratio": ctl_norm / ref_norm,
         "grad_rel_l2_at_least": abs(ctl_norm - ref_norm) / ref_norm}
    res = {"card": card, "config": f"gptj-6b n_layers={PL5_LAYERS}",
           "mesh": {"pp": 2, "dp": MESH_DP}, "num_gpus_a_rank": gpus,
           "batch": [MESH_ROWS, cfg.max_seq_len],
           "microbatches": MESH_MICROBATCHES, "build_s": build_s,
           "step_wall_s": step.wall_s,
           "bounds": [P2_LOSS_REL_BOUND, P2_GRAD_REL_L2_BOUND,
                      P2_LEAF_REL_L2_BOUND],
           "pipeline": k, "control": c,
           "reduction": [{key: st[key] for key in (
               "stage", "rank", "reduce_s", "reduce_bytes")}
               for st in stats],
           "launches": [a["launches"] for a in launches],
           "devices": [a["device"] for a in launches],
           "wall_s": time.perf_counter() - t0}
    print("pl5 " + json.dumps(res), flush=True)
    check(k["loss_rel"] <= P2_LOSS_REL_BOUND,
          f"PL5 loss rel {k['loss_rel']} > {P2_LOSS_REL_BOUND}")
    check(k["grad_rel_l2"] <= P2_GRAD_REL_L2_BOUND,
          f"PL5 grad rel L2 {k['grad_rel_l2']} > {P2_GRAD_REL_L2_BOUND}")
    check(k["worst_leaf_rel_l2"] <= P2_LEAF_REL_L2_BOUND,
          f"PL5 leaf {k['worst_leaf']} grad rel L2 "
          f"{k['worst_leaf_rel_l2']} > {P2_LEAF_REL_L2_BOUND}")
    check(c["grad_rel_l2_at_least"] > P2_GRAD_REL_L2_BOUND,
          f"PL5: the control's gradients (rel L2 at least "
          f"{c['grad_rel_l2_at_least']}) may pass the bounds")
    check(abs(c["ratio"] - PL5_CONTROL_RATIO) <= PL5_CONTROL_RATIO_TOL,
          f"PL5: the control's gradient norm is {c['ratio']} x the "
          f"reference's, not about {PL5_CONTROL_RATIO}")
    for j, counts in enumerate(res["launches"]):
        check(res["devices"][j] == device_name(dev),
              f"PL5 rank {j} runs on {res['devices'][j]!r}")
        for n, cnt in counts.items():
            check(cnt == MESH_MICROBATCHES, f"PL5 rank {j}: {n} launched "
                  f"{cnt} times, not {MESH_MICROBATCHES}")
    return res


def mesh_rank_state(stage):
    """In a stage-mesh rank: sha256 of each param leaf's bytes, the Adam
    moments' bytes it holds and what the plain layout would hold."""
    import hashlib
    params = stage.params
    sha = {}
    for name, t in _named({str(c): p for c, p in params.items()}):
        sha[name] = hashlib.sha256(t.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes()).hexdigest()
    numel = sum(t.numel() for _, t in _named(
        {str(c): p for c, p in params.items()}))
    return {"stage": stage.stage, "rank": stage.rank, "sha": sha,
            "grad_f32_bytes": 4 * numel, "adam_bytes": stage.adam_bytes(),
            "adam_bytes_plain": 8 * numel}


def mesh_replicas(prog):
    import ray_tpu_torch
    ranks = ray_tpu_torch.get([a.__ray_call__.remote(mesh_rank_state)
                               for a in prog.pipeline.stages],
                              timeout=ACTOR_TIMEOUT_S)
    return {"replicas": [{k: v for k, v in r.items() if k != "sha"}
                         for r in ranks],
            "replicas_bit_identical": [
                len({json.dumps(r["sha"], sort_keys=True) for r in ranks
                     if r["stage"] == s}) == 1
                for s in range(prog.pipeline.n_stages)]}


def phase_pl6(dev, card: str, seed: int):
    """PL6: ``ParallelPlan(pp=2, dp=2, n_microbatches=4,
    grad_transport="int8", shard_weight_update=True)`` at PL6_LAYERS
    layers, one warm-up and PL6_TIMED_STEPS timed steps: PL1's record and
    checks (each flash kernel PL6_LAYERS / 2 x 4 microbatches times a rank
    a step, losses falling, under 1 MB a step to the driver), each
    stage's int8 reduction under a third of its f32 gradient's bytes,
    each rank's Adam bytes about half the plain layout's, the params of
    a stage's two ranks bit-identical after the last step."""
    from ray_tpu_torch.parallel.plan import ParallelPlan
    plan = ParallelPlan(pp=2, dp=MESH_DP, n_microbatches=MESH_MICROBATCHES,
                        grad_transport="int8", shard_weight_update=True)
    rec = pipe_run("PL6", card, pipe_model(PL6_LAYERS), plan, seed,
                   1 + PL6_TIMED_STEPS, rows=MESH_ROWS, probe=mesh_replicas)
    check_pipe_run("PL6", dev, rec, PL6_LAYERS // 2)
    check(all(rec["replicas_bit_identical"]),
          f"PL6: a stage's ranks hold different params "
          f"{rec['replicas_bit_identical']}")
    for st, r in zip(rec["stages_last_step"], rec["replicas"]):
        check(0 < st["reduce_bytes"] < r["grad_f32_bytes"] / 3,
              f"PL6 stage {st['stage']} rank {st['rank']}: the int8 "
              f"reduction's {st['reduce_bytes']} B are not under a third "
              f"of the f32 gradient's {r['grad_f32_bytes']} B")
        check(r["adam_bytes"] <= 0.51 * r["adam_bytes_plain"],
              f"PL6 stage {r['stage']} rank {r['rank']}: {r['adam_bytes']} "
              f"B of Adam moments, not about half the plain layout's "
              f"{r['adam_bytes_plain']} B")
    return rec


class SliceHostController:
    """What EL1's slice manager sees of a controller: the in-memory fake
    provider's hosts are synthetic (no node manager joins the runtime),
    so the drain's scheduler and placement-group hooks act on nothing,
    the demand snapshot is empty, and the slice events go to the
    driver's flight recorder beside the elastic trainer's."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.scheduler = self
        self.draining = {}
        self.ready_queues, self.tasks, self.leases = {}, {}, {}
        self.actors, self.nodes, self.pending_pgs = {}, {}, []

    def set_draining(self, node_id, flag: bool) -> None:
        self.draining[node_id.binary()] = flag

    def call_on_loop(self, fn, timeout=None):
        return fn()

    def _reschedule_pgs_on_nodes(self, node_bs) -> int:
        return 0

    def _maybe_schedule(self, force: bool = False) -> None:
        pass


def kill_mid_step(victim):
    """The driver's next pipeline step kills ``victim`` at its first
    streamed item (``streaming.wait_any``), so the kill lands mid-step."""
    import ray_tpu_torch
    from ray_tpu_torch.core import streaming
    orig = streaming.wait_any

    def wait_any(*args, **kw):
        out = orig(*args, **kw)
        if streaming.wait_any is wait_any:
            streaming.wait_any = orig
            ray_tpu_torch.kill(victim)
        return out
    streaming.wait_any = wait_any


def program_launches(prog):
    """Each rank's flash launches (None for a dead rank)."""
    import ray_tpu_torch
    out = []
    for a in prog.pipeline.stages:
        try:
            out.append(ray_tpu_torch.get(
                a.__ray_call__.remote(stage_probe, "read"),
                timeout=60)["launches"])
        except Exception:
            out.append(None)
    return out


def phase_el1(dev, card: str, seed: int):
    """EL1: ``ElasticTrainer(ParallelPlan(pp=2, dp=2, n_microbatches=4),
    snapshot_interval=8)`` at EL1_LAYERS layers with a ``SliceManager``
    over an in-memory ``FakeSliceProvider`` (one slice) feeding it drain
    notices, beside the one-device ``ParallelPlan()`` from the same
    weights: 2 steps; a maintenance notice drains and releases the
    slice, and step 3 folds live to pp=2 x dp=1 (0 steps lost); step 4;
    a stage actor killed while step 5 runs: the trainer recovers on the
    same grid from the fold's snapshot and replays steps 3-4 (3 steps
    lost). Every loss within EL1_LOSS_REL of the one-device
    plan's at its step; the two recoveries' triggers, plans, steps lost
    and seconds; SLICE_DRAIN, SLICE_DOWN and the four ELASTIC_* events;
    each program's flash launches (8 a rank in the first, 12 in the
    last, which replays 3-4 and runs 5)."""
    from ray_tpu_torch.autoscaler import (FakeSliceProvider, SliceManager,
                                          SliceTypeConfig)
    from ray_tpu_torch.core.global_state import try_global_worker
    from ray_tpu_torch.parallel.elastic import ElasticTrainer
    from ray_tpu_torch.parallel.plan import ParallelPlan
    from ray_tpu_torch.util.state import list_task_events
    cfg = pipe_model(EL1_LAYERS)
    batch = pipe_batch(cfg, seed, MESH_ROWS)
    recorder = try_global_worker().recorder
    provider = FakeSliceProvider(provider_config={"max_slices": 1})
    mgr = SliceManager(SliceHostController(recorder), provider,
                       [SliceTypeConfig("gpu-host", "1x1",
                                        {"CPU": 8, "GPU": 1})],
                       idle_timeout_s=3600.0, drain_deadline_s=0.0)
    sid = mgr.acquire_slice("gpu-host")
    hosts = set(provider.internal_ids(sid))

    def pump():
        mgr.update({"demand": [], "slice_demand": [], "busy_nodes": hosts,
                    "alive_nodes": hosts})
    pump()
    res = {"card": card, "config": f"gptj-6b n_layers={EL1_LAYERS}",
           "plan": "pp=2 dp=2 M=4", "batch": [MESH_ROWS, cfg.max_seq_len],
           "snapshot_interval": EL1_SNAPSHOT_INTERVAL,
           "slice_up": mgr.slices[sid].state == "UP"}
    t0 = time.perf_counter()
    trainer = ElasticTrainer(
        ParallelPlan(pp=2, dp=MESH_DP, n_microbatches=MESH_MICROBATCHES),
        cfg, learning_rate=1e-4, seed=seed,
        snapshot_interval=EL1_SNAPSHOT_INTERVAL, slice_manager=mgr)
    res["build_s"] = time.perf_counter() - t0
    launches, watched = [], []

    def watch(prog):
        """Read a program's launches just before it shuts down."""
        if any(prog is w for w in watched):
            return
        watched.append(prog)
        inner = prog.shutdown

        def shutdown():
            launches.append(program_launches(prog))
            inner()
        prog.shutdown = shutdown
    ref = ParallelPlan().build(cfg, learning_rate=1e-4, seed=seed,
                               device=dev)
    steps = []
    try:
        watch(trainer.program)
        for k in range(EL1_STEPS):
            if k == 2:
                provider.inject_maintenance(sid)
                pump()
            if k == 4:
                kill_mid_step(trainer.program.pipeline.stages[-1])
            t1 = time.perf_counter()
            got = trainer.step(batch)
            wall = time.perf_counter() - t1
            want = ref.step(batch).loss
            steps.append({"step": k + 1, "loss": got.loss,
                          "loss_one_device": want,
                          "rel": abs(got.loss - want) / abs(want),
                          "wall_s": wall, "plan": trainer.plan.describe()})
            watch(trainer.program)
        recoveries = [r.asdict() for r in trainer.recoveries]
        recorder.flush()
        events = sorted({e["ev"] for e in list_task_events(limit=100_000)})
    finally:
        trainer.shutdown()
        mgr.shutdown()
        provider.shutdown()
        del ref
        gone = weakref.ref(trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    res.update(trainer_collected=gone() is None)
    res.update(steps=steps, recoveries=recoveries, events=events,
               slice_state=mgr.slices[sid].state, launches=launches,
               wall_s=time.perf_counter() - t0)
    print("el1 " + json.dumps(res), flush=True)
    check(res["slice_up"], "EL1: the fake slice never came up")
    check(res["trainer_collected"], "EL1: the shut-down trainer (and its "
          "host snapshot) outlived its last reference")
    for st in steps:
        check(math.isfinite(st["loss"]) and st["rel"] <= EL1_LOSS_REL,
              f"EL1 step {st['step']}: loss {st['loss']} against the "
              f"one-device {st['loss_one_device']} (rel {st['rel']})")
    want_plans = [("notice", "mpmd3d[pp=2 M=4 dp=2 fp32]",
                   "mpmd[pp=2 M=4 fp32]", 0),
                  ("failure", "mpmd[pp=2 M=4 fp32]", "mpmd[pp=2 M=4 fp32]",
                   3)]
    got_plans = [(r["trigger"], r["from_plan"], r["to_plan"],
                  r["steps_lost"]) for r in recoveries]
    check(got_plans == want_plans,
          f"EL1 recoveries {got_plans}, not {want_plans}")
    for name in ("SLICE_DRAIN", "SLICE_DOWN", "ELASTIC_NOTICE",
                 "ELASTIC_SNAPSHOT", "ELASTIC_RELOWER", "ELASTIC_RESUME"):
        check(name in events, f"EL1: no {name} event in {events}")
    check(res["slice_state"] == "RELEASED",
          f"EL1: the drained slice is {res['slice_state']}")
    check(len(launches) == 3, f"EL1 built {len(launches)} programs, not 3")
    want = {0: 2 * MESH_MICROBATCHES,
            2: (EL1_STEPS - 2) * MESH_MICROBATCHES}
    for p, counts in enumerate(launches):
        for j, c in enumerate(counts):
            if p == 1 and c is None:
                continue                       # the killed rank
            for n, cnt in (c or {}).items():
                check(cnt == want[p] if p in want else cnt > 0,
                      f"EL1 program {p} rank {j}: {n} launched {cnt} times"
                      f" (want {want.get(p, 'some')})")
    return res


def store_gb() -> float:
    """GB of live objects in the running runtime's native store."""
    from ray_tpu_torch.core.global_state import global_worker
    return global_worker().shm._segment().stats()[0] / 1e9


def on_own_runtime(name: str, dev, phase, *args):
    """``phase(dev, *args)`` on a runtime of its own, or on the one a
    caller shares (:func:`runtime`); the card's free memory must come
    back after it. The store's live GB before and after go to
    ``STORE_GB``: the after value once the runtime's free grace window
    has let go of what the phase dropped (waiting at most that window
    and STORE_WAIT_S more for it to come within STORE_BACK_GB)."""
    from ray_tpu_torch.core.global_state import global_worker
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    with runtime():
        before = store_gb()
        STORE_GB[name] = [round(before, 3)]
        own, seg = resident_gb()
        DRIVER_GB[name] = [round(own, 3)]
        SEGMENT_GB[name] = [round(seg, 3)]
        out = phase(dev, *args)
        gc.collect()
        deadline = time.monotonic() + STORE_WAIT_S \
            + global_worker().config.free_grace_s
        while store_gb() > before + STORE_BACK_GB \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        STORE_GB[name].append(round(store_gb(), 3))
        own, seg = resident_gb()
        DRIVER_GB[name].append(round(own, 3))
        SEGMENT_GB[name].append(round(seg, 3))
        malloc_trim()
        DRIVER_GB[name].append(round(resident_gb()[0], 3))
    if name in STORE_BACK_PHASES:
        check(STORE_GB[name][1] <= STORE_GB[name][0] + STORE_BACK_GB,
              f"{name} left {STORE_GB[name][1]} GB live in the store, "
              f"{STORE_GB[name][0]} GB before it (bound +{STORE_BACK_GB})")
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    free1 = torch.cuda.mem_get_info()[0]
    print(phase_wall(name, t0) + f"; card "
          f"memory free {free0 / 1e9:.2f} GB before, {free1 / 1e9:.2f} GB "
          f"after", flush=True)
    check(free1 >= free0 - (1 << 30),
          f"{name}'s card memory did not come back")
    return out


def mesh_elastic_phases(dev, card: str, seed: int):
    """PL5, PL6 and EL1 after PL4, on one runtime (the caller's, where it
    shares one): the later phases' actors fork from the zygote the first
    spawn booted. The card's free memory must come back after each.
    Returns their records."""
    t0 = time.perf_counter()
    with runtime():
        out = {name: on_own_runtime(name, dev, phase, card, seed)
               for name, phase in (("PL5", phase_pl5), ("PL6", phase_pl6),
                                   ("EL1", phase_el1))}
    print(phase_wall("PL5-EL1", t0, group=True),
          flush=True)
    return out


# ---------------------------------------------------------- RLL1, RLL2
# rllib's on-policy learners on the card, on the runtime P1-EL1 share:
# PPO (RLL1), then PG, IMPALA, APPO, multi-agent PPO and a group of two
# remote learners (RLL2). The env runners are CPU actors (by design:
# their policies run on the CPU); the learners' update (the module's
# forward, the loss, the backward, the global-norm clip and Adam) runs on
# the card. The networks are MLPs: no kernel of this port runs here.
RLL_ENV = {"obs_dim": 8, "n_actions": 4}     # RandomEnv, gym-free
RLL_HIDDENS = (256, 256)  # fcnet_hiddens of MODEL_DEFAULTS, RLlib's
#                           rllib/models/catalog.py
RLL_RUNNERS = 2
# RLL1's settings: the JAX package's AlgorithmConfig defaults
RLL1 = dict(train_batch_size=4000, minibatch_size=128, num_epochs=8,
            lr=3e-4, grad_clip=0.5)
RLL1_SYNC_ITERS = 2       # then one streaming iteration
# one PPO update on the card against the CPU's from the same state and
# minibatch (TF32 off): the loss, relative; the parameters' update
# (after - before, all leaves) in relative L2; the control, the CPU's
# update on the next minibatch, must fall outside the update bound
RLL_LOSS_REL = 1e-5
RLL_UPDATE_REL = 1e-3
RLL_VTRACE_REL = 1e-5     # V-trace on the card against the CPU
# RLL2's group of two remote learners (0.5 of the card each) against one
# learner on the whole batch: the parameters' update, relative L2; the
# control, one learner on the first half, must fall outside it
RLL_GROUP_REL = 1e-3
RLL_GROUP_ROWS = 512
RLL_MA_BATCH = 1000       # multi-agent PPO's train batch (two policies)


def rll_env(env_config):
    from ray_tpu_torch.rllib import RandomEnv
    return RandomEnv(**env_config)


def two_agent_env(env_config):
    """Two agents, each a ``RandomEnv`` of its own seed (gym-free)."""
    from ray_tpu_torch.rllib import MultiAgentEnv, RandomEnv

    class TwoAgents(MultiAgentEnv):
        possible_agents = ["a0", "a1"]

        def __init__(self):
            self.envs = {a: RandomEnv(**env_config, seed=i)
                         for i, a in enumerate(self.possible_agents)}

        def reset(self, *, seed=None):
            return {a: e.reset(None if seed is None else seed + i)[0]
                    for i, (a, e) in enumerate(self.envs.items())}, {}

        def step(self, action_dict):
            out = {a: e.step(action_dict[a]) for a, e in self.envs.items()}
            done = any(o[2] for o in out.values())
            terms = {a: done for a in out}
            terms["__all__"] = done
            return ({a: o[0] for a, o in out.items()},
                    {a: o[1] for a, o in out.items()}, terms,
                    {"__all__": False}, {})
    return TwoAgents()


def state_to_cpu(state):
    """A learner's ``{"params", "opt_state"}`` as CPU copies."""
    from ray_tpu_torch.rllib.models import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def tree_sha(tree) -> str:
    """sha256 over a weights tree's leaves in path order."""
    import hashlib
    from ray_tpu_torch.rllib.models import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def leaf_rows(tree):
    """Each leaf of a weights tree (nested dicts and lists of numpy
    arrays or tensors) as ``(path, shape, dtype, float64 sum)``, in path
    order, the path ``/``-joined."""
    from ray_tpu_torch.rllib.models import tree_get, tree_paths
    rows = []
    for path in tree_paths(tree):
        leaf = tree_get(tree, path)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to("cpu", torch.float64).numpy()
        a = np.asarray(leaf)
        rows.append(("/".join(map(str, path)), tuple(a.shape), str(a.dtype),
                     float(a.astype(np.float64).sum())))
    return rows


def same_trees(what: str, a, b, worker_ids) -> None:
    """Fails with ``what`` unless the weight trees ``a`` and ``b`` are
    bit-equal (sha256 over their leaves in path order). On a mismatch it
    first prints both trees' leaf checksums, one line a leaf (its path,
    shape, dtype and float64 sum in each, and whether the leaf's bytes
    differ), and the learner actors' ``worker_ids``; the failure names
    the leaves that differ."""
    if tree_sha(a) == tree_sha(b):
        return
    from ray_tpu_torch.rllib.models import tree_get, tree_paths
    ra, rb = dict((r[0], r[1:]) for r in leaf_rows(a)), \
        dict((r[0], r[1:]) for r in leaf_rows(b))
    pa = {"/".join(map(str, p)): p for p in tree_paths(a)}
    pb = {"/".join(map(str, p)): p for p in tree_paths(b)}
    differ = []
    for name in sorted(set(ra) | set(rb)):
        same = name in pa and name in pb and np.array_equal(
            np.asarray(tree_get(a, pa[name])),
            np.asarray(tree_get(b, pb[name])))
        if not same:
            differ.append(name)
        print(f"{what}: leaf {name}: {ra.get(name)} against "
              f"{rb.get(name)}{'' if same else ' DIFFERS'}", flush=True)
    print(f"{what}: learner actors' worker ids {list(worker_ids)}",
          flush=True)
    check(False, f"{what}: leaves {differ} differ (learner worker ids "
                 f"{list(worker_ids)})")


class LearnerWatch:
    """Wraps a local learner's ``update_from_batch`` in the main path:
    every call's time from CUDA events around it (the host clock on the
    CPU), and for call ``capture`` its batch, the state before and after
    it and its metrics, with the next call's batch (the control's)."""

    def __init__(self, learner, dev, capture: int = 0):
        self.learner, self.dev, self.capture = learner, dev, capture
        self.captured: dict = {}
        self.calls: list = []
        inner = learner.update_from_batch

        def update(batch):
            k = len(self.calls)
            if k == self.capture:
                self.captured.update(
                    batch={n: np.array(v) for n, v in batch.items()},
                    before=state_to_cpu(learner._state))
            elif k == self.capture + 1:
                self.captured["next_batch"] = {n: np.array(v)
                                               for n, v in batch.items()}
            t0 = self._mark()
            out = inner(batch)
            self.calls.append((t0, self._mark()))
            if k == self.capture:
                self.captured.update(metrics=out,
                                     after=state_to_cpu(learner._state))
            return out
        learner.update_from_batch = update

    def _mark(self):
        if self.dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def update_ms(self, first: int = 0):
        """(count, median, min, max) ms of the wrapped calls from call
        ``first`` on."""
        calls = self.calls[first:]
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in calls]
        else:
            ms = [(b - a) * 1e3 for a, b in calls]
        return (len(ms), float(np.median(ms)), float(np.min(ms)),
                float(np.max(ms))) if ms else (0, 0.0, 0.0, 0.0)


def check_on_device(learner, dev, name: str):
    """Every params and optimizer tensor of ``learner`` on ``dev``."""
    from ray_tpu_torch.rllib.models import tree_leaves
    where = sorted({str(t.device) for t in tree_leaves(learner._state)})
    want = str(dev) if dev.type != "cuda" else f"cuda:{dev.index or 0}"
    check(where == [want], f"{name}: learner tensors on {where}, not "
          f"{want}")
    return where


def param_update(before, after):
    """The parameters' update ``after - before`` as one flat tensor."""
    from ray_tpu_torch.rllib.models import tree_leaves
    return torch.cat([(a.float() - b.float()).reshape(-1) for a, b in zip(
        tree_leaves(after["params"]), tree_leaves(before["params"]))])


def card_cpu_update(algo, cap):
    """The captured update again on the CPU from the card's state before
    it; the control: the CPU's update from that state on the next
    minibatch."""
    from ray_tpu_torch.rllib import Learner
    from ray_tpu_torch.rllib.models import tree_map
    cfg = algo.config

    def on_cpu(batch):
        cpu = Learner(algo.module_spec, algo.loss_fn(), learning_rate=cfg.lr,
                      grad_clip=cfg.grad_clip,
                      loss_config=algo.loss_config(), device="cpu")
        cpu.load_state(tree_map(lambda t: t.clone(), cap["before"]))
        m = cpu.update_from_batch(batch)
        return m, param_update(cap["before"], cpu._state)

    card = param_update(cap["before"], cap["after"])
    m, cpu = on_cpu(cap["batch"])
    _, ctl = on_cpu(cap["next_batch"])
    want = cap["metrics"]["total_loss"]
    return {"loss_card": want, "loss_cpu": m["total_loss"],
            "loss_rel": abs(m["total_loss"] - want) / max(abs(want), 1e-12),
            "update_rel": rel_l2(card, cpu), "control_rel": rel_l2(card, ctl),
            "update_norm": card.norm().item(), "count": int(
                cap["before"]["opt_state"]["count"])}


def timed_iteration(algo, watch, group) -> dict:
    """One ``algo.train()``: its wall and the parts spent in the learner
    group's update and the weight sync (the rest is sampling: the
    runners' calls and the concatenation, or a streamed step's waits)."""
    parts = {"update": 0.0, "sync": 0.0}
    depth = [0]        # a streamed epoch calls update_from_batch inside

    def timed(name, fn):
        def call(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    parts[name] += time.perf_counter() - t0
        return call
    wraps = {"update_from_batch": "update", "update_ordered": "update",
             "update_from_stream": "update"}
    inner = {k: getattr(group, k) for k in wraps if hasattr(group, k)}
    for k in inner:
        setattr(group, k, timed(wraps[k], inner[k]))
    inner_sync = algo._sync_weights
    algo._sync_weights = timed("sync", inner_sync)
    n_calls = len(watch.calls) if watch is not None else 0
    try:
        t0 = time.perf_counter()
        r = algo.train()
        wall = time.perf_counter() - t0
    finally:
        for k in inner:
            setattr(group, k, inner[k])
        algo._sync_weights = inner_sync
    ms = r["learner"]
    flat = {f"{p}/{k}": v for p, m in ms.items() for k, v in m.items()} \
        if ms and isinstance(next(iter(ms.values())), dict) else ms
    check(all(math.isfinite(v) for v in flat.values()),
          f"non-finite learner metrics {ms}")
    bubble = r.get("rollout_train_bubble")
    return {"wall_s": wall, "update_s": parts["update"],
            "sync_s": parts["sync"],
            "sample_share": (wall - parts["update"] - parts["sync"]) / wall,
            "bubble": bubble,
            "updates": (len(watch.calls) - n_calls) if watch else None,
            "steps_lifetime": r["num_env_steps_sampled_lifetime"],
            "learner": flat}


def print_iterations(name: str, card: str, iters, watch, peak: int):
    for i, it in enumerate(iters):
        steps = it["steps_lifetime"] - (iters[i - 1]["steps_lifetime"]
                                        if i else 0)
        it["env_steps"] = steps
        it["env_steps_per_s"] = steps / it["wall_s"]
        print(f"{name} iteration {i + 1}: {it['wall_s']:.3f} s, {steps} "
              f"env steps, {it['env_steps_per_s']:.0f} env steps/s, "
              f"updates {it['updates']} in {it['update_s']:.3f} s, "
              f"weight sync {it['sync_s']:.3f} s, sampling share "
              f"{it['sample_share']:.3f}"
              + (f", rollout_train_bubble {it['bubble']:.3f}"
                 if it["bubble"] is not None else "") + f" | {card}",
              flush=True)
    rec = {"peak_gb": peak / 1e9}
    if watch is not None:
        n, med, lo, hi = watch.update_ms()
        clock = "CUDA events" if watch.dev.type == "cuda" else "host clock"
        print(f"{name}: learner update on {watch.dev} {med:.3f} ms median "
              f"(min {lo:.3f}, max {hi:.3f}, {n} updates; {clock}); peak "
              f"memory {peak / 1e9:.3f} GB | {card}", flush=True)
        rec.update(updates=n, update_ms_median=med, update_ms_min=lo,
                   update_ms_max=hi)
    return rec


def runner_shas(algo):
    import ray_tpu_torch
    return [tree_sha(w) for w in ray_tpu_torch.get(
        [r.get_weights.remote() for r in algo.env_runners],
        timeout=ACTOR_TIMEOUT_S)]


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def phase_rll1(dev, card: str, seed: int):
    """RLL1: PPO through ``PPOConfig().build()``, 2 synchronous iterations
    and one streaming, the learner on the card."""
    import tempfile

    from ray_tpu_torch.rllib import PPOConfig
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the card-CPU check needs f32 products")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    config = (PPOConfig()
              .environment(rll_env, env_config=dict(RLL_ENV))
              .env_runners(num_env_runners=RLL_RUNNERS)
              .training(model={"fcnet_hiddens": RLL_HIDDENS}, **RLL1)
              .learners(device=dev)
              .debugging(seed=seed))
    cfg = config
    per_iter = cfg.train_batch_size // RLL_RUNNERS * RLL_RUNNERS
    per_epoch = -(-per_iter // cfg.minibatch_size)
    updates = cfg.num_epochs * per_epoch
    algo = config.build()
    try:
        setup_s = time.perf_counter() - t0
        learner = algo.learner_group._local
        where = check_on_device(learner, dev, "RLL1")
        # the capture: iteration 2's first update (Adam's moments warm)
        watch = LearnerWatch(learner, dev, capture=updates)
        iters, shas = [], []
        for _ in range(RLL1_SYNC_ITERS):
            iters.append(timed_iteration(algo, watch, algo.learner_group))
            shas.append(tree_sha(algo.get_policy_weights()))
            got = runner_shas(algo)
            check(got == [shas[-1]] * RLL_RUNNERS,
                  f"RLL1: runners hold {got}, not the learner's "
                  f"{shas[-1]}")
        check(shas[0] != shas[1], "RLL1: iteration 2 left the weights")
        check([it["steps_lifetime"] for it in iters]
              == [per_iter * (i + 1) for i in range(RLL1_SYNC_ITERS)],
              f"RLL1 env steps {[it['steps_lifetime'] for it in iters]}")
        check(all(it["updates"] == updates for it in iters),
              f"RLL1 updates an iteration "
              f"{[it['updates'] for it in iters]}, want {updates}")
        with tempfile.TemporaryDirectory(prefix="rll1_") as d:
            ckpt = algo.save(d)
            algo.config.streaming_rollouts = True
            iters.append(timed_iteration(algo, watch, algo.learner_group))
            streamed = tree_sha(algo.get_policy_weights())
            check(streamed != shas[-1],
                  "RLL1: the streaming iteration left the weights")
            check(iters[-1]["steps_lifetime"] > per_iter * RLL1_SYNC_ITERS,
                  f"RLL1 streamed steps {iters[-1]['steps_lifetime']}")
            check(0.0 <= iters[-1]["bubble"] <= 1.0,
                  f"RLL1 bubble {iters[-1]['bubble']}")
            algo.config.streaming_rollouts = False
            algo.restore(ckpt)
        restored = tree_sha(algo.get_policy_weights())
        check(restored == shas[-1], "RLL1: restore did not give back the "
              "saved weights bit for bit")
        check(runner_shas(algo) == [restored] * RLL_RUNNERS,
              "RLL1: the runners did not get the restored weights")
        check_on_device(learner, dev, "RLL1")
        agree = card_cpu_update(algo, watch.captured)
        print(f"RLL1 card vs CPU, update {agree['count'] + 1}: loss "
              f"{agree['loss_card']:.7f} against {agree['loss_cpu']:.7f} "
              f"(rel {agree['loss_rel']:.2e}, bound {RLL_LOSS_REL}); the "
              f"update's rel L2 {agree['update_rel']:.2e} (bound "
              f"{RLL_UPDATE_REL}), the control's {agree['control_rel']:.2e}"
              f" (update norm {agree['update_norm']:.3e})", flush=True)
        check(agree["loss_rel"] <= RLL_LOSS_REL
              and agree["update_rel"] <= RLL_UPDATE_REL,
              f"RLL1 card and CPU disagree: {agree}")
        check(agree["control_rel"] > RLL_UPDATE_REL,
              f"RLL1: the control falls inside the bound: {agree}")
        rec = print_iterations("RLL1", card, iters, watch, peak_bytes(dev))
    finally:
        algo.cleanup()
    sync = iters[:RLL1_SYNC_ITERS]
    rec.update(card=card, setup_s=setup_s, iterations=iters,
               agreement=agree, learner_device=where,
               weights_sha=shas, restored_sha=restored,
               env_steps_per_s=float(np.mean(
                   [it["env_steps_per_s"] for it in sync])),
               sampling_share=float(np.mean(
                   [it["sample_share"] for it in sync])))
    print("rll1 " + json.dumps(rec), flush=True)
    return rec


def vtrace_agreement(algo, cap, dev):
    """V-trace on ``dev`` against its CPU run on the captured update's
    batch, the target log-probs and values from the state before it."""
    from ray_tpu_torch.rllib.impala import time_major, vtrace_returns
    from ray_tpu_torch.rllib.learner import _batch_tensors
    from ray_tpu_torch.rllib.models import tree_map
    cfg = algo.config
    params = tree_map(lambda t: t.to(dev), cap["before"]["params"])
    batch = _batch_tensors(cap["batch"], dev)
    with torch.no_grad():
        out = algo.learner_group._local.module.forward_train(
            params, batch["obs"])
        tl, bl, v, r, d, _, boot = time_major(out, batch, cfg.rollout_len)
        args = (tl, bl, r, v, boot, d)
        kw = dict(gamma=cfg.gamma, rho_clip=cfg.vtrace_rho_clip,
                  c_clip=cfg.vtrace_c_clip)
        vs, adv = vtrace_returns(*args, **kw)
        vs_c, adv_c = vtrace_returns(*(a.cpu() for a in args), **kw)
    return {"T": int(tl.shape[0]), "B": int(tl.shape[1]),
            "vs_rel": rel_l2(vs.cpu(), vs_c),
            "pg_adv_rel": rel_l2(adv.cpu(), adv_c)}


def rll2_algo(name: str, dev, seed: int):
    from ray_tpu_torch.rllib import (APPOConfig, IMPALAConfig,
                                     MultiAgentPPOConfig, PGConfig)
    cls = {"PG": PGConfig, "IMPALA": IMPALAConfig, "APPO": APPOConfig,
           "MultiAgentPPO": MultiAgentPPOConfig}[name]
    ma = name == "MultiAgentPPO"
    cfg = (cls().environment(two_agent_env if ma else rll_env,
                             env_config=dict(RLL_ENV))
           .env_runners(num_env_runners=RLL_RUNNERS)
           .training(model={"fcnet_hiddens": RLL_HIDDENS},
                     **({"train_batch_size": RLL_MA_BATCH} if ma else {}))
           .learners(device=dev)
           .debugging(seed=seed))
    if ma:
        pol = {"observation_dim": RLL_ENV["obs_dim"],
               "num_actions": RLL_ENV["n_actions"]}
        cfg.multi_agent(policies={"p0": dict(pol), "p1": dict(pol)},
                        policy_mapping_fn=lambda aid: "p" + aid[1:])
    return cfg.build()


def group_against_one(dev, seed: int):
    """A ``LearnerGroup`` of two remote learners (0.5 of the card each)
    and one learner in this process, from the same weights, each updated
    once on the same batch; the control updates on the first half."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import Learner, LearnerGroup, RLModuleSpec
    from ray_tpu_torch.rllib.ppo import ppo_loss
    spec = RLModuleSpec(observation_dim=RLL_ENV["obs_dim"],
                        num_actions=RLL_ENV["n_actions"],
                        hiddens=RLL_HIDDENS)
    rng = np.random.default_rng(seed + 15)
    n, half = RLL_GROUP_ROWS, RLL_GROUP_ROWS // 2
    adv = rng.normal(size=n)
    # each learner's half standardized: the loss's normalization is then
    # the same over a half as over the whole batch. The group shards the
    # rows in the order of its first permutation (its numpy generator,
    # seeded with the group's seed, 0): the halves are of that order.
    order = np.random.default_rng(0).permutation(n)
    for s in (order[:half], order[half:]):
        adv[s] = (adv[s] - adv[s].mean()) / adv[s].std()
    batch = {"obs": rng.normal(size=(n, RLL_ENV["obs_dim"])).astype(
                 np.float32),
             "actions": rng.integers(0, RLL_ENV["n_actions"], n),
             "logp": rng.normal(-1.4, 0.1, n).astype(np.float32),
             "advantages": adv.astype(np.float32),
             "value_targets": rng.normal(size=n).astype(np.float32)}

    def make(device=None):
        return Learner(spec, ppo_loss, seed=seed, device=device)

    t0 = time.perf_counter()
    group = LearnerGroup(make, num_learners=2,
                         resources_per_learner={"num_gpus": 0.5}, seed=0)
    try:
        ready_s = time.perf_counter() - t0
        before = group.get_weights()
        t1 = time.perf_counter()
        group.update_from_batch(batch)
        update_s = time.perf_counter() - t1
        reps = ray_tpu_torch.get([a.get_weights.remote()
                                  for a in group._remote],
                                 timeout=ACTOR_TIMEOUT_S)
        workers = ray_tpu_torch.get([a.__ray_call__.remote(
            lambda self: ray_tpu_torch.get_runtime_context().get_worker_id())
            for a in group._remote], timeout=ACTOR_TIMEOUT_S)
    finally:
        group.shutdown()
    shas = [tree_sha(w) for w in reps]
    same_trees("RLL2 group replicas differ", reps[0], reps[1], workers)
    one, ctl = make(dev), make(dev)
    same_trees("RLL2: the group and one learner start from other weights",
               before, one.get_weights(), workers)
    one.update_from_batch(batch)
    ctl.update_from_batch({k: v[order[:half]] for k, v in batch.items()})

    def upd(w):
        from ray_tpu_torch.rllib.models import tree_leaves
        return torch.cat([torch.from_numpy(a - b).reshape(-1) for a, b in
                          zip(tree_leaves(w), tree_leaves(before))])
    g = upd(reps[0])
    out = {"replica_sha": shas, "ready_s": ready_s, "update_s": update_s,
           "update_rel": rel_l2(g, upd(one.get_weights())),
           "control_rel": rel_l2(g, upd(ctl.get_weights())),
           "rows": n}
    print(f"RLL2 group of 2 remote learners (0.5 GPU each) vs one learner "
          f"on the whole batch: update rel L2 {out['update_rel']:.2e} "
          f"(bound {RLL_GROUP_REL}), the control's (first half) "
          f"{out['control_rel']:.2e}; replicas sha256 {shas[0][:16]} x2; "
          f"ready {ready_s:.1f} s, one update {update_s:.3f} s", flush=True)
    check(out["update_rel"] <= RLL_GROUP_REL,
          f"RLL2 group and one learner disagree: {out}")
    check(out["control_rel"] > RLL_GROUP_REL,
          f"RLL2: the control falls inside the bound: {out}")
    return out


def phase_rll2(dev, card: str, seed: int):
    """RLL2: one iteration each of PG, IMPALA, APPO and multi-agent PPO
    (two policies), the learners on the card; V-trace on the card against
    the CPU; then a group of two remote learners against one."""
    out = {"card": card}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for name in ("PG", "IMPALA", "APPO", "MultiAgentPPO"):
        t0 = time.perf_counter()
        algo = rll2_algo(name, dev, seed)
        try:
            setup_s = time.perf_counter() - t0
            ma = name == "MultiAgentPPO"
            learners = algo.learners if ma else \
                {"": algo.learner_group._local}
            for pid, lr in learners.items():
                check_on_device(lr, dev, f"RLL2 {name} {pid}".strip())
            watch = None if ma else LearnerWatch(learners[""], dev)
            it = timed_iteration(algo, watch, algo.learner_group
                                 if not ma else algo)
            check(it["steps_lifetime"] > 0, f"RLL2 {name}: no env steps")
            if ma:
                check({k.split("/")[0] for k in it["learner"]}
                      == {"p0", "p1"}, f"RLL2 {name}: policies updated "
                      f"{sorted(it['learner'])}")
            rec = {"setup_s": setup_s, "iteration": it}
            if name == "APPO":
                vt = vtrace_agreement(algo, watch.captured, dev)
                print(f"RLL2 V-trace on the card vs the CPU at T={vt['T']}"
                      f" x B={vt['B']}: vs rel L2 {vt['vs_rel']:.2e}, "
                      f"pg_adv rel L2 {vt['pg_adv_rel']:.2e} (bound "
                      f"{RLL_VTRACE_REL})", flush=True)
                check(vt["vs_rel"] <= RLL_VTRACE_REL
                      and vt["pg_adv_rel"] <= RLL_VTRACE_REL,
                      f"RLL2 V-trace: card and CPU disagree {vt}")
                rec["vtrace"] = vt
            rec.update(print_iterations(f"RLL2 {name}", card, [it], watch,
                                        peak_bytes(dev)))
        finally:
            algo.cleanup()
        out[name] = rec
    out["group"] = group_against_one(dev, seed)
    out["peak_gb"] = peak_bytes(dev) / 1e9
    print("rll2 " + json.dumps(out), flush=True)
    return out


# ----------------------------------------------------------------- RLL3
# rllib's off-policy and offline learners on the card, after RLL2 on the
# same runtime: DQN, discrete SAC, continuous SAC and TD3 online (CPU
# runner actors fill each algorithm's replay buffer in this process; its
# learner trains on the card in bursts of ``update_many``), then, from
# JSON files the port's writer made, CQL, BC, MARWIL and the off-policy
# estimators (FQE on the card). The networks are MLPs at RLL_HIDDENS: no
# kernel of this port runs here.
#: the online algorithms' settings over their defaults (none on the card;
#: the CPU rehearsal starts learning and syncs DQN's target sooner)
RLL3_TRAINING: dict = {}
RLL3_PAST_SYNC = 4          # DQN's updates past its hard target sync
RLL3_ITERS_PAST_START = 2   # SAC's and TD3's iterations past learning starts
RLL3_CAPTURE = (1, 2)       # updates 2 and 3: the card-CPU check's update
#                             (Adam's moments warm) and its control's
RLL3_TAU_ABS = 1e-6         # a polyak target against (1 - tau) t + tau o
RLL3_BURST = 8              # update_many's K against K single updates
RLL3_BURST_ABS = 1e-6
RLL3_OFFLINE_ITERS = 2
RLL3_OFFLINE_ROWS = 2000    # transitions in each offline dataset
RLL3_IS_RTOL = 1e-6         # tests/rllib/test_ddpg_cql_estimators.py:152
RLL3_FQE_ITERS = 200


class _Box:
    """A gym-shaped Box space: ``spec_for_spaces`` reads low, high and
    shape (and no ``n``)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.shape = self.low.shape


class Pendulum:
    """gymnasium's ``Pendulum-v1`` in numpy, gym-free: its published
    dynamics (g 10, m 1, l 1, dt 0.05, speed within 8, torque within
    2), observation (cos th, sin th, thdot), reward -(th^2 + 0.1 thdot^2
    + 0.001 u^2) with th wrapped into [-pi, pi), a start drawn from
    U([-pi, -1], [pi, 1]), 200-step episodes (truncated, never
    terminated)."""

    def __init__(self, env_config=None):
        self.observation_space = _Box([-1.0, -1.0, -8.0], [1.0, 1.0, 8.0])
        self.action_space = _Box([-2.0], [2.0])
        self._rng = np.random.default_rng(
            (env_config or {}).get("seed", 0))
        self._th, self._thdot, self._t = 0.0, 0.0, 0

    def _obs(self):
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th, self._thdot = self._rng.uniform([-np.pi, -1.0],
                                                  [np.pi, 1.0])
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action, np.float64).reshape(-1)[0],
                          -2.0, 2.0))
        th, thdot = self._th, self._thdot
        wrapped = (th + np.pi) % (2 * np.pi) - np.pi
        cost = wrapped ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = np.clip(thdot + (3 * 10.0 / 2 * np.sin(th) + 3.0 * u)
                        * 0.05, -8.0, 8.0)
        self._th, self._thdot = th + thdot * 0.05, thdot
        self._t += 1
        return self._obs(), -float(cost), False, self._t >= 200, {}

    def close(self) -> None:
        pass


def pendulum_env(env_config):
    return Pendulum(env_config)


class UpdateWatch(LearnerWatch):
    """Wraps an off-policy learner's ``_update`` in the main path: every
    update's time from CUDA events around it (the host clock on the
    CPU), and for the updates in ``capture`` (0-based) their minibatch,
    draws, metrics and the state before and after."""

    def __init__(self, learner, dev, capture=()):
        self.learner, self.dev = learner, dev
        self.capture = set(capture)
        self.captured: dict = {}
        self.calls: list = []
        inner = learner._update

        def update(batch, noise):
            k = len(self.calls)
            if k in self.capture:
                rec = self.captured[k] = {
                    "batch": state_to_cpu(batch),
                    "noise": state_to_cpu(noise),
                    "before": state_to_cpu(learner._state)}
            t0 = self._mark()
            out = inner(batch, noise)
            self.calls.append((t0, self._mark()))
            if k in self.capture:
                rec.update(metrics={n: float(v) for n, v in out.items()},
                           after=state_to_cpu(learner._state))
            return out
        learner._update = update


def trained(learner, state):
    """The leaves of every network ``learner``'s optimizers step, as one
    flat f32 tensor."""
    from ray_tpu_torch.rllib.models import tree_leaves
    return torch.cat([t.float().reshape(-1) for keys in learner.OPTS.values()
                      for k in keys for t in tree_leaves(state[k])])


def cpu_learner(algo):
    """A learner like ``algo``'s, on the CPU."""
    cfg = algo.config
    dev, cfg.learner_device = cfg.learner_device, "cpu"
    try:
        return algo._make_learner()
    finally:
        cfg.learner_device = dev


def offpolicy_card_cpu(algo, watch):
    """Captured update 2 again on the CPU from the card's state before
    it, on its minibatch with its draws; the control: the CPU's update
    from that state on update 3's minibatch and draws."""
    cap, nxt = (watch.captured[k] for k in RLL3_CAPTURE)

    def on_cpu(rec):
        cpu = cpu_learner(algo)
        cpu.load_state(cap["before"])
        m = cpu._update(rec["batch"], rec["noise"])
        return float(m["total_loss"]), trained(cpu, cpu._state)

    before = trained(algo.learner, cap["before"])
    card = trained(algo.learner, cap["after"]) - before
    loss, cpu = on_cpu(cap)
    _, ctl = on_cpu(nxt)
    want = cap["metrics"]["total_loss"]
    return {"loss_card": want, "loss_cpu": loss,
            "loss_rel": abs(loss - want) / max(abs(want), 1e-12),
            "update_rel": rel_l2(card, cpu - before),
            "control_rel": rel_l2(card, ctl - before),
            "update_norm": card.norm().item()}


def check_card_cpu(name: str, agree):
    print(f"RLL3 {name} card vs CPU, update {RLL3_CAPTURE[0] + 1}: loss "
          f"{agree['loss_card']:.7f} against {agree['loss_cpu']:.7f} (rel "
          f"{agree['loss_rel']:.2e}, bound {RLL_LOSS_REL}); the update's "
          f"rel L2 {agree['update_rel']:.2e} (bound {RLL_UPDATE_REL}), the "
          f"control's {agree['control_rel']:.2e}", flush=True)
    check(agree["loss_rel"] <= RLL_LOSS_REL
          and agree["update_rel"] <= RLL_UPDATE_REL,
          f"RLL3 {name}: card and CPU disagree: {agree}")
    check(agree["control_rel"] > RLL_UPDATE_REL,
          f"RLL3 {name}: the control falls inside the bound: {agree}")


def max_abs(a, b) -> float:
    """The largest elementwise gap between two trees of tensors."""
    from ray_tpu_torch.rllib.models import tree_leaves
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def polyak_gap(cap, pairs, tau: float) -> float:
    """How far each target after the captured update is from
    ``(1 - tau) * target_before + tau * online_after``."""
    from ray_tpu_torch.rllib.models import tree_map
    b, a = cap["before"], cap["after"]
    return max(max_abs(a[t], tree_map(lambda x, y: (1 - tau) * x + tau * y,
                                      b[t], a[o])) for t, o in pairs)


def rll3_online(name: str, config, dev, seed: int, updates: int = 0,
                capture=RLL3_CAPTURE):
    """``config`` (2 runner actors, RLL_HIDDENS, the learner on ``dev``)
    built and trained until its learner has made ``updates`` updates, or
    RLL3_ITERS_PAST_START iterations past learning starts. Returns the
    algorithm (still up), its watch and its record."""
    config = (config.env_runners(num_env_runners=RLL_RUNNERS)
              .training(model={"fcnet_hiddens": RLL_HIDDENS},
                        **RLL3_TRAINING)
              .learners(device=dev).debugging(seed=seed))
    t0 = time.perf_counter()
    algo = config.build()
    setup_s = time.perf_counter() - t0
    where = check_on_device(algo.learner, dev, f"RLL3 {name}")
    watch = UpdateWatch(algo.learner, dev, capture)
    t1 = time.perf_counter()
    past, r = 0, {}
    while (len(watch.calls) < updates) if updates else \
            (past < RLL3_ITERS_PAST_START):
        r = algo.train()
        past += bool(r["learner"])
    wall = time.perf_counter() - t1
    check(all(math.isfinite(v) for v in r["learner"].values()),
          f"RLL3 {name}: non-finite metrics {r['learner']}")
    n, med, lo, hi = watch.update_ms()
    steps = r["num_env_steps_sampled_lifetime"]
    rec = {"setup_s": setup_s, "train_s": wall, "env_steps": steps,
           "env_steps_per_s": steps / wall, "updates": n,
           "update_ms_median": med, "update_ms_min": lo,
           "update_ms_max": hi, "learner_device": where}
    print(f"RLL3 {name}: {steps} env steps in {wall:.3f} s "
          f"({rec['env_steps_per_s']:.0f}/s), {n} updates, learner update "
          f"{med:.3f} ms median (min {lo:.3f}, max {hi:.3f}; "
          f"{'CUDA events' if dev.type == 'cuda' else 'host clock'})",
          flush=True)
    return algo, watch, rec


def rll3_dqn(dev, seed: int):
    """DQN's defaults; the target against the online params around its
    hard sync (at update 500); the card's update 2 against the CPU's."""
    from ray_tpu_torch.rllib import DQNConfig
    sync = RLL3_TRAINING.get("target_network_update_freq",
                             DQNConfig().target_network_update_freq)
    algo, watch, rec = rll3_online(
        "DQN", DQNConfig().environment(rll_env, env_config=dict(RLL_ENV)),
        dev, seed, updates=sync + RLL3_PAST_SYNC,
        capture=RLL3_CAPTURE + (sync - 1, sync))
    try:
        at, after = watch.captured[sync - 1], watch.captured[sync]
        rec["target"] = {
            "at_sync": max_abs(at["after"]["target_params"],
                               at["after"]["params"]),
            "after_sync": max_abs(after["after"]["target_params"],
                                  at["after"]["target_params"]),
            "online_moved": max_abs(after["after"]["params"],
                                    at["after"]["params"])}
        print(f"RLL3 DQN target: after update {sync} its max gap to the "
              f"online params {rec['target']['at_sync']}; after update "
              f"{sync + 1} it moved {rec['target']['after_sync']}, the "
              f"online params {rec['target']['online_moved']:.3e}",
              flush=True)
        check(rec["target"]["at_sync"] == 0.0
              and rec["target"]["after_sync"] == 0.0
              and rec["target"]["online_moved"] > 0.0,
              f"RLL3 DQN: the target sync is off: {rec['target']}")
        rec["agreement"] = offpolicy_card_cpu(algo, watch)
        check_card_cpu("DQN", rec["agreement"])
    finally:
        algo.cleanup()
    return rec


def rll3_burst(algo, dev):
    """``update_many(K)`` on a fresh learner against K single updates on
    another from the same seed, on the same K minibatches of ``algo``'s
    buffer (the draws from each learner's generator in the same order):
    the states within RLL3_BURST_ABS; then each timed by CUDA events."""
    cfg = algo.config
    batches = algo.buffer.sample_many(RLL3_BURST, cfg.train_batch_size)
    one = [{k: v[i] for k, v in batches.items()} for i in range(RLL3_BURST)]
    a, b = algo._make_learner(), algo._make_learner()
    a.update_many(batches)
    for x in one:
        b.update(x)
    gap = max_abs(a._state, b._state)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    burst_ms = timed(lambda: a.update_many(batches))
    singles_ms = timed(lambda: [b.update(x) for x in one])
    rec = {"k": RLL3_BURST, "state_gap": gap, "burst_ms": burst_ms,
           "singles_ms": singles_ms}
    print(f"RLL3 update_many({RLL3_BURST}) against {RLL3_BURST} single "
          f"updates: state gap {gap:.2e} (bound {RLL3_BURST_ABS}); "
          f"{burst_ms:.3f} ms the burst, {singles_ms:.3f} ms the singles "
          f"(host wall, synchronized)", flush=True)
    check(gap <= RLL3_BURST_ABS,
          f"RLL3 update_many({RLL3_BURST}) left {gap} from single updates")
    return rec


def rll3_sac(dev, seed: int):
    """Discrete SAC on RandomEnv, continuous SAC on Pendulum; the
    continuous one's update 2 against the CPU's, its targets' polyak
    step, and update_many against single updates."""
    from ray_tpu_torch.rllib import SACConfig
    out = {}
    algo, watch, out["discrete"] = rll3_online(
        "SAC discrete",
        SACConfig().environment(rll_env, env_config=dict(RLL_ENV)), dev,
        seed)
    algo.cleanup()
    algo, watch, rec = rll3_online(
        "SAC continuous", SACConfig().environment(pendulum_env), dev, seed)
    try:
        cap = watch.captured[RLL3_CAPTURE[0]]
        rec["polyak_gap"] = polyak_gap(cap, (("q1_t", "q1"), ("q2_t", "q2")),
                                       algo.config.tau)
        print(f"RLL3 SAC targets: max gap to (1 - tau) t + tau q "
              f"{rec['polyak_gap']:.2e} (bound {RLL3_TAU_ABS})", flush=True)
        check(rec["polyak_gap"] <= RLL3_TAU_ABS,
              f"RLL3 SAC: a target is off its polyak step: "
              f"{rec['polyak_gap']}")
        rec["agreement"] = offpolicy_card_cpu(algo, watch)
        check_card_cpu("SAC continuous", rec["agreement"])
        rec["burst"] = rll3_burst(algo, dev)
    finally:
        algo.cleanup()
    out["continuous"] = rec
    return out


def rll3_td3(dev, seed: int):
    """TD3 on Pendulum: the delayed policy step across updates 2 (even:
    the policy, its Adam count and its target move) and 3 (odd: they
    stay), the targets' polyak step, the card's update 2 against the
    CPU's."""
    from ray_tpu_torch.rllib import TD3Config
    algo, watch, rec = rll3_online(
        "TD3", TD3Config().environment(pendulum_env), dev, seed)
    try:
        even, odd = (watch.captured[k] for k in RLL3_CAPTURE)
        tau = algo.config.tau

        def moved(cap):
            return {"pi": max_abs(cap["after"]["pi"], cap["before"]["pi"]),
                    "pi_t": max_abs(cap["after"]["pi_t"],
                                    cap["before"]["pi_t"]),
                    "pi_count": int(cap["after"]["pi_opt"]["count"])
                    - int(cap["before"]["pi_opt"]["count"])}
        rec["delay"] = {"even": moved(even), "odd": moved(odd)}
        rec["polyak_gap"] = max(polyak_gap(even, (("qs_t", "qs"),
                                                  ("pi_t", "pi")), tau),
                                polyak_gap(odd, (("qs_t", "qs"),), tau))
        print(f"RLL3 TD3 delay: update {RLL3_CAPTURE[0] + 1} moved "
              f"{rec['delay']['even']}, update {RLL3_CAPTURE[1] + 1} "
              f"{rec['delay']['odd']}; targets' max gap to their polyak "
              f"step {rec['polyak_gap']:.2e} (bound {RLL3_TAU_ABS})",
              flush=True)
        check(rec["delay"]["odd"] == {"pi": 0.0, "pi_t": 0.0, "pi_count": 0}
              and rec["delay"]["even"]["pi"] > 0.0
              and rec["delay"]["even"]["pi_t"] > 0.0
              and rec["delay"]["even"]["pi_count"] == 1,
              f"RLL3 TD3: the policy's delay is off: {rec['delay']}")
        check(rec["polyak_gap"] <= RLL3_TAU_ABS,
              f"RLL3 TD3: a target is off its polyak step: "
              f"{rec['polyak_gap']}")
        rec["agreement"] = offpolicy_card_cpu(algo, watch)
        check_card_cpu("TD3", rec["agreement"])
    finally:
        algo.cleanup()
    return rec


def offline_datasets(root: str, seed: int):
    """The port's ``JsonWriter`` writes RandomEnv's episodes (uniform
    behaviour actions, their log-probs kept) and Pendulum's transitions
    (uniform torques, stored squashed into (-1, 1)); ``JsonReader`` must
    give back what was written, bit for bit."""
    from ray_tpu_torch.rllib import JsonReader, JsonWriter, RandomEnv
    rng = np.random.default_rng(seed + 16)
    paths, written = {}, {}
    env = RandomEnv(**RLL_ENV, seed=seed)
    n_act = RLL_ENV["n_actions"]
    episodes = []
    obs, _ = env.reset(seed=seed)
    ep = {k: [] for k in ("obs", "next_obs", "actions", "rewards",
                          "dones", "logp")}
    for _ in range(RLL3_OFFLINE_ROWS):
        a = int(rng.integers(0, n_act))
        nxt, r, term, _, _ = env.step(a)
        for k, v in (("obs", obs), ("next_obs", nxt), ("actions", a),
                     ("rewards", r), ("dones", float(term)),
                     ("logp", np.log(1.0 / n_act))):
            ep[k].append(v)
        obs = nxt
        if term:
            episodes.append(ep)
            obs, _ = env.reset()
            ep = {k: [] for k in ep}
    dtypes = {"obs": np.float32, "next_obs": np.float32,
              "actions": np.int64, "rewards": np.float32,
              "dones": np.float32, "logp": np.float32}
    batches = {"random": [{k: np.asarray(v, dtypes[k]) for k, v in e.items()}
                          for e in episodes]}
    pend = Pendulum({"seed": seed})
    obs, _ = pend.reset(seed=seed)
    rows = {k: [] for k in ("obs", "next_obs", "actions", "rewards",
                            "dones")}
    for _ in range(RLL3_OFFLINE_ROWS):
        u = rng.uniform(-2.0, 2.0, size=(1,)).astype(np.float32)
        nxt, r, term, trunc, _ = pend.step(u)
        for k, v in (("obs", obs), ("next_obs", nxt), ("actions", u / 2.0),
                     ("rewards", np.float32(r)), ("dones", np.float32(term))):
            rows[k].append(v)
        obs = pend.reset()[0] if (term or trunc) else nxt
    batches["pendulum"] = [{k: np.asarray(v, np.float32)
                            for k, v in rows.items()}]
    bits = {}
    for name, bs in batches.items():
        paths[name] = os.path.join(root, name)
        w = JsonWriter(paths[name])
        for b in bs:
            w.write(b)
        w.close()
        written[name] = {k: np.concatenate([b[k] for b in bs])
                         for k in bs[0]}
        got = JsonReader(paths[name])._data
        bits[name] = all(
            np.array_equal(got[k].astype(v.dtype), v)
            and np.array_equal(got[k].astype(v.dtype).view(np.uint8),
                               v.view(np.uint8))
            for k, v in written[name].items())
        check(bits[name] and set(got) == set(written[name]),
              f"RLL3: JsonReader did not give back {name}'s rows bit for "
              f"bit")
    return paths, written, bits


def rll3_offline(dev, seed: int, root: str):
    """CQL from Pendulum's file, BC and MARWIL from RandomEnv's, each
    RLL3_OFFLINE_ITERS iterations with the learner on the card; CQL's
    update 2 against the CPU's; IS (the target policy the behaviour
    one), WIS, and DM and DR over an FQE model trained on the card."""
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, DirectMethod,
                                     DoublyRobust, FQEModel,
                                     ImportanceSampling, MARWILConfig,
                                     WeightedImportanceSampling)
    from ray_tpu_torch.rllib.models import tree_leaves
    paths, data, bits = offline_datasets(root, seed)
    out = {"json_bit_for_bit": bits,
           "rows": {k: int(len(v["obs"])) for k, v in data.items()}}
    cfg = (CQLConfig().environment(pendulum_env)
           .offline(offline_data=paths["pendulum"])
           .training(model={"fcnet_hiddens": RLL_HIDDENS})
           .learners(device=dev).debugging(seed=seed))
    algo = cfg.build()
    try:
        where = check_on_device(algo.learner, dev, "RLL3 CQL")
        watch = UpdateWatch(algo.learner, dev, RLL3_CAPTURE)
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RLL3_OFFLINE_ITERS)]
        wall = time.perf_counter() - t0
        m = results[-1]["learner"]
        check(all(math.isfinite(v) for v in m.values()),
              f"RLL3 CQL: non-finite metrics {m}")
        n, med, lo, hi = watch.update_ms()
        rec = {"train_s": wall, "updates": n, "update_ms_median": med,
               "update_ms_min": lo, "update_ms_max": hi,
               "cql_loss": m["cql_loss"], "learner_device": where,
               "eval_return": results[-1]["episode_return_mean"]}
        rec["agreement"] = offpolicy_card_cpu(algo, watch)
        check_card_cpu("CQL", rec["agreement"])
    finally:
        algo.cleanup()
    print(f"RLL3 CQL: {n} updates in {wall:.3f} s (with "
          f"{cfg.evaluation_episodes} evaluation episodes an iteration), "
          f"learner update {med:.3f} ms median", flush=True)
    out["CQL"] = rec
    for name, ccls in (("BC", BCConfig), ("MARWIL", MARWILConfig)):
        c = ccls().training(model={"fcnet_hiddens": RLL_HIDDENS}) \
            .learners(device=dev).debugging(seed=seed)
        c.offline_data = paths["random"]
        algo = c.build()
        try:
            learner = algo.learner_group._local
            where = check_on_device(learner, dev, f"RLL3 {name}")
            watch = LearnerWatch(learner, dev)
            t0 = time.perf_counter()
            results = [algo.train() for _ in range(RLL3_OFFLINE_ITERS)]
            wall = time.perf_counter() - t0
            m = results[-1]["learner"]
            check(all(math.isfinite(v) for v in m.values()),
                  f"RLL3 {name}: non-finite metrics {m}")
            n, med, _, _ = watch.update_ms()
        finally:
            algo.cleanup()
        out[name] = {"train_s": wall, "updates": n, "update_ms_median": med,
                     "learner_device": where, "learner": m}
        print(f"RLL3 {name}: {n} updates of {c.train_batch_size} rows in "
              f"{wall:.3f} s, learner update {med:.3f} ms", flush=True)
    batch = data["random"]
    n_act = RLL_ENV["n_actions"]

    def behaviour_logp(obs, actions):
        return np.full(len(actions), np.log(1.0 / n_act))

    def behaviour_probs(obs):
        return np.full((len(obs), n_act), 1.0 / n_act)
    est = {"IS": ImportanceSampling(behaviour_logp).estimate(batch),
           "WIS": WeightedImportanceSampling(behaviour_logp).estimate(batch)}
    t0 = time.perf_counter()
    fqe = FQEModel(RLL_ENV["obs_dim"], n_act, behaviour_probs,
                   hiddens=RLL_HIDDENS, seed=seed, device=dev)
    fqe_loss = fqe.train(batch, iters=RLL3_FQE_ITERS)
    fqe_s = time.perf_counter() - t0
    fqe_on = sorted({str(t.device) for t in tree_leaves(fqe._params)})
    check(fqe_on == [str(dev) if dev.type != "cuda"
                     else f"cuda:{dev.index or 0}"],
          f"RLL3 FQE on {fqe_on}")
    est["DM"] = DirectMethod(fqe).estimate(batch)
    est["DR"] = DoublyRobust(fqe, behaviour_logp).estimate(batch)
    is_rel = abs(est["IS"]["v_target"] - est["IS"]["v_behavior"]) \
        / abs(est["IS"]["v_behavior"])
    print(f"RLL3 estimators over {est['IS']['num_episodes']} episodes: IS "
          f"{est['IS']['v_target']:.6f} against the behaviour value "
          f"{est['IS']['v_behavior']:.6f} (rel {is_rel:.1e}, bound "
          f"{RLL3_IS_RTOL}), WIS {est['WIS']['v_target']:.6f}, DM "
          f"{est['DM']['v_target']:.6f}, DR {est['DR']['v_target']:.6f}; "
          f"FQE {RLL3_FQE_ITERS} iterations on {fqe_on[0]} in "
          f"{fqe_s:.3f} s, last loss {fqe_loss:.4e}", flush=True)
    check(is_rel <= RLL3_IS_RTOL,
          f"RLL3 IS with the behaviour policy as target: {est['IS']}")
    check(all(math.isfinite(e["v_target"]) for e in est.values()),
          f"RLL3 estimators: {est}")
    out["estimators"] = dict(est, is_rel=is_rel, fqe_s=fqe_s,
                             fqe_loss=fqe_loss)
    return out


def phase_rll3(dev, card: str, seed: int):
    """RLL3: DQN, discrete and continuous SAC and TD3 online, then CQL,
    BC, MARWIL and the estimators from the port's JSON files; the
    learners on the card."""
    import tempfile
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the card-CPU check needs f32 products")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"card": card, "DQN": rll3_dqn(dev, seed),
           "SAC": rll3_sac(dev, seed), "TD3": rll3_td3(dev, seed)}
    with tempfile.TemporaryDirectory(prefix="rll3_") as root:
        out["offline"] = rll3_offline(dev, seed, root)
    out["peak_gb"] = peak_bytes(dev) / 1e9
    out["wall_s"] = time.perf_counter() - t0
    online = {"DQN": out["DQN"], "SAC discrete": out["SAC"]["discrete"],
              "SAC continuous": out["SAC"]["continuous"], "TD3": out["TD3"]}
    out["summary"] = {
        "env_steps_per_s": {k: v["env_steps_per_s"]
                            for k, v in online.items()},
        "update_ms_median": dict(
            {k: v["update_ms_median"] for k, v in online.items()},
            **{k: out["offline"][k]["update_ms_median"]
               for k in ("CQL", "BC", "MARWIL")}),
        "burst_ms": out["SAC"]["continuous"]["burst"]["burst_ms"],
        "singles_ms": out["SAC"]["continuous"]["burst"]["singles_ms"],
        "peak_gb": out["peak_gb"], "wall_s": out["wall_s"]}
    print("rll3 " + json.dumps(out), flush=True)
    return out


def rllib_phases(dev, card: str, seed: int):
    """RLL1, RLL2 and RLL3 after EL1, on the caller's runtime where it
    shares one, else each on a runtime of its own."""
    return {name: on_own_runtime(name, dev, phase, card, seed)
            for name, phase in (("RLL1", phase_rll1), ("RLL2", phase_rll2),
                                ("RLL3", phase_rll3))}


# -------------------------------------------- the trainer and the tuner
TR_LAYERS = 1          # TN1's depth: 0.61 B parameters, about 9.8 GB of state
TR_STEPS = 3            # 4 until the 900 s budget
TR_ROWS = 2            # global batch 2 x 2048, one row a rank (fsdp 2)
TR_CKPT_STEP = 0       # rank 0 reports the gathered state after this step
TR_KILL_STEP = 2       # rank 1 dies after this step's update, once
TR_LR = 1e-4
TR_RESUME_REL = 1e-5   # a re-run step's loss against the killed attempt's
TN_LAYERS = 1
TN_STEPS = 3
TN_ROWS = 1
TN_LRS = (1e-4, 3e-4)


def tr_batch(cfg, seed: int, step: int, rows: int):
    """The global batch of ``step``, seeded by it: tokens from an eighth
    of the vocabulary, what a model learns within a few steps, so that
    the loss falls."""
    rng = np.random.default_rng(seed * 1000 + step)
    return {"input_ids": rng.integers(0, cfg.vocab_size // 8,
                                      (rows, cfg.max_seq_len))}


def tr_log(config, rank: int, rec: dict) -> None:
    """One line of this worker's log in the run's directory (the driver
    reads every rank's, the killed one's too, after the fit)."""
    path = os.path.join(config["dir"], f"lr{config['lr']:g}-rank{rank}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def tr_logs(root: str, lr: float, world: int):
    out = []
    for r in range(world):
        with open(os.path.join(root, f"lr{lr:g}-rank{r}.jsonl")) as f:
            out.append([json.loads(line) for line in f])
    return out


def tr_gathered(state, cfg, mesh):
    """The one-device train state of a sharded one as numpy, in the
    checkpoint layout (every rank of the mesh calls it)."""
    from ray_tpu_torch._bridge import gather_to_numpy
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    opt = state["opt_state"]
    return {"params": gather_to_numpy(state["params"], cfg, mesh, FSDP_RULES),
            "opt_state": {
                "count": opt["count"].cpu().numpy(),
                "mu": gather_to_numpy(opt["mu"], cfg, mesh, FSDP_RULES),
                "nu": gather_to_numpy(opt["nu"], cfg, mesh, FSDP_RULES)},
            "step": state["step"].cpu().numpy()}


def dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def tr_worker(config):
    """A ``TorchTrainer`` worker of TR1, TN1 and D1: GPT-J-6B width at
    ``layers``, ``make_train_step`` over ``MeshSpec(fsdp=world)`` on the
    gang's process group (one device for one worker), from the trainer's
    checkpoint where it has one; each step's loss gathered from every
    rank, logged and reported. Its rows are ``tr_batch``'s, or with
    ``data`` (D1) one row a step from the worker's shard of the
    trainer's ``"train"`` dataset (:func:`shard_batches`). With
    ``kill``: after step TR_CKPT_STEP
    the gathered params and moments go to rank 0's report through
    ``Checkpoint.from_torch``, and on the first attempt rank 1 dies
    right after its step-TR_KILL_STEP update (the last step's)."""
    import shutil

    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch._bridge import (shard_train_state_from_jax,
                                       train_state_from_jax)
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    t_enter = time.time()
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = torch.device(config["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    cfg = shard_model(config["layers"])
    mesh = build_mesh(MeshSpec(fsdp=world), device_type=dev.type) \
        if world > 1 else None
    bundle = make_train_step(cfg, mesh, FSDP_RULES if mesh else None,
                             learning_rate=config["lr"], remat_policy="dots",
                             ce_chunk_size=512, device=dev)
    ckpt = train.get_checkpoint()
    t0 = time.perf_counter()
    if ckpt is None:
        state = bundle.init(seed=config["seed"])
    else:
        tree = ckpt.to_torch()
        state = shard_train_state_from_jax(
            tree, cfg, mesh, FSDP_RULES, device=dev) if mesh \
            else train_state_from_jax(tree, cfg, dev)
        del tree
    if cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    killed = os.path.join(config["dir"], "killed.json")
    attempt = int(os.path.exists(killed))
    reset_flash_counts()
    if config.get("data"):
        batches = shard_batches(train.get_dataset_shard("train"), world, dev)
    else:
        batches = ((step, bundle.local_batch(tr_batch(
            cfg, config["seed"], step, config["rows"])), {})
            for step in range(int(state["step"]), config["steps"]))
    for step, batch, row in batches:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = bundle.step_fn(state, batch)
        loss = m["loss"].item()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [loss]
        if world > 1:
            losses = [None] * world
            dist.all_gather_object(losses, loss)
        tr_log(config, rank, {
            "kind": "step", "attempt": attempt, "step": step,
            "losses": losses, "wall_s": wall, "t_enter": t_enter,
            "t_done": time.time(), "load_s": load_s, "world": world,
            "launches": flash_counts(), "device": device_name(dev),
            "current": f"cuda:{torch.cuda.current_device()}" if cuda
            else "cpu", "pid": os.getpid(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else 0.0, **row})
        if config["kill"] and step == TR_KILL_STEP and rank == 1 \
                and attempt == 0:
            with open(killed, "w") as f:
                json.dump({"t": time.time()}, f)
            os._exit(1)
        out, rec = None, {}
        if config["kill"] and step == TR_CKPT_STEP:
            t0 = time.perf_counter()
            full = tr_gathered(state, cfg, mesh)
            rec["gather_s"] = time.perf_counter() - t0
            if rank == 0:
                t0 = time.perf_counter()
                out = train.Checkpoint.from_torch(full, step=step)
                rec["write_s"] = time.perf_counter() - t0
                rec["gb"] = dir_gb(out.path)
            del full
        t0 = time.perf_counter()
        train.report({"step": step, "loss": loss}, checkpoint=out)
        if out is not None:
            # the report copied it into the run's storage
            rec["report_s"] = time.perf_counter() - t0
            shutil.rmtree(out.path, ignore_errors=True)
            tr_log(config, rank, dict(rec, kind="checkpoint",
                                      attempt=attempt, step=step))
    del state, bundle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def check_tr_ranks(name: str, dev, logs, layers: int):
    """Each attempt of each rank: every worker on this card (``cuda:0``),
    each flash kernel launched ``layers`` x the attempt's steps."""
    want = "cuda:0" if dev.type == "cuda" else "cpu"
    for r, lines in enumerate(logs):
        steps = [x for x in lines if x["kind"] == "step"]
        for x in steps:
            check(x["current"] == want and x["device"] == device_name(dev),
                  f"{name} rank {r} ran on {x['current']} "
                  f"({x['device']}), not {want}")
        for attempt in sorted({x["attempt"] for x in steps}):
            mine = [x for x in steps if x["attempt"] == attempt]
            for n, c in mine[-1]["launches"].items():
                check(c == layers * len(mine),
                      f"{name} rank {r} attempt {attempt}: {n} launched "
                      f"{c} times, not {layers} x {len(mine)}")


def phase_tr1(dev, card: str, seed: int):
    """TR1: a ``TorchTrainer`` of two workers (half the card each, gloo)
    at GPT-J-6B width and TR_LAYERS layers over ``MeshSpec(fsdp=2)``,
    steps 0-2 on 2 x 2048; the gathered state reported after step 0
    (``num_to_keep=1``); rank 1 killed after its first step-2 update;
    the gang restarted from the step-0 checkpoint (``max_failures=1``).
    Checks: no error, one restart, the re-run steps 1 and 2's losses
    within TR_RESUME_REL of the killed attempt's (step 2's after an
    update from the restored Adam moments and count), losses equal on
    both ranks and falling, every worker on ``cuda:0``, the flash
    launches, the final checkpoint loading back with its step."""
    import shutil
    import tempfile

    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)
    root = tempfile.mkdtemp(prefix="tr1_")
    try:
        config = {"layers": TR_LAYERS, "rows": TR_ROWS, "steps": TR_STEPS,
                  "lr": TR_LR, "seed": seed, "device": str(dev),
                  "dir": root, "kill": True}
        trainer = TorchTrainer(
            tr_worker, train_loop_config=config,
            torch_config=TorchConfig(backend="gloo"),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True,
                resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(
                name="tr1", storage_path=os.path.join(root, "runs"),
                checkpoint_config=CheckpointConfig(num_to_keep=1),
                failure_config=FailureConfig(max_failures=1)))
        t_fit = time.time()
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"TR1 fit failed: {result.error!r}")
        logs = tr_logs(root, TR_LR, 2)
        with open(os.path.join(root, "killed.json")) as f:
            killed = json.load(f)
        steps = [[x for x in lines if x["kind"] == "step"] for lines in logs]
        order = [(x["attempt"], x["step"]) for x in steps[0]]
        again = range(TR_CKPT_STEP + 1, TR_STEPS)
        check(order == [(0, s) for s in range(TR_KILL_STEP + 1)]
              + [(1, s) for s in again],
              f"TR1 attempts and steps on rank 0: {order}, not one restart "
              f"from step {TR_CKPT_STEP}'s checkpoint")
        losses = {(x["attempt"], x["step"]): x["losses"] for x in steps[0]}
        check(all(ls[0] == ls[1] for ls in losses.values()),
              f"TR1 losses differ between ranks: {losses}")
        killed_losses = {s: losses[(0, s)][0] for s in again}
        rerun = {s: losses[(1, s)][0] for s in again}
        gap = {s: abs(rerun[s] - killed_losses[s]) / abs(killed_losses[s])
               for s in again}
        for s in again:
            check(gap[s] <= TR_RESUME_REL,
                  f"TR1 step {s} re-run loss {rerun[s]} against the killed "
                  f"attempt's {killed_losses[s]}: rel {gap[s]}")
        check(losses[(1, TR_STEPS - 1)][0] < losses[(0, 0)][0],
              f"TR1 loss did not fall: {losses}")
        check_tr_ranks("TR1", dev, logs, TR_LAYERS)
        t0 = time.perf_counter()
        tree = result.checkpoint.to_torch()
        read_s = time.perf_counter() - t0
        ck_step = result.checkpoint.to_dict()["step"]
        check(ck_step == TR_CKPT_STEP and int(tree["step"]) == TR_CKPT_STEP
              + 1 and tuple(tree["params"]["embed"].shape) == (
                  shard_model(TR_LAYERS).vocab_size,
                  shard_model(TR_LAYERS).d_model),
              f"TR1 final checkpoint: step {ck_step}, state step "
              f"{int(tree['step'])}")
        del tree
        ck = [x for x in logs[0] if x["kind"] == "checkpoint"][0]
        S = shard_model(TR_LAYERS).max_seq_len
        first = min(x["t_enter"] for lines in steps for x in lines
                    if x["attempt"] == 0)
        second = min(x["t_enter"] for lines in steps for x in lines
                     if x["attempt"] == 1)
        back = max(x["t_done"] for lines in steps for x in lines
                   if (x["attempt"], x["step"]) == (1, TR_CKPT_STEP + 1))
        out = {"card": card, "config": f"gptj-6b n_layers={TR_LAYERS}",
               "params": shard_model(TR_LAYERS).num_params,
               "mesh": {"fsdp": 2}, "backend": "gloo",
               "gpus_a_worker": 0.5, "batch": [TR_ROWS, S],
               "fit_s": fit_s,
               "gang_start_s": {"first": first - t_fit,
                                "after_restart": second - killed["t"]},
               "restart_s": back - killed["t"],
               "load_s_after_restart": [
                   [x for x in st if x["attempt"] == 1][0]["load_s"]
                   for st in steps],
               "steps": [{"attempt": a, "step": s,
                          "loss": losses[(a, s)][0],
                          "wall_s": max(x["wall_s"] for st in steps
                                        for x in st
                                        if (x["attempt"], x["step"])
                                        == (a, s)),
                          "tokens_per_s": TR_ROWS * S / max(
                              x["wall_s"] for st in steps for x in st
                              if (x["attempt"], x["step"]) == (a, s))}
                         for a, s in order],
               "killed_losses": killed_losses, "rerun_losses": rerun,
               "resume_rel": gap,
               "checkpoint": {"gb": ck["gb"], "gather_s": ck["gather_s"],
                              "write_s": ck["write_s"],
                              "report_s": ck["report_s"],
                              "read_s_driver": read_s},
               "peak_gb_a_rank": [max(x["peak_gb"] for x in st)
                                  for st in steps],
               "launches": [[x for x in st if x["attempt"] == 1][-1][
                   "launches"] for st in steps],
               "devices": sorted({x["current"] for st in steps
                                  for x in st})}
        print("tr1 " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_tn1(dev, card: str, seed: int):
    """TN1: ``Tuner`` over a ``TorchTrainer`` of one worker (half the
    card) sweeping lr over TN_LRS, each trial GPT-J-6B width at
    TN_LAYERS layer, 1 x 2048, TN_STEPS steps. Checks: no error, two
    trials, the best result the trial with the lower last loss, world
    size 1, each trial on ``cuda:0`` with its flash launches."""
    import shutil
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.tune import TuneConfig, Tuner
    root = tempfile.mkdtemp(prefix="tn1_")
    try:
        config = {"layers": TN_LAYERS, "rows": TN_ROWS, "steps": TN_STEPS,
                  "lr": TN_LRS[0], "seed": seed, "device": str(dev),
                  "dir": root, "kill": False}
        trainer = TorchTrainer(
            tr_worker, train_loop_config=config,
            scaling_config=ScalingConfig(
                num_workers=1, use_gpu=True,
                resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(storage_path=os.path.join(root, "inner")))
        t_fit = time.time()
        t0 = time.perf_counter()
        grid = Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(TN_LRS))}},
            tune_config=TuneConfig(metric="loss", mode="min"),
            run_config=RunConfig(name="tn1",
                                 storage_path=os.path.join(root, "runs")),
        ).fit()
        fit_s = time.perf_counter() - t0
        check(grid.num_errors == 0, f"TN1 trials failed: {grid.errors}")
        check(len(grid) == len(TN_LRS), f"TN1 ran {len(grid)} trials")
        trials = []
        for lr in TN_LRS:
            logs = tr_logs(root, lr, 1)
            check_tr_ranks(f"TN1 lr={lr:g}", dev, logs, TN_LAYERS)
            st = [x for x in logs[0] if x["kind"] == "step"]
            check([x["step"] for x in st] == list(range(TN_STEPS))
                  and all(x["world"] == 1 for x in st),
                  f"TN1 lr={lr:g}: steps {[x['step'] for x in st]}, world "
                  f"{[x['world'] for x in st]}")
            trials.append({
                "lr": lr, "losses": [x["losses"][0] for x in st],
                "start_s": st[0]["t_enter"] - t_fit,
                "wall_s": st[-1]["t_done"] - st[0]["t_enter"],
                "first_step_s": st[0]["wall_s"],
                "step_walls_s": [x["wall_s"] for x in st],
                "t": [st[0]["t_enter"], st[-1]["t_done"]],
                "launches": st[-1]["launches"], "device": st[-1]["current"],
                "peak_gb": max(x["peak_gb"] for x in st)})
        best = grid.get_best_result()
        low = min(trials, key=lambda t: t["losses"][-1])
        check(best.metrics["loss"] == low["losses"][-1]
              and best.metrics["config"]["train_loop_config"]["lr"]
              == low["lr"],
              f"TN1 best result {best.metrics.get('loss')} is not the trial "
              f"with the lower last loss {low['losses'][-1]}")
        (a0, a1), (b0, b1) = trials[0]["t"], trials[1]["t"]
        out = {"card": card, "config": f"gptj-6b n_layers={TN_LAYERS}",
               "params": shard_model(TN_LAYERS).num_params,
               "batch": [TN_ROWS, shard_model(TN_LAYERS).max_seq_len],
               "gpus_a_trial": 0.5, "fit_s": fit_s, "trials": trials,
               "best_lr": best.metrics["config"]["train_loop_config"]["lr"],
               "overlapped": a0 < b1 and b0 < a1}
        print("tn1 " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_tune_phases(dev, card: str, seed: int):
    """TR1 and TN1 after RLL3, on the caller's runtime where it shares
    one, else each on a runtime of its own."""
    return {name: on_own_runtime(name, dev, phase, card, seed)
            for name, phase in (("TR1", phase_tr1), ("TN1", phase_tn1))}


# ------------------------------ a dataset into a trainer, PBT on the card
D1_LAYERS = 1          # TN1's depth
D1_ROWS = 6            # three steps a rank: fsdp 2, one row a rank a step
D1_BLOCKS = 3
D1_LR = 1e-4
D1_FIT_S = 600.0       # the fit (pipeline included) must return within this
TN2_LAYERS = 1
TN2_STEPS = 3          # each trial stops once its state has taken 3 steps
TN2_MUTATIONS = (1e-4, 2e-4, 3e-4)
TN2_LRS = (1e-4, 3e-4)
#: a restore frees the trial's state before it loads another: the load's
#: peak stays within one state and this much more
TN2_LOAD_SLACK_GB = 1.0
TN2_FIT_S = 900.0


def within(seconds: float, what: str, fn):
    """``fn()`` on a daemon thread, failing with its own message if it
    has not returned within ``seconds`` (the script must not hang)."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            box["err"] = e
    t = threading.Thread(target=run, daemon=True, name=what)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise SmokeFailure(f"{what} did not return within {seconds:.0f} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def d1_rows(batch, layers: int, seed: int):
    """``map_batches`` body of D1's dataset: each row's ``input_ids`` are
    ``tr_batch``'s for the row's id as the step, its ``id`` kept."""
    cfg = shard_model(layers)
    ids = batch["id"]
    return {"id": ids, "input_ids": np.stack([
        tr_batch(cfg, seed, int(i), 1)["input_ids"][0] for i in ids])}


def d1_dataset(seed: int):
    """D1's pipeline: ``range`` -> ``map_batches`` -> ``random_shuffle``."""
    import functools

    from ray_tpu_torch import data
    return (data.range(D1_ROWS, parallelism=D1_BLOCKS)
            .map_batches(functools.partial(d1_rows, layers=D1_LAYERS,
                                           seed=seed))
            .random_shuffle(seed=seed))


def shard_batches(shard, world: int, dev):
    """This rank's steps from its dataset shard, one row a step, as
    (step, the row on the device with its loss mask, what the log keeps:
    the row's id, a digest of its tokens, its bytes, and at step 0 the
    wall from the iterator's creation to the first batch). The ranks
    agree at each step that every one of them has a row, and all fail
    with their own message if some have one and others do not (a sharded
    step would wait for the missing rank for good)."""
    import hashlib

    import torch.distributed as dist
    t0 = time.perf_counter()
    it = iter(shard.iter_batches(batch_size=1, batch_format="numpy"))
    step = 0
    while True:
        batch = next(it, None)
        first_s = time.perf_counter() - t0
        have = [batch is not None]
        if world > 1:
            have = [None] * world
            dist.all_gather_object(have, batch is not None)
        if not any(have):
            return
        if not all(have):
            raise RuntimeError(
                f"the dataset's shards ran out of step at step {step}: "
                f"ranks holding a row {have}")
        ids = batch["input_ids"]
        rec = {"ids": [int(i) for i in batch["id"]],
               "sha1": hashlib.sha1(np.ascontiguousarray(ids)).hexdigest(),
               "dtype": str(ids.dtype), "shape": list(ids.shape),
               "row_bytes": int(ids.nbytes + batch["id"].nbytes)}
        if step == 0:
            rec["first_batch_s"] = first_s
        t = torch.tensor(ids, device=dev)   # the batch views the store
        yield step, {"input_ids": t, "loss_mask": torch.ones(
            t.shape, dtype=torch.float32, device=dev)}, rec
        step += 1


def phase_d1(dev, card: str, seed: int):
    """D1: ``ray_tpu_torch.data`` into a ``TorchTrainer``: D1_ROWS rows
    through ``range`` -> ``map_batches`` (each row's tokens built from
    its id) -> ``random_shuffle``, streamed as ``datasets={"train": ds}``
    into two workers (half the card each, gloo) at GPT-J-6B width and
    D1_LAYERS layer over ``MeshSpec(fsdp=2)``; each worker steps on one
    row of its shard at a time. Checks: the fit returns within D1_FIT_S
    with no error, every id consumed once and 3 rows a rank, each rank's
    row bit-equal to the one rebuilt here from its id, losses equal on
    both ranks, finite and falling, step 0's loss within
    P2_LOSS_REL_BOUND of a one-device step from the same initial state
    on the two ranks' rows in rank order, the flash launches on
    ``cuda:0``; the store's live GB back after the fit (on_own_runtime)."""
    import hashlib
    import shutil
    import tempfile

    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, \
        TorchTrainer
    root = tempfile.mkdtemp(prefix="d1_")
    try:
        config = {"layers": D1_LAYERS, "lr": D1_LR, "seed": seed,
                  "device": str(dev), "dir": root, "kill": False,
                  "data": True}
        trainer = TorchTrainer(
            tr_worker, train_loop_config=config,
            torch_config=TorchConfig(backend="gloo"),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True,
                resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(name="d1",
                                 storage_path=os.path.join(root, "runs")),
            datasets={"train": d1_dataset(seed)})
        t0 = time.perf_counter()
        result = within(D1_FIT_S, "D1's fit", trainer.fit)
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"D1 fit failed: {result.error!r}")
        logs = tr_logs(root, D1_LR, 2)
        steps = [[x for x in lines if x["kind"] == "step"] for lines in logs]
        ids = [[i for x in st for i in x["ids"]] for st in steps]
        check(sorted(i for r in ids for i in r) == list(range(D1_ROWS))
              and [len(r) for r in ids] == [D1_ROWS // 2] * 2,
              f"D1 ranks consumed ids {ids}, not each of {D1_ROWS} once "
              f"and {D1_ROWS // 2} a rank")
        cfg = shard_model(D1_LAYERS)
        for r, st in enumerate(steps):
            for x in st:
                want = tr_batch(cfg, seed, x["ids"][0], 1)["input_ids"]
                check(x["sha1"] == hashlib.sha1(want).hexdigest()
                      and x["dtype"] == str(want.dtype)
                      and x["shape"] == list(want.shape),
                      f"D1 rank {r} step {x['step']}: row {x['ids']} is "
                      f"not the one its id builds")
        losses = [x["losses"] for x in steps[0]]
        check([x["losses"] for x in steps[1]] == losses
              and all(ls[0] == ls[1] for ls in losses),
              f"D1 losses differ between ranks: {losses}")
        first, last = losses[0][0], losses[-1][0]
        check(all(math.isfinite(ls[0]) for ls in losses) and last < first,
              f"D1 losses not finite and falling: {losses}")
        check_tr_ranks("D1", dev, logs, D1_LAYERS)
        # step 0 on one device from the same initial state, on the rows
        # the two ranks took at step 0, in rank order
        bundle = make_train_step(cfg, learning_rate=D1_LR,
                                 remat_policy="dots", ce_chunk_size=512,
                                 device=dev)
        state = bundle.init(seed=seed)
        batch = np.concatenate([tr_batch(cfg, seed, st[0]["ids"][0], 1)[
            "input_ids"] for st in steps])
        _, m = bundle.step(state, {"input_ids": batch})
        one = m["loss"].item()
        del state, bundle, m
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rel = abs(first - one) / abs(one)
        check(rel <= P2_LOSS_REL_BOUND,
              f"D1 step 0 loss {first} against one device's {one}: rel "
              f"{rel} > {P2_LOSS_REL_BOUND}")
        S = cfg.max_seq_len
        out = {"card": card, "config": f"gptj-6b n_layers={D1_LAYERS}",
               "params": cfg.num_params, "mesh": {"fsdp": 2},
               "backend": "gloo", "gpus_a_worker": 0.5,
               "rows": D1_ROWS, "blocks": D1_BLOCKS, "fit_s": fit_s,
               "ids_a_rank": ids,
               "first_batch_s": [st[0]["first_batch_s"] for st in steps],
               "rows_bytes": sum(x["row_bytes"] for st in steps
                                 for x in st),
               "steps": [{"step": x["step"], "loss": x["losses"][0],
                          "wall_s": max(st[x["step"]]["wall_s"]
                                        for st in steps),
                          "tokens_per_s": 2 * S / max(
                              st[x["step"]]["wall_s"] for st in steps)}
                         for x in steps[0]],
               "one_device_loss": one, "loss_rel": rel,
               "peak_gb_a_rank": [max(x["peak_gb"] for x in st)
                                  for st in steps],
               "launches": [st[-1]["launches"] for st in steps],
               "devices": sorted({x["current"] for st in steps
                                  for x in st})}
        print("d1 " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def state_sums(state):
    """Two checksums of each leaf's bits, taken on the leaf's device: the
    sum of its 32-bit words and their sum weighted by position (mod
    65521, plus one), both in int64, by ``/``-joined path."""
    from ray_tpu_torch.models.training import _get, _paths
    out = {}
    chunk = 1 << 24
    for path in _paths(state):
        x = _get(state, path).detach().reshape(-1).view(torch.int32)
        w = (torch.arange(min(chunk, x.numel()), device=x.device,
                          dtype=torch.int64) % 65521) + 1
        s = torch.zeros((), dtype=torch.int64, device=x.device)
        p = torch.zeros((), dtype=torch.int64, device=x.device)
        for c in x.split(chunk):
            c = c.to(torch.int64)
            s += c.sum()
            p += (c * w[:c.numel()]).sum()
        out["/".join(path)] = [int(s), int(p)]
    return out


def tn2_trainable():
    """TN2's trial: a ``tune.Trainable`` holding a one-device GPT-J-6B
    train state at TN2_LAYERS layer (built at its first step unless a
    restore brings one); ``step`` trains on ``tr_batch`` of the state's
    step and returns the loss (taken before the update), ``save_checkpoint``
    writes the whole state (params and Adam moments) through
    ``Checkpoint.from_torch`` with the checksums of its bits,
    ``load_checkpoint`` frees the state and reads the saved one onto the
    device, and ``reset_config`` sets the optimizer's learning rate in
    place. Each call is logged to the trial's lines in ``config["dir"]``."""
    from ray_tpu_torch import tune

    class GPTJTrial(tune.Trainable):
        def setup(self, config):
            from ray_tpu_torch.models import make_train_step
            from ray_tpu_torch.models.training import default_optimizer
            from ray_tpu_torch.tune._trial_context import get_trial_dir
            self.dev = torch.device(config["device"])
            self.cuda = self.dev.type == "cuda"
            if self.cuda:
                torch.cuda.set_device(self.dev)
                torch.cuda.reset_peak_memory_stats()
            self.cfg = shard_model(config["layers"])
            self.opt = default_optimizer(config["lr"])
            self.bundle = make_train_step(
                self.cfg, optimizer=self.opt, remat_policy="dots",
                ce_chunk_size=512, device=self.dev)
            self.state = None
            self.trial = os.path.basename(get_trial_dir() or "trial")
            self.steps_here = 0
            reset_flash_counts()
            self.log({"kind": "setup"})

        def log(self, rec):
            rec = dict(rec, trial=self.trial, pid=os.getpid(),
                       lr=self.opt.learning_rate, t=time.time(),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9
                       if self.cuda else 0.0)
            path = os.path.join(self.config["dir"], f"{self.trial}.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        def sync(self):
            if self.cuda:
                torch.cuda.synchronize()

        def step(self):
            if self.state is None:
                self.state = self.bundle.init(seed=self.config["seed"])
            k = int(self.state["step"])
            batch = self.bundle.local_batch(
                tr_batch(self.cfg, self.config["seed"], k, 1))
            self.sync()
            t0 = time.perf_counter()
            self.state, m = self.bundle.step_fn(self.state, batch)
            loss = m["loss"].item()
            self.sync()
            self.steps_here += 1
            self.log({"kind": "step", "state_step": k, "loss": loss,
                      "wall_s": time.perf_counter() - t0,
                      "steps_here": self.steps_here,
                      "launches": flash_counts(),
                      "device": device_name(self.dev),
                      "current": f"cuda:{torch.cuda.current_device()}"
                      if self.cuda else "cpu"})
            return {"loss": loss, "step": k + 1}

        def save_checkpoint(self, checkpoint_dir):
            from ray_tpu_torch.train import Checkpoint
            t0 = time.perf_counter()
            sums = state_sums(self.state)
            ck = Checkpoint.from_torch(self.state)
            for name in os.listdir(ck.path):
                os.replace(os.path.join(ck.path, name),
                           os.path.join(checkpoint_dir, name))
            os.rmdir(ck.path)
            self.log({"kind": "save", "dir": checkpoint_dir,
                      "state_step": int(self.state["step"]), "sums": sums,
                      "save_s": time.perf_counter() - t0,
                      "gb": dir_gb(checkpoint_dir)})
            return checkpoint_dir

        def load_checkpoint(self, checkpoint_dir):
            from ray_tpu_torch.models.training import tree_map
            from ray_tpu_torch.train import Checkpoint
            t0 = time.perf_counter()
            self.state = None           # one state at a time on the card
            gc.collect()
            if self.cuda:
                torch.cuda.reset_peak_memory_stats()
            tree = Checkpoint(checkpoint_dir).to_torch()
            self.state = tree_map(lambda t: t.to(self.dev), tree)
            del tree
            self.sync()
            load_s = time.perf_counter() - t0
            self.log({"kind": "load", "dir": checkpoint_dir,
                      "state_step": int(self.state["step"]),
                      "sums": state_sums(self.state), "load_s": load_s,
                      "load_peak_gb": torch.cuda.max_memory_allocated()
                      / 1e9 if self.cuda else 0.0})

        def reset_config(self, new_config):
            self.opt.learning_rate = new_config["lr"]
            self.log({"kind": "reset"})
            return True

    return GPTJTrial


def tn2_logs(root: str):
    out = {}
    for name in sorted(os.listdir(root)):
        if name.endswith(".jsonl"):
            with open(os.path.join(root, name)) as f:
                out[name[:-len(".jsonl")]] = [json.loads(x) for x in f]
    return out


def phase_tn2(dev, card: str, seed: int):
    """TN2: ``PopulationBasedTraining`` over two trials of a class
    ``Trainable`` (half the card each) at lr TN2_LRS, each holding a
    GPT-J-6B train state at TN2_LAYERS layer on the card; synchronous
    rounds (as the JAX package's own PBT test: the exploit is then the
    same under any interleaving) every 2 iterations, the bottom half
    cloning the top half's state through a checkpoint and moving its lr
    to a neighbour in TN2_MUTATIONS; each trial stops once its state has
    taken TN2_STEPS steps; no save at a trial's end. Checks: no error,
    at least one exploit, the target's params and moments after the
    restore bit-equal (checksums on the card) to what the source saved,
    the target's lr a neighbour of the source's, the target's next loss
    bit-equal to the source's from the same state on the same batch, the
    restore's peak within one state (TN2_LOAD_SLACK_GB), every step on
    ``cuda:0`` and each flash kernel launched TN2_LAYERS x the steps each
    trial actor took."""
    import shutil
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import CheckpointConfig, RunConfig
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining
    root = tempfile.mkdtemp(prefix="tn2_")
    logs_dir = os.path.join(root, "logs")
    os.makedirs(logs_dir)
    try:
        pbt = PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2,
            quantile_fraction=0.5,
            hyperparam_mutations={"lr": list(TN2_MUTATIONS)}, synch=True,
            seed=0)
        trial_cls = tune.with_resources(tn2_trainable(),
                                        {"CPU": 1, "GPU": 0.5})
        tuner = Tuner(
            trial_cls,
            param_space={"lr": tune.grid_search(list(TN2_LRS)),
                         "layers": TN2_LAYERS, "seed": seed,
                         "device": str(dev), "dir": logs_dir},
            tune_config=TuneConfig(metric="loss", mode="min",
                                   scheduler=pbt),
            run_config=RunConfig(
                name="tn2", storage_path=os.path.join(root, "runs"),
                stop={"step": TN2_STEPS},
                checkpoint_config=CheckpointConfig(checkpoint_at_end=False)))
        t0 = time.perf_counter()
        grid = within(TN2_FIT_S, "TN2's fit", tuner.fit)
        fit_s = time.perf_counter() - t0
        check(grid.num_errors == 0, f"TN2 trials failed: {grid.errors}")
        check(pbt.perturbation_count >= 1,
              f"TN2 made {pbt.perturbation_count} exploits")
        logs = tn2_logs(logs_dir)
        saves = {x["dir"]: x for lines in logs.values() for x in lines
                 if x["kind"] == "save"}
        exploits = []
        for trial, lines in logs.items():
            for i, x in enumerate(lines):
                if x["kind"] != "load" or x["dir"] not in saves \
                        or saves[x["dir"]]["trial"] == trial:
                    continue
                src = saves[x["dir"]]
                after = [y for y in lines[i + 1:] if y["kind"] == "step"
                         and y["pid"] == x["pid"]]
                same = [y for y in logs[src["trial"]]
                        if y["kind"] == "step"
                        and y["state_step"] == src["state_step"]]
                check(x["sums"] == src["sums"],
                      f"TN2 {trial}'s state after the restore differs from "
                      f"what {src['trial']} saved")
                check(x["state_step"] == src["state_step"] and after
                      and same, f"TN2 {trial}: no step after the restore of "
                      f"{src['trial']}'s step-{src['state_step']} state, "
                      f"or none of the source's from it")
                j = TN2_MUTATIONS.index(src["lr"])
                near = {TN2_MUTATIONS[max(0, min(len(TN2_MUTATIONS) - 1,
                                                 j + d))] for d in (-1, 1)}
                check(after[0]["lr"] in near,
                      f"TN2 {trial}'s lr {after[0]['lr']} is not a "
                      f"neighbour of {src['trial']}'s {src['lr']}")
                check(after[0]["loss"] == same[0]["loss"],
                      f"TN2 {trial}'s loss {after[0]['loss']} from the "
                      f"cloned state is not {src['trial']}'s "
                      f"{same[0]['loss']}")
                one_state = src["gb"]
                check(x["load_peak_gb"] <= one_state + TN2_LOAD_SLACK_GB,
                      f"TN2 {trial}'s restore peaked at {x['load_peak_gb']}"
                      f" GB, over one {one_state} GB state")
                exploits.append({
                    "target": trial, "source": src["trial"],
                    "state_step": src["state_step"],
                    "lr": [src["lr"], after[0]["lr"]],
                    "loss": [same[0]["loss"], after[0]["loss"]],
                    "save_s": src["save_s"], "load_s": x["load_s"],
                    "gb": src["gb"], "load_peak_gb": x["load_peak_gb"]})
        check(len(exploits) >= 1, "TN2: no trial restored another's state")
        want = "cuda:0" if dev.type == "cuda" else "cpu"
        trials = {}
        for trial, lines in logs.items():
            st = [x for x in lines if x["kind"] == "step"]
            for pid in sorted({x["pid"] for x in st}):
                mine = [x for x in st if x["pid"] == pid]
                for n, c in mine[-1]["launches"].items():
                    check(c == TN2_LAYERS * mine[-1]["steps_here"],
                          f"TN2 {trial} actor {pid}: {n} launched {c} "
                          f"times, not {TN2_LAYERS} x "
                          f"{mine[-1]['steps_here']}")
            check(all(x["current"] == want for x in st),
                  f"TN2 {trial} stepped on "
                  f"{sorted({x['current'] for x in st})}, not {want}")
            trials[trial] = {
                "losses": [x["loss"] for x in st],
                "state_steps": [x["state_step"] for x in st],
                "lrs": [x["lr"] for x in st],
                "step_walls_s": [x["wall_s"] for x in st],
                "actors": len({x["pid"] for x in lines}),
                "saves_s": [x["save_s"] for x in lines
                            if x["kind"] == "save"],
                "loads_s": [x["load_s"] for x in lines
                            if x["kind"] == "load"],
                "launches": [[x for x in st if x["pid"] == pid][-1][
                    "launches"] for pid in sorted({x["pid"] for x in st})],
                "peak_gb": max(x["peak_gb"] for x in lines)}
        cfg = shard_model(TN2_LAYERS)
        out = {"card": card, "config": f"gptj-6b n_layers={TN2_LAYERS}",
               "params": cfg.num_params,
               "batch": [1, cfg.max_seq_len], "gpus_a_trial": 0.5,
               "fit_s": fit_s, "exploits": exploits,
               "perturbations": pbt.perturbation_count, "trials": trials}
        print("tn2 " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def data_tune_phases(dev, card: str, seed: int):
    """D1 and TN2 after TN1, on the caller's runtime where it shares one,
    else each on a runtime of its own."""
    return {name: on_own_runtime(name, dev, phase, card, seed)
            for name, phase in (("D1", phase_d1), ("TN2", phase_tn2))}


# ------------------------------------------------------------- DG1, JC1
# dag/ over experimental/'s channels, the dashboard's job submission and
# ray:// client mode, on the runtime S2-JC1 share: a compiled DAG of two
# stage actors runs a GPT-J-6B-width forward through shared-memory
# channels (DG1); a submitted job and a client in another process each
# drive the flash forward on the card through the cluster (JC1).
DG_LAYERS = 2          # one a stage
DG_STAGES = 2
DG_ROWS = 4
JC_SHAPE = (1, 2048, 16, 256)   # GPT-J-6B's attention: B, S, H, D
JC_GPUS = 0.5          # the job's task and the client's actor: half each
JC_JOB_S = 180.0       # each job must reach its end status within this
JC_STOP_S = 30.0
ACTOR_GONE_S = 30.0


class DagStage:
    """One stage of DG1's DAG: its ``stage_slice_params`` slice of the
    seeded model on ``device``. ``forward`` is stage 0's method, ``loss``
    stage 1's."""

    def __init__(self, layers: int, seed: int, stage: int, device: str):
        from ray_tpu_torch.models import init_params
        from ray_tpu_torch.models.transformer import stage_slice_params
        self.cfg = shard_model(layers)
        self.stage = stage
        self.dev = torch.device(device)
        self.params = stage_slice_params(
            self.cfg, init_params(self.cfg, seed=seed, device=self.dev,
                                  dtype=self.cfg.dtype), stage, DG_STAGES)
        self.current = None
        reset_flash_counts()

    def forward(self, ids):
        from ray_tpu_torch.models.transformer import stage_forward
        t = torch.as_tensor(ids, device=self.dev)
        with torch.inference_mode():
            h = stage_forward(self.cfg, 0, DG_STAGES, self.params, t)
        self.current = str(h.device)
        return h, ids

    def loss(self, hop):
        from ray_tpu_torch.models.transformer import stage_forward, \
            stage_loss
        h, ids = hop
        with torch.inference_mode():
            h = stage_forward(self.cfg, 1, DG_STAGES, self.params,
                              h.to(self.dev))
            loss, n = stage_loss(self.cfg, self.params, h,
                                 torch.as_tensor(ids, device=self.dev))
        self.current = str(loss.device)
        return loss, n

    def launches(self):
        return {"launches": flash_counts(), "current": self.current,
                "device": device_name(self.dev), "pid": os.getpid()}


def dg_reference(dev, cfg, seed: int, rows):
    """The two stage functions run here on ``dev`` from ``seed`` on each
    row: (loss, n) a row."""
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.transformer import stage_forward, \
        stage_loss, stage_slice_params
    params = init_params(cfg, seed=seed, device=dev, dtype=cfg.dtype)
    parts = [stage_slice_params(cfg, params, s, DG_STAGES)
             for s in range(DG_STAGES)]
    out = []
    with torch.inference_mode():
        for ids in rows:
            t = torch.as_tensor(ids, device=dev)
            h = stage_forward(cfg, 0, DG_STAGES, parts[0], t)
            h = stage_forward(cfg, 1, DG_STAGES, parts[1], h)
            out.append(stage_loss(cfg, parts[1], h, t))
    return out


def actors_dead(handles, timeout_s: float = ACTOR_GONE_S) -> bool:
    """Whether every actor of ``handles`` is DEAD in the controller's
    table within ``timeout_s``."""
    from ray_tpu_torch.core.global_state import global_worker
    ids = {h._id.hex() for h in handles}
    deadline = time.monotonic() + timeout_s
    while True:
        rows = global_worker().state_query("actors")
        if all(r["state"] == "DEAD" for r in rows if r["actor_id"] in ids):
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.2)


def phase_dg1(dev, card: str, seed: int):
    """DG1: the compiled two-stage DAG over the channels (see the module
    docstring)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.serialization import pickle_inband
    from ray_tpu_torch.dag import InputNode
    cfg = shard_model(DG_LAYERS)
    rows = [tr_batch(cfg, seed, r, 1)["input_ids"] for r in range(DG_ROWS)]
    hop_shape = (1, cfg.max_seq_len, cfg.d_model)
    hop_bytes = len(pickle_inband(("ok", (torch.empty(
        hop_shape, dtype=cfg.dtype), rows[0]))))
    Stage = ray_tpu_torch.remote(num_gpus=0.5, max_concurrency=2)(DagStage)
    with InputNode() as inp:
        s0 = Stage.bind(DG_LAYERS, seed, 0, str(dev))
        s1 = Stage.bind(DG_LAYERS, seed, 1, str(dev))
        dag = s1.loss.bind(s0.forward.bind(inp))
    t0 = time.perf_counter()
    compiled = dag.experimental_compile()
    compiled.channel_capacity = hop_bytes
    submit_s, done_s = [], []
    try:
        refs = []
        for ids in rows:
            refs.append(compiled.execute(ids))
            submit_s.append(time.perf_counter() - t0)
        check(compiled._pipeline is not None,
              "DG1: the compiled DAG took the RPC path, not its channels")
        got = []
        for r in refs:
            got.append(within(ACTOR_TIMEOUT_S, "DG1's get",
                              lambda r=r: ray_tpu_torch.get(r)))
            done_s.append(time.perf_counter() - t0)
        chans = [ch.path for ch in compiled._pipeline.chans]
        actors = list(compiled._persistent_actors.values())
        counts = ray_tpu_torch.get([a.__ray_call__.remote(
            lambda self: self.launches()) for a in actors],
            timeout=ACTOR_TIMEOUT_S)
    finally:
        compiled.teardown()
    teardown_s = time.perf_counter() - t0 - done_s[-1]
    left = [p for p in chans if os.path.exists(p)]
    check(not left, f"DG1 left channel files {left}")
    check(actors_dead(actors), "DG1's stage actors are not dead after "
          "teardown")
    ref = dg_reference(dev, cfg, seed, rows)
    want = "cuda:0" if dev.type == "cuda" else "cpu"
    for r, ((loss, n), (rl, rn)) in enumerate(zip(got, ref)):
        check(isinstance(loss, torch.Tensor) and loss.device.type == "cpu"
              and isinstance(n, torch.Tensor) and n.device.type == "cpu",
              f"DG1 row {r}: get gave {type(loss)} on "
              f"{getattr(loss, 'device', None)}, not a CPU tensor")
        check(math.isfinite(float(loss)), f"DG1 row {r}: loss {loss}")
        check(torch.equal(loss, rl.cpu()) and torch.equal(n, rn.cpu()),
              f"DG1 row {r}: loss {float(loss)!r} (n {float(n)}) against "
              f"the driver's {float(rl)!r} (n {float(rn)})")
    # counts are in the order the stage actors were made: stage 0's first
    for s, c in enumerate(counts):
        check(c["current"] == want and c["device"] == device_name(dev),
              f"DG1 stage actor {s} ran on {c['current']} ({c['device']}), "
              f"not {want}")
        for name, k in c["launches"].items():
            n_want = DG_ROWS if name == "flash_fwd" else 0
            check(k == n_want, f"DG1 stage actor {s}: {name} launched {k} "
                               f"times, not {n_want}")
    out = {"card": card, "config": f"gptj-6b n_layers={DG_LAYERS}",
           "stages": DG_STAGES, "gpus_a_stage": 0.5, "rows": DG_ROWS,
           "hop_shape": list(hop_shape), "hop_bytes": hop_bytes,
           "hop_tensor_bytes": math.prod(hop_shape) * cfg.dtype.itemsize,
           "submit_s": submit_s, "done_s": done_s,
           "first_execute_s": done_s[0],
           "later_execute_s": [b - a for a, b in zip(done_s, done_s[1:])],
           "teardown_s": teardown_s,
           "losses": [float(loss) for loss, _ in got],
           "launches": [c["launches"] for c in counts],
           "stage_pids": [c["pid"] for c in counts]}
    print("dg1 " + json.dumps(out), flush=True)
    return out


def jc_flash(seed: int, device: str, shape):
    """The flash forward's wrapper, causal, on bf16 q, k, v of ``shape``
    (B, S, H, D) drawn from ``seed`` with numpy, on ``device``: the
    output and this process's launch counts. A task asked for the card
    that finds none raises (it never runs on the CPU)."""
    import os

    import numpy as np
    import torch
    from ray_tpu_torch.ops.flash_attention import (flash_delta, flash_dkdv,
                                                   flash_dq, flash_fwd)
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device in this process "
                           f"(CUDA_VISIBLE_DEVICES="
                           f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal(shape, dtype=np.float32))
               .to(device=dev, dtype=torch.bfloat16) for _ in range(3))
    kernels = (flash_fwd, flash_delta, flash_dkdv, flash_dq)
    for f in kernels:
        f.kernel_launches = 0
    o, _ = flash_fwd(q, k, v, causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return o, {"launches": {f.__name__: f.kernel_launches for f in kernels},
               "current": str(o.device), "pid": os.getpid(),
               "checksum": float(o.double().sum())}


JC_JOB_SCRIPT = """
import json
import ray_tpu_torch

{flash}

ray_tpu_torch.init()
task = ray_tpu_torch.remote(num_gpus={gpus})(jc_flash)
o, rec = ray_tpu_torch.get(task.remote({seed}, {device!r}, {shape!r}),
                           timeout=600)
print({tag!r} + json.dumps(rec), flush=True)
ray_tpu_torch.shutdown()
"""

JC_CLIENT_SCRIPT = """
import hashlib, json, time
import torch
import ray_tpu_torch

{flash}

t0 = time.perf_counter()
ray_tpu_torch.init("ray://127.0.0.1:{port}")
connect_s = time.perf_counter() - t0


@ray_tpu_torch.remote(num_gpus={gpus})
class JCActor:
    def run(self, seed, device, shape):
        return jc_flash(seed, device, shape)


actor = JCActor.remote()
o, rec = ray_tpu_torch.get(actor.run.remote({seed}, {device!r}, {shape!r}),
                           timeout=600)
rec.update(first_result_s=time.perf_counter() - t0, connect_s=connect_s,
           got_type=type(o).__name__, got_device=str(o.device),
           got_dtype=str(o.dtype), got_shape=list(o.shape),
           sha256=hashlib.sha256(o.contiguous().view(torch.uint8).numpy()
                                 .tobytes()).hexdigest())
print("jc1-client " + json.dumps(rec), flush=True)
ray_tpu_torch.shutdown()
"""


def tagged(text: str, tag: str):
    """The JSON record after the last ``tag`` in ``text``, or None."""
    for line in reversed(text.splitlines()):
        if tag in line:
            return json.loads(line.split(tag, 1)[1])
    return None


def group_gone(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    return False


def phase_jc1(dev, card: str, seed: int):
    """JC1: a submitted job and a ``ray://`` client on the card (see the
    module docstring)."""
    import hashlib
    import inspect
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import api
    from ray_tpu_torch.job_submission import JobSubmissionClient, JobStatus
    from ray_tpu_torch.util.client import ClientServer
    t0 = time.perf_counter()
    flash = inspect.getsource(jc_flash)
    device = "cuda" if dev.type == "cuda" else "cpu"
    kw = dict(flash=flash, gpus=JC_GPUS, seed=seed, device=device,
              shape=tuple(JC_SHAPE), tag="jc1-job ")
    srv = ClientServer(host="127.0.0.1", port=0).start()
    client_proc = None
    try:
        path = os.path.join(api._head.session_dir, "dashboard.json")
        check(os.path.exists(path), f"JC1: no dashboard.json in the "
                                    f"session ({path})")
        with open(path) as f:
            address = json.load(f)["address"]
        jobs = JobSubmissionClient(address)
        t_submit = time.perf_counter()
        jid = jobs.submit_job(entrypoint=f"{sys.executable} -c "
                              f"{shlex.quote(JC_JOB_SCRIPT.format(**kw))}")
        client_proc = subprocess.Popen(
            [sys.executable, "-c",
             JC_CLIENT_SCRIPT.format(port=srv.port, **kw)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        sleeper = jobs.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
        jm = api._head.dashboard.job_manager
        deadline = time.monotonic() + JC_STOP_S
        while jobs.get_job_status(sleeper) != JobStatus.RUNNING \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        proc = jm._procs.get(sleeper)
        pgid = proc.pid if proc is not None else None
        check(jobs.stop_job(sleeper) is True, "JC1: stop_job refused")
        stopped = jobs.wait_until_status(sleeper, timeout_s=JC_STOP_S)
        stop_s = time.perf_counter() - t_submit
        status = jobs.wait_until_status(jid, timeout_s=JC_JOB_S)
        job_s = time.perf_counter() - t_submit
        logs = jobs.get_job_logs(jid)
        out_c, err_c = client_proc.communicate(timeout=JC_JOB_S)
        client_s = time.perf_counter() - t_submit
        check(status == JobStatus.SUCCEEDED,
              f"JC1: the job ended {status}:\n{logs[-4000:]}")
        check(stopped == JobStatus.STOPPED,
              f"JC1: the sleeping job ended {stopped}, not STOPPED")
        check(pgid is not None and group_gone(pgid),
              f"JC1: the stopped job's processes ({pgid}) are not gone")
        check(client_proc.returncode == 0,
              f"JC1: the client exited {client_proc.returncode}:\n"
              f"{out_c[-2000:]}\n{err_c[-4000:]}")
        job = tagged(logs, "jc1-job ")
        client = tagged(out_c, "jc1-client ")
        check(job is not None and client is not None,
              f"JC1: no record from the job or the client:\n{logs[-2000:]}"
              f"\n{out_c[-2000:]}")
        with urllib.request.urlopen(address + "/api/cluster_status",
                                    timeout=30) as r:
            status_rows = json.load(r)
        gpus = [n["resources_total"].get("GPU") for n in status_rows["nodes"]]
        check(gpus == [1.0], f"JC1: /api/cluster_status lists GPU {gpus}")
    finally:
        if client_proc is not None and client_proc.poll() is None:
            client_proc.kill()
            client_proc.wait()
        srv.stop()
    # the client's actor is released at its disconnect: a whole card's
    # task then finds its GPU
    need = ray_tpu_torch.remote(num_gpus=1.0)(lambda: os.getpid())
    t1 = time.perf_counter()
    whole = within(ACTOR_TIMEOUT_S, "JC1's num_gpus=1 task",
                   lambda: ray_tpu_torch.get(need.remote()))
    whole_s = time.perf_counter() - t1
    ref, ref_rec = jc_flash(seed, str(dev), tuple(JC_SHAPE))
    want = "cuda:0" if dev.type == "cuda" else "cpu"
    check(job["checksum"] == ref_rec["checksum"],
          f"JC1: the job's checksum {job['checksum']!r} against the "
          f"driver's {ref_rec['checksum']!r}")
    sha = hashlib.sha256(ref.cpu().contiguous().view(torch.uint8).numpy()
                         .tobytes()).hexdigest()
    check(client["sha256"] == sha and client["got_type"] == "Tensor"
          and client["got_device"] == "cpu"
          and client["got_dtype"] == str(ref.dtype)
          and client["got_shape"] == list(ref.shape),
          f"JC1: the client's tensor ({client['got_type']} on "
          f"{client['got_device']}, {client['got_dtype']}, sha256 "
          f"{client['sha256'][:16]}) is not the driver's (sha256 "
          f"{sha[:16]})")
    for who, rec in (("job task", job), ("client actor", client)):
        check(rec["current"] == want,
              f"JC1: the {who} ran on {rec['current']}, not {want}")
        for name, k in rec["launches"].items():
            n_want = 1 if name == "flash_fwd" else 0
            check(k == n_want, f"JC1: the {who} launched {name} {k} times, "
                               f"not {n_want}")
    out = {"card": card, "shape": list(JC_SHAPE), "gpus_a_process": JC_GPUS,
           "submit_to_succeeded_s": job_s, "submit_to_stopped_s": stop_s,
           "client_exit_s": client_s,
           "connect_s": client["connect_s"],
           "connect_to_first_result_s": client["first_result_s"],
           "whole_card_task_s": whole_s, "whole_card_task_pid": whole,
           "checksum": ref_rec["checksum"], "sha256": sha,
           "job_launches": job["launches"],
           "client_launches": client["launches"],
           "pids": {"job_task": job["pid"], "client_actor": client["pid"]},
           "wall_s": time.perf_counter() - t0}
    print("jc1 " + json.dumps(out), flush=True)
    return out


def dag_job_phases(dev, card: str, seed: int):
    """DG1 and JC1 after TN2, on the caller's runtime where it shares
    one, else each on a runtime of its own."""
    return {name: on_own_runtime(name, dev, phase, card, seed)
            for name, phase in (("DG1", phase_dg1), ("JC1", phase_jc1))}


# ---------------------------------------------------- AR1, WF1 and CL1
# The slice arbiter moving a card-resident trainer's slice for a serve
# burst, a durable workflow around the flash forward, and the command
# line's cluster round trip, on the runtime S2-JC1 share.
AR_LAYERS = 1
AR_ROWS = 2                # dp=2: one 2048-token row a rank
AR_STEPS = (2, 1, 2)       # steps before the preemption, folded, regrown
#: the JAX colocation test's policy; the gauges' window is the burst's
#: TTFT's reach (the JAX default, 30 s, would keep the held burst's TTFT
#: in the p99 for 30 s after it)
AR_POLICY = dict(queue_high=4.0, queue_low=1.0, ttft_p99_high_ms=2000.0,
                 ttft_p99_low_ms=1000.0, sustain_s=2.0, ebb_s=4.0,
                 window_s=2.0)
AR_TICK_S = 0.2            # the arbiter's update (and the gate's publish)
AR_ACT_S = 120.0           # the preemption and the return within this
AR_TELEMETRY_S = 0.5       # the trainer's telemetry interval (its default)
AR_HOLD_KEY = b"chip_smoke:ar1:hold"


def ar_held() -> bool:
    """Whether AR1's driver still holds the burst at the gate (a key in
    the runtime's internal KV)."""
    from ray_tpu_torch.experimental import internal_kv
    return internal_kv._internal_kv_exists(AR_HOLD_KEY)


def ar_single_streams(engine, prompts, max_new: int):
    """Each prompt served alone through ``engine``, one after another."""
    return [list(engine.generate_sync(p, max_new, timeout_s=ACTOR_TIMEOUT_S))
            for p in prompts]


def rank_probe(rank, what: str):
    """In a plan's rank actor: ``"reset"`` zeroes its flash launch counts;
    ``"read"`` returns them with its pid."""
    if what == "reset":
        reset_flash_counts()
        return None
    return {"launches": flash_counts(), "pid": os.getpid()}


def fleet_row(pid: int, window_s: float):
    from ray_tpu_torch.util.state import fleet_metrics
    rows = [r for r in fleet_metrics(window_s=window_s)["rows"]
            if r["pid"] == pid]
    return rows[0] if rows else None


def phase_ar1(dev, card: str, seed: int):
    """AR1: serving and training share the card, and the slice arbiter
    moves the slice (see the module docstring)."""
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import api, serve
    from ray_tpu_torch.autoscaler import (ArbiterPolicy, FakeSliceProvider,
                                          SliceArbiter, SliceManager,
                                          SliceTypeConfig)
    from ray_tpu_torch.core.global_state import try_global_worker
    from ray_tpu_torch.experimental import internal_kv
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.parallel.elastic import ElasticTrainer
    from ray_tpu_torch.parallel.plan import ParallelPlan
    from ray_tpu_torch.serve import LLMServer
    from ray_tpu_torch.util.state import list_task_events
    t0 = time.perf_counter()
    cfg = pipe_model(AR_LAYERS)
    scfg = shard_model(AR_LAYERS)
    batch = pipe_batch(cfg, seed, AR_ROWS)
    prompts = make_requests(seed, scfg.vocab_size)
    recorder = try_global_worker().recorder
    controller = api._head.controller
    provider = FakeSliceProvider(provider_config={"max_slices": 2})
    mgr = SliceManager(
        SliceHostController(recorder), provider,
        [SliceTypeConfig("train-gpu", "1x1", {"CPU": 4, "GPU": 0.5}),
         SliceTypeConfig("serve-gpu", "1x1", {"CPU": 2, "GPU": 0.5})],
        idle_timeout_s=3600.0, drain_deadline_s=0.0)
    arb = SliceArbiter(mgr, policy=ArbiterPolicy(**AR_POLICY))
    train_sid = mgr.acquire_slice("train-gpu")
    arb.claim(train_sid, owner="train-job", kind="train", priority=0)
    serve_sid = mgr.acquire_slice("serve-gpu")
    arb.claim(serve_sid, owner="serve-fleet", kind="serve", priority=10)
    owned = {train_sid}
    arb.register_on_return(
        lambda info: owned.add(info["slice_id"])
        if info["owner"] == "train-job" else None)
    folded = {"done": False}

    def pump():
        """The manager's reconcile: the hosts of UP slices are busy, and
        the preempted slice's until the trainer has folded off it."""
        busy = set()
        for sid, info in mgr.slices.items():
            if info.state == "UP" or (sid == train_sid
                                      and not folded["done"]):
                busy |= set(provider.internal_ids(sid))
        alive = {h for sid in provider.non_terminated_nodes()
                 for h in provider.internal_ids(sid)}
        mgr.update({"demand": [], "slice_demand": [], "busy_nodes": busy,
                    "alive_nodes": alive})

    ticks = []

    def tick():
        pump()
        out = arb.update()
        ticks.append(dict(out, t=time.perf_counter() - t0,
                          gauges=dict(arb._last_gauges)))
        return out

    pump()
    controller.slice_arbiter = arb
    internal_kv._internal_kv_put(AR_HOLD_KEY, b"hold")
    params = init_params(scfg, seed=seed, device=dev, dtype=scfg.dtype)
    checksum = weights_checksum(params)
    del params
    res = {"card": card, "config": f"gptj-6b n_layers={AR_LAYERS}",
           "plan": "dp=2", "batch": [AR_ROWS, cfg.max_seq_len],
           "policy": AR_POLICY, "burst": len(prompts)}
    trainer = ref = None
    launches, threads = [], []
    try:
        import threading
        serve.start(http_options={"port": 0})
        t1 = time.perf_counter()
        # the replica comes up while the trainer is built
        failed = []

        def deploy():
            try:
                serve.run(serve.deployment(LLMServer, name="ar1").bind(
                    model=model_dict(scfg),
                    engine=engine_dict(max_new_tokens=48), seed=seed),
                    name="ar1", route_prefix="/ar1")
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                failed.append(e)
        deployed = threading.Thread(target=deploy, daemon=True)
        deployed.start()
        # a notice's fold takes a live snapshot: the periodic ones serve
        # a failure's replay, which EL1 runs, at EL1's interval
        trainer = ElasticTrainer(
            ParallelPlan(dp=2), cfg, learning_rate=1e-4, seed=seed,
            snapshot_interval=EL1_SNAPSHOT_INTERVAL,
            telemetry_interval_s=AR_TELEMETRY_S, slice_manager=mgr,
            slice_filter=lambda sid: sid in owned, device=dev)
        ref = ParallelPlan().build(cfg, learning_rate=1e-4, seed=seed,
                                   telemetry_interval_s=0, device=dev)
        res["build_s"] = time.perf_counter() - t1
        deployed.join(ACTOR_TIMEOUT_S)
        check(not deployed.is_alive(), "AR1: serve.run never returned")
        if failed:
            raise failed[0]
        (replica,), (info,) = ready_replicas(["ar1"], dev, checksum, t1)
        res["replica"] = info
        url = serve.proxy_address() + "/ar1"
        reset_flash_counts()

        def watch(prog):
            """A program's rank launches zeroed now, before its first
            step, and read just before it shuts down (a program in this
            process has no ranks)."""
            actors = list(getattr(prog, "actors", []))
            ray_tpu_torch.get([a.__ray_call__.remote(rank_probe, "reset")
                               for a in actors], timeout=60)
            inner = prog.shutdown

            def shutdown():
                launches.append([ray_tpu_torch.get(
                    a.__ray_call__.remote(rank_probe, "read"), timeout=60)
                    for a in actors])
                inner()
            prog.shutdown = shutdown
            return prog

        watch(trainer.program)
        build = trainer._build
        trainer._build = lambda plan: watch(build(plan))
        steps = []

        def train_step(stage: str):
            t2 = time.perf_counter()
            got = trainer.step(batch)
            wall = time.perf_counter() - t2
            want = ref.step(batch).loss
            steps.append({"step": len(steps) + 1, "stage": stage,
                          "loss": got.loss, "loss_one_device": want,
                          "rel": abs(got.loss - want) / abs(want),
                          "wall_s": wall, "end_s": time.perf_counter() - t0,
                          "plan": trainer.plan.describe()})
            tick()

        # 1. steps on dp=2; the trainer's rank 0 reports its tokens/s
        for _ in range(AR_STEPS[0]):
            train_step("dp=2")
        check(not ticks[-1]["pressure"],
              f"AR1: pressure before the burst: {ticks[-1]['gauges']}")
        rank0 = ray_tpu_torch.get(trainer.program.actors[0].__ray_call__
                                  .remote(rank_probe, "read"), timeout=60)
        deadline = time.monotonic() + 10
        row = None
        while time.monotonic() < deadline:
            row = fleet_row(rank0["pid"], AR_POLICY["window_s"])
            if row is not None and row["train_tokens_per_s"] > 0:
                break
            time.sleep(AR_TICK_S)
        res["train_row"] = row
        # 2. the burst, held at the gate while the arbiter watches
        probe(replica, gate_burst, len(prompts) - 1, ar_held)
        probe(replica, lambda engine: reset_launches())
        streams = [[] for _ in prompts]
        ttft = [None] * len(prompts)
        errors = []

        def client(i):
            t2 = time.perf_counter()
            try:
                for tok in http_tokens(url, prompts[i]):
                    if ttft[i] is None:
                        ttft[i] = time.perf_counter() - t2
                    streams[i].append(tok)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads.append(threading.Thread(target=client, args=(0,)))
        threads[0].start()
        deadline = time.monotonic() + ACTOR_TIMEOUT_S
        while not streams[0] and not errors \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        for i in range(1, len(prompts)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
        t_burst = time.perf_counter()
        # 3. the arbiter preempts the train slice
        pressure_at = None
        deadline = time.monotonic() + AR_ACT_S
        while time.monotonic() < deadline and not errors:
            out = tick()
            if out["pressure"] and pressure_at is None:
                pressure_at = time.perf_counter()
            if any(a.startswith("preempt:") for a in out["actions"]):
                break
            time.sleep(AR_TICK_S)
        t_notice = time.perf_counter()
        check(arb.preemptions == 1,
              f"AR1: no preemption within {AR_ACT_S} s: {ticks[-3:]}")
        res["burst_queue_depth_max"] = max(
            (t["gauges"].get("queue_depth") or 0) for t in ticks)
        res["replica_row"] = fleet_row(info["pid"], AR_POLICY["window_s"])
        internal_kv._internal_kv_del(AR_HOLD_KEY)
        # 4. the folded step
        train_step("folded")
        folded["done"] = True
        t_folded = time.perf_counter()
        # 5. the burst drains and the slice is released
        for th in threads:
            th.join(ACTOR_TIMEOUT_S)
        check(not any(th.is_alive() for th in threads),
              "AR1: a burst stream never ended")
        if errors:
            raise errors[0]
        t_drained = time.perf_counter()
        d = probe(replica, engine_drained)
        # each prompt alone, meanwhile: the calm traffic of the ebb
        box = {}
        single = threading.Thread(target=lambda: box.update(out=probe(
            replica, ar_single_streams, prompts, 48)))
        single.start()
        # 6. the ebb returns a slice
        deadline = time.monotonic() + AR_ACT_S
        while time.monotonic() < deadline:
            out = tick()
            if "return" in out["actions"]:
                break
            time.sleep(AR_TICK_S)
        t_return = time.perf_counter()
        check(arb.returns == 1,
              f"AR1: no return within {AR_ACT_S} s: {ticks[-3:]}")
        pump()                         # the returned slice comes UP
        single.join(ACTOR_TIMEOUT_S)
        check("out" in box, "AR1: the single-request streams never ended")
        singles = box["out"]
        divergences = confirm_divergences(
            streams, singles,
            lambda i, pos: probe(replica, engine_replay, prompts[i],
                                 singles[i], pos, streams[i][pos]), "ar1")
        # 7. the regrown steps
        train_step("regrown")
        t_regrown = time.perf_counter()
        for _ in range(AR_STEPS[2] - 1):
            train_step("regrown")
        pump()
        slices = {sid: i.state for sid, i in mgr.slices.items()}
        path = os.path.join(api._head.session_dir, "dashboard.json")
        with open(path) as f:
            address = json.load(f)["address"]
        with urllib.request.urlopen(address + "/api/v0/arbiter",
                                    timeout=30) as r:
            arbiter_rows = json.load(r)["rows"]
        recorder.flush()
        events = [e for e in list_task_events(limit=100_000)
                  if e["ev"] in ("ARBITER_PREEMPT", "ARBITER_RETURN")]
        recoveries = [r.asdict() for r in trainer.recoveries]
        driver_launches = flash_counts()
    finally:
        controller.slice_arbiter = None
        internal_kv._internal_kv_del(AR_HOLD_KEY)
        for th in threads:
            th.join(ACTOR_TIMEOUT_S)
        serve.shutdown()
        if trainer is not None:
            trainer.shutdown()
        if ref is not None:
            ref.shutdown()
        mgr.shutdown()
        provider.shutdown()
        del trainer, ref
        gc.collect()
        torch.cuda.empty_cache()
    regrown_sid = next(iter(owned - {train_sid}), None)
    res.update(
        steps=steps, recoveries=recoveries, slices=slices,
        train_sid=train_sid, serve_sid=serve_sid, regrown_sid=regrown_sid,
        preemptions=arb.preemptions, returns=arb.returns,
        preempt_reason=next((t["reason"] for t in ticks
                             if any(a.startswith("preempt:")
                                    for a in t["actions"])), None),
        events=events, arbiter_rows=arbiter_rows,
        pressure_to_notice_s=t_notice - (pressure_at or t_notice),
        burst_to_notice_s=t_notice - t_burst,
        notice_to_folded_step_s=t_folded - t_notice,
        drained_to_return_s=t_return - t_drained,
        return_to_regrown_step_s=t_regrown - t_return,
        **ttft_stats(ttft), generated_tokens=sum(len(s) for s in streams),
        prefill_chunks=d["stats"]["prefill_chunks"],
        decode_steps=d["stats"]["decode_steps"],
        paged_launches=d["launches"], launches=launches,
        driver_launches=driver_launches,
        stream_lengths=[len(t) for t in streams],
        streams_equal=len(streams) - len(divergences),
        divergences=divergences, ticks=len(ticks),
        wall_s=time.perf_counter() - t0)
    print("ar1 " + json.dumps(res), flush=True)
    ar1_checks(res, scfg.n_layers)
    return res


def ar1_checks(res, n_layers: int) -> None:
    """AR1's checks on its record."""
    for st in res["steps"]:
        check(math.isfinite(st["loss"]) and st["rel"] <= EL1_LOSS_REL,
              f"AR1 step {st['step']} ({st['stage']}): loss {st['loss']} "
              f"against the one-device {st['loss_one_device']} "
              f"(rel {st['rel']})")
    want_stages = ["dp=2"] * AR_STEPS[0] + ["folded"] * AR_STEPS[1] \
        + ["regrown"] * AR_STEPS[2]
    want_plans = ["spmd[dp=2 fp32]"] * AR_STEPS[0] \
        + ["spmd[single-device fp32]"] * AR_STEPS[1] \
        + ["spmd[dp=2 fp32]"] * AR_STEPS[2]
    got = [(st["stage"], st["plan"]) for st in res["steps"]]
    check(got == list(zip(want_stages, want_plans)),
          f"AR1 steps ran on {got}")
    rec = [(r["trigger"], r["from_plan"], r["to_plan"])
           for r in res["recoveries"]]
    check(rec == [("notice", "spmd[dp=2 fp32]", "spmd[single-device fp32]"),
                  ("regrow", "spmd[single-device fp32]", "spmd[dp=2 fp32]")],
          f"AR1 recoveries {rec}")
    check(res["recoveries"][0]["steps_lost"] <= 1,
          f"AR1: the fold lost {res['recoveries'][0]['steps_lost']} steps")
    check(res["preemptions"] == res["returns"] == 1,
          f"AR1: {res['preemptions']} preemptions, {res['returns']} returns")
    check(res["preempt_reason"] == "queue-depth",
          f"AR1: preempted for {res['preempt_reason']!r}")
    evs = [(e["ev"], e.get("slice"), e.get("reason"))
           for e in res["events"]]
    check(evs == [("ARBITER_PREEMPT", res["train_sid"], "queue-depth"),
                  ("ARBITER_RETURN", res["regrown_sid"], "pressure-ebbed")],
          f"AR1 arbiter events {evs}")
    # no regrown slice where no return came (checked above)
    want = sorted(sid for sid in (res["serve_sid"], res["regrown_sid"])
                  if sid is not None)
    up = sorted(sid for sid, state in res["slices"].items() if state == "UP")
    check(res["regrown_sid"] is not None and up == want,
          f"AR1: UP slices {up}, not the serve and the regrown train slice")
    rows = sorted(r["slice_id"] for r in res["arbiter_rows"])
    check(res["regrown_sid"] is not None and rows == want,
          f"AR1: /api/v0/arbiter lists {rows}")
    train = res["train_row"] or {}
    check((train.get("train_tokens_per_s") or 0) > 0,
          f"AR1: the trainer's fleet row {train}")
    replica = res["replica_row"] or {}
    check((replica.get("queue_depth") or 0) >= AR_POLICY["queue_high"]
          and res["burst_queue_depth_max"] >= AR_POLICY["queue_high"],
          f"AR1: queue depth {replica.get('queue_depth')} in the replica's "
          f"row, {res['burst_queue_depth_max']} at most in the arbiter's "
          f"gauges, during the burst")
    check(all(n == 48 for n in res["stream_lengths"]),
          f"AR1 stream lengths {res['stream_lengths']} != 48")
    check(all(v["near_tie"] for v in res["divergences"]),
          f"AR1: burst streams leave the single-request ones away from a "
          f"near tie: {res['divergences']}")
    calls = res["prefill_chunks"] + res["decode_steps"]
    check(res["paged_launches"] > 0
          and res["paged_launches"] == n_layers * calls,
          f"AR1 replica paged launches {res['paged_launches']} != "
          f"{n_layers} x {calls}")
    want = [AR_STEPS[0], None, AR_STEPS[2]]
    check(len(res["launches"]) == 3 and len(res["launches"][1]) == 0,
          f"AR1 built programs with ranks {[len(p) for p in res['launches']]}")
    for p, ranks in enumerate(res["launches"]):
        if want[p] is None:
            continue
        check(len(ranks) == 2, f"AR1 program {p} has {len(ranks)} ranks")
        for j, r in enumerate(ranks):
            for name, n in r["launches"].items():
                check(n == want[p] * AR_LAYERS,
                      f"AR1 program {p} rank {j}: {name} launched {n} "
                      f"times, not {want[p] * AR_LAYERS}")
    n_driver = (sum(AR_STEPS) + AR_STEPS[1]) * AR_LAYERS
    for name, n in res["driver_launches"].items():
        check(n == n_driver, f"AR1: the driver launched {name} {n} times "
                             f"(the one-device plan and the folded "
                             f"program), not {n_driver}")


WF_GPUS = 0.5          # each of WF1's steps on the card: half of it


@contextlib.contextmanager
def one_cpu_thread(dev):
    """On the CPU, one intra-op thread: the plain version's f32 matmuls
    then add up in one order whatever the host's load, so two processes
    agree bit for bit (the card's kernel does without this)."""
    if dev.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def wf_make_qkv(seed: int, shape):
    """WF1 step 1: GPT-J-6B-width q, k, v (bf16, (B, S, H, D)) drawn from
    ``seed`` with numpy, on the card where the task has one."""
    import numpy as np
    import torch
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape, dtype=np.float32))
                 .to(device=dev, dtype=torch.bfloat16) for _ in range(3))


def wf_flash(qkv, log_path: str):
    """WF1 step 2: the flash forward's wrapper, causal, on the card where
    the task has one; its launches are appended to ``log_path`` (one JSON
    line a call), so a resume that ran it again would show."""
    import json
    import os

    import torch
    from ray_tpu_torch.ops.flash_attention import (flash_delta, flash_dkdv,
                                                   flash_dq, flash_fwd)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    q, k, v = (t.to(dev) for t in qkv)
    kernels = (flash_fwd, flash_delta, flash_dkdv, flash_dq)
    for f in kernels:
        f.kernel_launches = 0
    with one_cpu_thread(dev):
        o, _ = flash_fwd(q, k, v, causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec = {"launches": {f.__name__: f.kernel_launches for f in kernels},
           "current": str(o.device), "pid": os.getpid()}
    with open(log_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return o


def wf_reduce(o, marker: str):
    """WF1 step 3: the output's float64 sum and bytes' sha256, with the
    output; the first attempt raises (it leaves ``marker``)."""
    import hashlib
    import os
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("WF1: the reduce's first attempt fails")
    o = o.cpu()
    return {"o": o, "checksum": float(o.double().sum()),
            "sha256": hashlib.sha256(o.contiguous().view(torch.uint8)
                                     .numpy().tobytes()).hexdigest()}


def wf_after(ts):
    return {"fired": ts}


def phase_wf1(dev, card: str, seed: int):
    """WF1: a durable workflow around the flash forward (see the module
    docstring)."""
    import ray_tpu_torch
    from ray_tpu_torch import api, workflow
    t0 = time.perf_counter()
    root = os.path.join(api._head.session_dir, "wf1")
    os.makedirs(root, exist_ok=True)
    workflow.init_storage(os.path.join(root, "storage"))
    steps = [ray_tpu_torch.remote(num_gpus=WF_GPUS)(f)
             for f in (wf_make_qkv, wf_flash, wf_reduce)]

    def dag(name: str):
        qkv = steps[0].bind(seed, tuple(JC_SHAPE))
        o = steps[1].bind(qkv, os.path.join(root, f"{name}.launches"))
        return steps[2].bind(o, os.path.join(root, f"{name}.marker"))

    def logged(name: str):
        with open(os.path.join(root, f"{name}.launches")) as f:
            return [json.loads(line) for line in f]

    res = {"card": card, "shape": list(JC_SHAPE), "gpus_a_step": WF_GPUS}
    failed = None
    t1 = time.perf_counter()
    try:
        workflow.run(dag("resumed"), workflow_id="wf1")
    except Exception as e:  # noqa: BLE001 -- the reduce's first attempt
        failed = f"{type(e).__name__}: {e}"
    res["first_run_s"] = time.perf_counter() - t1
    res["first_run_error"] = failed
    res["status_after_failure"] = workflow.get_status("wf1")
    res["launches_before_resume"] = logged("resumed")
    t1 = time.perf_counter()
    out = workflow.resume("wf1")
    res["resume_s"] = time.perf_counter() - t1
    res["launches_after_resume"] = logged("resumed")
    res["status"] = workflow.get_status("wf1")
    open(os.path.join(root, "straight.marker"), "w").close()
    t1 = time.perf_counter()
    straight = workflow.run(dag("straight"), workflow_id="wf1-straight")
    res["straight_run_s"] = time.perf_counter() - t1
    res["straight_launches"] = logged("straight")
    stored = workflow.get_output("wf1")
    res["stored_bit_equal_straight"] = bool(
        torch.equal(stored["o"], straight["o"])
        and stored["sha256"] == straight["sha256"] == out["sha256"])
    with one_cpu_thread(dev):
        ref = jc_flash(seed, str(dev), tuple(JC_SHAPE))[0].cpu()
    res["bit_equal_driver"] = bool(torch.equal(stored["o"], ref))
    res["checksum"], res["sha256"] = stored["checksum"], stored["sha256"]
    res["listed"] = sorted(w for w, _ in workflow.list_all())
    workflow.delete("wf1")
    res["listed_after_delete"] = sorted(w for w, _ in workflow.list_all())
    target = time.time() + 0.5
    res["timer"] = workflow.run(ray_tpu_torch.remote(wf_after).bind(
        workflow.wait_for_event(workflow.TimerListener, target)),
        workflow_id="wf1-timer")
    res["timer_target"] = target
    res["timer_status"] = workflow.get_status("wf1-timer")
    res["wall_s"] = time.perf_counter() - t0
    print("wf1 " + json.dumps(res), flush=True)
    wf1_checks(res, "cuda:0" if dev.type == "cuda" else "cpu")
    return res


def wf1_checks(res, current: str) -> None:
    """WF1's checks on its record."""
    check(res["first_run_error"] is not None
          and "first attempt fails" in res["first_run_error"]
          and res["status_after_failure"] == "FAILED",
          f"WF1: the first run ended {res['status_after_failure']} "
          f"({res['first_run_error']})")
    logs = res["launches_before_resume"]
    check(len(logs) == 1 and res["launches_after_resume"] == logs,
          f"WF1: the flash step ran {len(logs)} time(s) before the resume "
          f"and {len(res['launches_after_resume'])} after it")
    for rec in logs + res["straight_launches"]:
        check(rec["current"] == current,
              f"WF1: the flash step ran on {rec['current']}, not {current}")
        for name, n in rec["launches"].items():
            want = 1 if name == "flash_fwd" else 0
            check(n == want, f"WF1: the flash step launched {name} {n} "
                             f"times, not {want}")
    check(res["status"] == "SUCCESSFUL",
          f"WF1: the resumed workflow is {res['status']}")
    check(res["stored_bit_equal_straight"],
          "WF1: the resumed workflow's stored output is not bit-equal to "
          "a straight run's")
    check(res["bit_equal_driver"],
          "WF1: the workflow's output is not the driver's flash forward")
    check({"wf1", "wf1-straight"} <= set(res["listed"])
          and "wf1" not in res["listed_after_delete"],
          f"WF1: listed {res['listed']}, after delete "
          f"{res['listed_after_delete']}")
    check(res["timer"] == {"fired": res["timer_target"]}
          and res["timer_status"] == "SUCCESSFUL",
          f"WF1: the timer step gave {res['timer']} "
          f"({res['timer_status']})")


CL_CMD_S = 300.0       # each command line call returns within this
CL_GPUS = 0.5          # the submitted script's task: half the card


def cl_config(session_dir: str):
    """CL1's cluster: the local launcher's fake-slice provider, a head
    counting the card, one slice of one host (JSON, which is YAML)."""
    return {"cluster_name": "cl1",
            "provider": {"type": "fake_slice", "session_dir": session_dir},
            "head_node_type": "head",
            "available_node_types": {
                "head": {"resources": {"CPU": 2, "GPU": 1}}},
            "slices": {"host": {"topology": "1x1", "count": 1,
                                "host_resources": {"CPU": 1}}}}


def cl_tree(pids):
    """The pids and every descendant of theirs that live now."""
    import psutil
    out = set()
    for pid in pids:
        try:
            p = psutil.Process(pid)
            out.add(pid)
            out.update(c.pid for c in p.children(recursive=True))
        except psutil.Error:
            pass
    return out


def gpu_pids():
    """The pids ``nvidia-smi`` lists as holding the card (none where it
    lists no process)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return set()
    return {int(x) for x in out.split() if x.strip().isdigit()}


def phase_cl1(dev, card: str, seed: int):
    """CL1: the command line on the card's host (see the module
    docstring)."""
    import inspect

    import psutil
    from ray_tpu_torch import api
    t0 = time.perf_counter()
    root = os.path.join(api._head.session_dir, "cl1")
    os.makedirs(root, exist_ok=True)
    cfg_path = os.path.join(root, "cluster.yaml")
    with open(cfg_path, "w") as f:
        json.dump(cl_config(os.path.join(root, "session")), f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    walls = {}

    def cli(name, *args, address=None, ok=True):
        e = dict(env, **({"RAY_TPU_TORCH_ADDRESS": address}
                         if address else {}))
        t1 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                            *args], capture_output=True, text=True, env=e,
                           cwd=repo, timeout=CL_CMD_S)
        walls[name] = round(walls.get(name, 0.0)
                            + time.perf_counter() - t1, 3)
        if ok:
            check(p.returncode == 0, f"CL1: cli {' '.join(args)} exited "
                  f"{p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
        return p

    res = {"card": card, "config": cl_config("<session>")}
    head_pid, tree = None, set()
    before = set(psutil.pids())
    try:
        up = json.loads(cli("up", "up", "-y", cfg_path)
                        .stdout.strip().splitlines()[-1])
        head_pid, address = up["head_pid"], up["session_dir"]
        res["up"] = up
        script = os.path.join(root, "submit.py")
        with open(script, "w") as f:
            f.write(JC_JOB_SCRIPT.format(
                flash=inspect.getsource(jc_flash), gpus=CL_GPUS, seed=seed,
                device="cuda" if dev.type == "cuda" else "cpu",
                shape=tuple(JC_SHAPE), tag="cl1-submit "))
        res["submit"] = tagged(cli("submit", "submit", script,
                                   address=address).stdout, "cl1-submit ")
        jid = cli("job", "job", "submit", "--no-wait", "--",
                  sys.executable, "-c", "print('cl1-job')",
                  address=address).stdout.strip().splitlines()[-1]
        deadline = time.monotonic() + CL_CMD_S
        status = None
        while time.monotonic() < deadline:
            status = cli("job", "job", "status", jid,
                         address=address).stdout.strip()
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            time.sleep(0.5)
        res["job"] = {"id": jid, "status": status}
        res["status"] = cli("status", "status", address=address).stdout
        deadline = time.monotonic() + CL_CMD_S
        while True:
            nodes = json.loads(cli("list", "list", "nodes",
                                   address=address).stdout)
            alive = [n for n in nodes if n.get("alive")]
            if len(alive) >= 2 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        res["nodes"] = [{"alive": n.get("alive"),
                         "labels": n.get("labels"),
                         "resources": n.get("resources_total")
                         or n.get("resources")} for n in nodes]
        tree = cl_tree([head_pid] + [
            p.pid for p in psutil.process_iter(["cmdline"])
            if p.pid not in before and "ray_tpu_torch.core.node" in
            " ".join(p.info["cmdline"] or [])])
    finally:
        down = cli("down", "down", "-y", cfg_path, ok=False)
    res["down"] = {"rc": down.returncode,
                   "out": down.stdout.strip().splitlines()[-1:]}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and (
            not group_gone(head_pid) or any(psutil.pid_exists(p)
                                            for p in tree)):
        time.sleep(0.2)
    res["head_group_gone"] = head_pid is not None and group_gone(head_pid)
    res["left"] = sorted(p for p in tree if psutil.pid_exists(p))
    res["left_on_gpu"] = sorted(tree & gpu_pids())
    res["tree"] = len(tree)
    # after down: the suite runs a runtime of its own; its PPO phase's
    # learner (where gymnasium is installed) on the phase's device
    micro = cli("microbenchmark", "microbenchmark", "--device",
                "cuda" if dev.type == "cuda" else "cpu").stdout
    res["microbenchmark"] = [json.loads(line) for line in micro.splitlines()
                             if line.startswith('{"metric"')]
    res["cli_walls_s"] = walls
    res["wall_s"] = time.perf_counter() - t0
    print("cl1 " + json.dumps(res), flush=True)
    cl1_checks(res, "cuda:0" if dev.type == "cuda" else "cpu")
    return res


def cl1_checks(res, current: str) -> None:
    """CL1's checks on its record."""
    from ray_tpu_torch.scripts.perf import BASELINES
    check(res["up"]["created"] and len(res["up"]["slices"]) == 1,
          f"CL1: up gave {res['up']}")
    sub = res["submit"] or {}
    check(sub.get("current") == current,
          f"CL1: the submitted script's task ran on {sub.get('current')}")
    for name, n in (sub.get("launches") or {"flash_fwd": 0}).items():
        want = 1 if name == "flash_fwd" else 0
        check(n == want, f"CL1: the submitted script launched {name} {n} "
                         f"times, not {want}")
    check(res["job"]["status"] == "SUCCEEDED",
          f"CL1: the job {res['job']} did not succeed")
    check("GPU" in res["status"] and "Nodes: 2 alive" in res["status"],
          f"CL1: status printed {res['status']!r}")
    alive = [n for n in res["nodes"] if n["alive"]]
    check(len(alive) == 2 and any(
        (n["labels"] or {}).get("ray-tpu-slice-id") for n in alive),
          f"CL1: list nodes gave {res['nodes']}")
    got = {r["metric"] for r in res["microbenchmark"]}
    check(set(BASELINES) <= got and all(
        r["value"] > 0 for r in res["microbenchmark"]),
          f"CL1: microbenchmark printed {sorted(got)}")
    check(res["down"]["rc"] == 0, f"CL1: down gave {res['down']}")
    check(res["head_group_gone"] and not res["left"]
          and not res["left_on_gpu"] and res["tree"] >= 2,
          f"CL1: after down the head's group is "
          f"{'gone' if res['head_group_gone'] else 'alive'}, "
          f"{res['left']} of its {res['tree']} processes are left, "
          f"{res['left_on_gpu']} on the card")


def ar_wf_cl_phases(dev, card: str, seed: int):
    """AR1 and WF1 after JC1, on the caller's runtime where it shares
    one, else each on a runtime of its own; CL1 beside them on a thread
    of its own (its clusters are runtimes of their own). One after
    another the three took 225.6 s of a 1111.1 s run on a slow host,
    over the script's 900 s budget and near its 1200 s limit: so AR1's
    and WF1's times, and the microbenchmark's rates, are taken under
    each other's load."""
    import threading
    t0 = time.perf_counter()
    out, errors = {}, []

    def cl1():
        t1 = time.perf_counter()
        try:
            out["CL1"] = phase_cl1(dev, card, seed)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
        print(phase_wall("CL1", t1), flush=True)
    beside = threading.Thread(target=cl1, name="CL1", daemon=True)
    beside.start()
    try:
        for name, phase in (("AR1", phase_ar1), ("WF1", phase_wf1)):
            out[name] = on_own_runtime(name, dev, phase, card, seed)
    finally:
        beside.join(CL_CMD_S * 4)
    check(not beside.is_alive(), "CL1 never returned")
    if errors:
        raise errors[0]
    print(phase_wall("AR1-CL1", t0, group=True), flush=True)
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
    t0 = time.perf_counter()
    server, checksum, paged = serving_phases(dev, card, args.seed)
    print(phase_wall("3-6d", t0, group=True), flush=True)
    kernels = [paged]
    torch.cuda.empty_cache()
    print(f"released serving: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB still allocated", flush=True)
    r3 = runtime_phases(dev, card, args.seed, server, checksum)
    paged["actor_launches"] = r3["paged_launches"]
    served = serve_phases(dev, card, args.seed, server, r3, checksum,
                          names=("S1",))
    # S2-JC1 on one runtime: RL2's learners and every later phase's
    # actors fork from the zygote S2's first spawn booted (the training
    # phases 7-10 run in this process meanwhile)
    with runtime():
        served.update(serve_phases(dev, card, args.seed, server, r3,
                                   checksum, names=("S2",)))
        rl = rlhf_phases(dev, card, args.seed)
        paged["serve_launches"] = served["S1"]["paged_launches"]
        paged["disagg_launches"] = served["S2"]["prefill_launches"] \
            + served["S2"]["decode_launches"]
        paged["rlhf_launches"] = {name: rl[name]["paged_launches"]
                                  for name in ("RL1", "RL2")}
        t0 = time.perf_counter()
        flash = training_phases(dev, card, args.seed)
        print(phase_wall("7-10", t0, group=True), flush=True)
        for rec in flash:
            rec["rlhf_learner_launches"] = {
                "RL1": rl["RL1"]["flash_launches"][rec["name"]],
                "RL2": [n[rec["name"]]
                        for n in rl["RL2"]["learner_launches"]]}
        kernels.extend(flash)
        sharded = sharding_phases(dev, card, args.seed)
        moe_ring = moe_ring_phases(dev, card, args.seed)
        pipes = pipeline_phases(dev, card, args.seed)
        mesh = mesh_elastic_phases(dev, card, args.seed)
        rllib_phases(dev, card, args.seed)
        trained = train_tune_phases(dev, card, args.seed)
        trained.update(data_tune_phases(dev, card, args.seed))
        dag_job = dag_job_phases(dev, card, args.seed)
        later = ar_wf_cl_phases(dev, card, args.seed)
    paged["arbiter_launches"] = later["AR1"]["paged_launches"]
    for rec in flash:
        rec["sharded_launches"] = [r["launches"][rec["name"]]
                                   for r in sharded["P1"]["ranks"]]
        rec["moe_launches"] = [r["launches"][rec["name"]]
                               for r in moe_ring["M1"]["ranks"]]
        rec["ring_launches"] = [r["launches"][rec["name"]]
                                for r in moe_ring["M2"]["ranks"]]
        rec["pipeline_launches"] = {
            name: [c[rec["name"]] for c in pipes[name]["launches_last_step"]]
            for name in ("PL1", "PL2")}
        rec["gpipe_launches"] = [c[rec["name"]] for c in
                                 pipes["PL4"]["gpipe"]["launches"]]
        rec["mpmd3d_launches"] = {
            "PL5": [c[rec["name"]] for c in mesh["PL5"]["launches"]],
            "PL6": [c[rec["name"]]
                    for c in mesh["PL6"]["launches_last_step"]]}
        rec["elastic_launches"] = [
            [c[rec["name"]] if c is not None else None for c in prog]
            for prog in mesh["EL1"]["launches"]]
        rec["trainer_launches"] = {
            "TR1": [c[rec["name"]] for c in trained["TR1"]["launches"]],
            "TN1": [t["launches"][rec["name"]]
                    for t in trained["TN1"]["trials"]],
            "D1": [c[rec["name"]] for c in trained["D1"]["launches"]],
            "TN2": {name: [c[rec["name"]] for c in t["launches"]]
                    for name, t in trained["TN2"]["trials"].items()}}
        rec["dag_launches"] = [c[rec["name"]]
                               for c in dag_job["DG1"]["launches"]]
        rec["job_launches"] = dag_job["JC1"]["job_launches"][rec["name"]]
        rec["client_launches"] = \
            dag_job["JC1"]["client_launches"][rec["name"]]
        rec["arbiter_launches"] = {
            "programs": [[r["launches"][rec["name"]] for r in prog]
                         for prog in later["AR1"]["launches"]],
            "driver": later["AR1"]["driver_launches"][rec["name"]]}
        rec["workflow_launches"] = [
            r["launches"][rec["name"]]
            for r in later["WF1"]["launches_after_resume"]
            + later["WF1"]["straight_launches"]]
        rec["cli_launches"] = \
            later["CL1"]["submit"]["launches"][rec["name"]]

    total = time.perf_counter() - t_start
    print(f"total wall: {total:.1f} s", flush=True)
    print("phase walls: " + json.dumps({
        "card": card, "walls_s": WALLS, "groups_s": GROUP_WALLS,
        "store_gb": STORE_GB,
        "driver_gb": DRIVER_GB,
        "segment_gb": SEGMENT_GB,
        "unaccounted_s": round(total - sum(WALLS.values()), 1),
        "total_s": round(total, 1)}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
