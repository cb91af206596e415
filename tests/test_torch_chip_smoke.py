"""``chip_smoke.py``'s bookkeeping, on the CPU: how it files the kernels a
train-step profile names, reads ptxas's report, bounds the backward, and
that it refuses to run without a card. The phases themselves need the
card and run only there (``python3 chip_smoke.py``)."""

import json

import pytest
import torch

import chip_smoke

# kernel names as the profiler and ptxas give them (mangled or not)
KINDS = {
    "void (anonymous namespace)::flash_fwd_sm90_kernel<256>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, "
    "(anonymous namespace)::Shape)": "flash_forward",
    "_ZN50_GLOBAL__N__4d0a44da_17_flash_bwd_sm90_cu_b6912ef722flash_dkdv_"
    "sm90_kernelILi256EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16"
    "S5_NS_5ShapeE": "flash_backward",
    "void (anonymous namespace)::flash_dq_sm90_kernel<256>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float "
    "const*, __nv_bfloat16*, (anonymous namespace)::Shape)": "flash_backward",
    "void (anonymous namespace)::flash_delta_kernel<__nv_bfloat16>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int, int, int, "
    "int)": "flash_backward",
    "void (anonymous namespace)::flash_dkdv_kernel<float, 128>(float const*, "
    "...)": "flash_backward",
    "void (anonymous namespace)::flash_dq_kernel<float, 256>(float const*, "
    "...)": "flash_backward",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "matmul",
    "void at::native::vectorized_elementwise_kernel<4, ...>": "other",
}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_train_profile_files_every_flash_kernel_by_kind(name):
    assert chip_smoke._train_kind(name) == KINDS[name]


def test_ptxas_report_reads_registers_spills_and_smem():
    log = """ptxas info    : Compiling entry function '_Z21flash_dq_sm90_kernelILi256EEv' for 'sm_90a'
ptxas info    : Function properties for _Z21flash_dq_sm90_kernelILi256EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z17flash_dkdv_kernelIfLi128EEv' for 'sm_90a'
ptxas info    : Function properties for _Z17flash_dkdv_kernelIfLi128EEv
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 1024 bytes smem, 400 bytes cmem[0]
"""
    assert chip_smoke.ptxas_report(log) == [
        ["_Z21flash_dq_sm90_kernelILi256EEv", 168, 0, 0],
        ["_Z17flash_dkdv_kernelIfLi128EEv", 255, 28, 1024]]


def test_the_backward_total_is_bounded_by_all_of_its_work():
    """14 x D flops a pair (dK/dV's 8 and dQ's 6) and the bytes of q, k,
    v, O, dO and the LSE in and dQ, dK, dV out, at the trainer's shape."""
    sh = chip_smoke.FlashShape("t", 2, 2048, 2048, 16, 256, torch.bfloat16,
                               True)
    b = chip_smoke.flash_bounds(sh)
    pairs = chip_smoke.flash_pairs(sh)
    assert pairs == 67_141_632
    total = b["flash_backward_total"]
    assert total[3] == b["flash_dkdv"][3] + b["flash_dq"][3] == \
        14 * 256 * pairs
    qo = kv = 2 * 2048 * 16 * 256 * 2
    assert total[2] == 4 * qo + 4 * kv + 2 * 16 * 2048 * 4
    assert total[1] == "operations"
    assert total[0] == pytest.approx(14 * 256 * pairs / 989e12 * 1e3)


def test_without_a_card_it_exits_nonzero_and_prints_no_result(
        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert '"ok"' not in out


# ------------------------------------------- the serving-feature phases
def test_near_tie_rule():
    """A divergence passes only where the spec-off replay picks the
    spec-off token, the spec-on token is within 1% of the top logit's
    magnitude below it, and the spec-on replay picks the spec-on token."""
    row = torch.tensor([1.0, 9.95, 10.0])
    v = chip_smoke.near_tie(row, 1, 2, 1)
    assert v["near_tie"] and v["top_logit"] == 10.0
    assert v["top2_gap"] == pytest.approx(0.05, abs=1e-6)
    assert v["spec_on_gap"] == pytest.approx(0.05, abs=1e-6)
    assert (v["replay_off_pick"], v["replay_on_pick"]) == (2, 1)
    assert not chip_smoke.near_tie(torch.tensor([1.0, 9.8, 10.0]),
                                   1, 2, 1)["near_tie"]
    assert chip_smoke.near_tie(torch.tensor([-10.0, -5.02, -5.0]),
                               1, 2, 1)["near_tie"]
    assert not chip_smoke.near_tie(torch.tensor([0.0, 0.0, 3.0]),
                                   1, 2, 1)["near_tie"]
    # the spec-off replay must reproduce the spec-off token
    assert not chip_smoke.near_tie(torch.tensor([1.0, 10.0, 9.95]),
                                   1, 2, 1)["near_tie"]
    # and the spec-on replay the spec-on token
    assert not chip_smoke.near_tie(row, 1, 2, 2)["near_tie"]
    assert chip_smoke.first_divergence([1, 2, 3], [1, 2, 4]) == 2
    assert chip_smoke.first_divergence([1, 2], [1, 2, 3]) is None


def test_near_tie_rejects_a_token_outside_the_tied_pair():
    """A flat row (its top two within one bf16 ulp) does not excuse a
    divergence to a third token far below them, even where the spec-on
    replay repeats it: that is a fault."""
    row = torch.tensor([0.0, 4.78125, 4.8125, 3.0], dtype=torch.bfloat16)
    v = chip_smoke.near_tie(row, 3, 2, 3)
    assert v["top2_gap"] < chip_smoke.NEAR_TIE_SHARE * v["top_logit"]
    assert v["spec_on_gap"] == pytest.approx(1.8125)
    assert not v["near_tie"]
    assert chip_smoke.near_tie(row, 1, 2, 1)["near_tie"]


def test_doubled_head_doubles_the_logits_exactly():
    """The staged tree of phase 6b: only the LM head is new, and the
    bf16 logits it gives are exactly twice the old ones."""
    from ray_tpu_torch.models import get_config, init_params
    from ray_tpu_torch.models.transformer import _lm_head
    cfg = get_config("gptj-6b", n_layers=1, d_model=64, n_heads=2,
                     head_dim=32, d_ff=128, vocab_size=96)
    params = init_params(cfg, 0, "cpu", dtype=torch.bfloat16)
    new = chip_smoke.doubled_head(params)
    assert new["embed"] is params["embed"]
    assert new["layers"] is params["layers"]
    assert set(new["lm_head"]) == set(params["lm_head"])
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(_lm_head(cfg, new, x), 2 * _lm_head(cfg, params, x))


def test_verify_shape_maker():
    """32 slots x 5 rows at decode's lens: each slot keeps ``1 + d`` rows
    ending at ``lens - 1``, an idle slot keeps none, and the padded rows
    of a full slot sit past the 1024-key window."""
    import numpy as np
    lens = [0, 1, 1024, 31, 32, 33] + list(range(100, 1000, 35))[:26]
    sh = chip_smoke.verify_shape(np.random.default_rng(1), lens)
    assert (sh.name, sh.B, sh.C, sh.H, sh.KVH, sh.D, sh.bs, sh.T) == \
        ("gptj6b_verify", 32, 5, 16, 16, 256, 32, 32)
    assert sh.dtype == torch.bfloat16 and sh.lens == lens
    for n, s in zip(sh.lens, sh.starts):
        kept = [p for p in range(s, s + 5) if p < n]
        if n == 0:
            assert s == 0 and not kept
        else:
            assert kept[-1] == n - 1 and 1 <= len(kept) <= 5
    assert chip_smoke.verify_starts([0, 1, 1024, 10], [4, 4, 1, 0]) == \
        [0, 0, 1022, 9]
    assert max(s + 4 for s in chip_smoke.verify_starts([1024], [1])) \
        >= 1024


def test_paged_bound_counts_kept_rows_only():
    """The verify's bound: K/V of the live keys, q and O of every row, and
    4 x D flops per (kept row, key) pair; padded rows add no pairs, so
    the decode shape's flops are those of its one kept row a slot."""
    sh = chip_smoke.Shape("v", 2, 3, 2, 2, 8, 4, 4, torch.float32,
                          [5, 0], [3, 0])
    t, by, nbytes, flops, keys = chip_smoke.bound_ms(sh)
    assert keys == 5 and by == "bytes"
    assert flops == 4 * 8 * 2 * (4 + 5)        # rows at 3 and 4 kept
    assert nbytes == 2 * 5 * 2 * 8 * 4 + 2 * 2 * 3 * 2 * 8 * 4 \
        + 4 * (2 * 4 + 2 * 3 + 2)
    dec = chip_smoke.Shape("d", 2, 1, 2, 2, 8, 4, 4, torch.float32,
                           [5, 0], [4, 0])
    assert chip_smoke.bound_ms(dec)[3] == 4 * 8 * 2 * 5


def test_handoff_byte_count_at_gptj_width():
    """458,752 B of KV a token at GPT-J-6B: a 700-token prompt (22 blocks
    of 32) ships about 323 MB on the bf16 wire and about 164 MB on int8
    (one f32 scale per 256 values)."""
    from ray_tpu_torch.models import get_config
    cfg = get_config("gptj-6b")
    assert chip_smoke.handoff_bytes(700, "bf16", cfg) == 22 * 32 * 458752
    numel = 22 * 32 * 458752 // 4        # k (or v): 2 bytes an element
    assert chip_smoke.handoff_bytes(700, "int8", cfg) == \
        2 * (numel + 4 * (numel // 256))
    assert round(chip_smoke.handoff_bytes(700, "bf16", cfg) / 1e6) == 323
    assert round(chip_smoke.handoff_bytes(700, "int8", cfg) / 1e6) == 164


def test_spec_prompts_repeat_a_segment():
    import numpy as np
    prompts = chip_smoke.make_spec_requests(0, 50400)
    assert len(prompts) == 16
    assert all(64 <= len(p) <= 700 for p in prompts)
    assert prompts == chip_smoke.make_spec_requests(0, 50400)
    for p in prompts:
        # a period of 16-48 tokens: a token equals the one a period back
        best = max(np.mean(np.asarray(p[k:]) == np.asarray(p[:-k]))
                   for k in range(16, 49))
        assert best > 0.75     # either of a pair replaced: ~10%


# ------------------------------------------------ the runtime phases R1-R3
def test_runtime_phases_run_between_serving_and_training():
    """R1-R3 come after the serving phases have released their weights
    and before the trainer's, in the order store, runtime, actor; S1-S2
    after them, then RL1-RL2."""
    import inspect
    main = inspect.getsource(chip_smoke.main)
    assert main.index("serving_phases(") < main.index("runtime_phases(") \
        < main.index("serve_phases(") < main.index("rlhf_phases(") \
        < main.index("training_phases(")
    r = inspect.getsource(chip_smoke.runtime_phases)
    assert r.index("phase_store(") < r.index("phase_runtime(") \
        < r.index("phase_actor_server(") < r.index("ray_tpu_torch.kill(") \
        < r.index("ray_tpu_torch.shutdown()")


def test_handoff_slab_is_phase_6c_s_longest_hand_off():
    """k and v of 22 blocks of 32 tokens over every layer, KV head and
    head_dim: at GPT-J-6B width the bytes of a 700-token bf16 hand-off
    (323.0 MB)."""
    from ray_tpu_torch.models import get_config
    tiny = get_config("gptj-tiny")
    slab = chip_smoke.handoff_slab(torch.device("cpu"), tiny, 0)
    assert set(slab) == {"k", "v"}
    assert slab["k"].shape == (tiny.n_layers, 22, 32, tiny.kv_heads,
                               tiny.head_dim)
    assert slab["k"].dtype == tiny.dtype
    assert chip_smoke.same_bits(slab, chip_smoke.handoff_slab(
        torch.device("cpu"), tiny, 0))
    cfg = get_config("gptj-6b")
    n = 2 * cfg.n_layers * 22 * 32 * cfg.kv_heads * cfg.head_dim * 2
    assert n == chip_smoke.handoff_bytes(700, "bf16", cfg) == 322_961_408


def test_bit_checks_see_one_bit():
    a = {"x": torch.zeros(4), "y": [torch.ones(2, dtype=torch.bfloat16)]}
    b = {"x": torch.zeros(4), "y": [torch.ones(2, dtype=torch.bfloat16)]}
    assert chip_smoke.same_bits(a, b)
    b["x"][1] = -0.0                  # equal value, other bits
    assert not chip_smoke.same_bits(a, b)
    assert not chip_smoke.same_bits(a, {"x": a["x"]})
    assert chip_smoke.nbytes(a) == 16 + 4
    c = {"w": torch.arange(6, dtype=torch.bfloat16),
         "norm": {"scale": torch.ones(3)}}
    d = {"w": c["w"].clone(), "norm": {"scale": torch.ones(3)}}
    assert chip_smoke.weights_checksum(c) == chip_smoke.weights_checksum(d)
    assert [n for n, _ in chip_smoke.weights_checksum(c)] == \
        ["norm.scale", "w"]
    d["w"].view(torch.int16)[3] ^= 1
    assert chip_smoke.weights_checksum(c) != chip_smoke.weights_checksum(d)


def _cpu_card(monkeypatch):
    """Let the card-only phases run on the CPU: the card's calls become
    no-ops, and the runtime counts one GPU."""
    for name, fn in (("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("memory_allocated", lambda *a: 0),
                     ("mem_get_info", lambda *a: (1 << 34, 1 << 36)),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("device_count", lambda: 1)):
        monkeypatch.setattr(torch.cuda, name, fn)


def test_store_phase_on_the_cpu(monkeypatch):
    """R1 at a small width: the slab, a small tensor and a nested tuple
    through the serializer and the native store, bits equal."""
    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    out = chip_smoke.phase_store(torch.device("cpu"), "cpu",
                                 get_config("gptj-tiny"), 0)
    assert out["store"] == "native"
    assert out["slab_bytes"] == chip_smoke.nbytes(chip_smoke.handoff_slab(
        torch.device("cpu"), get_config("gptj-tiny"), 0))
    assert out["wire_bytes"] > out["slab_bytes"]


def test_runtime_and_actor_phases_on_the_cpu(monkeypatch):
    """R2 and R3 at gptj-tiny width on the CPU: the runtime counts the
    GPU, the slab survives put/get and a num_gpus=1 task, and the actor
    serves phase 4's requests in phase 4's pattern with the same streams
    and step counts as the in-process engine. The paged wrapper launches
    nothing on the CPU, so the two launch checks are the only ones that
    fail here."""
    import dataclasses

    import cloudpickle

    import ray_tpu_torch
    from ray_tpu_torch.models import get_config, init_params
    _cpu_card(monkeypatch)
    monkeypatch.delenv("RAY_TPU_TORCH_PLATFORM", raising=False)
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    cfg = dataclasses.replace(get_config("gptj-tiny"), max_seq_len=1024)
    dev = torch.device("cpu")
    params = init_params(cfg, seed=0, device=dev, dtype=cfg.dtype)
    server = chip_smoke.phase_server(dev, "cpu", cfg, params, 0)
    checksum = chip_smoke.weights_checksum(params)
    actor = None
    try:
        r2 = chip_smoke.phase_runtime(dev, "cpu", cfg, 0)
        actor, r3 = chip_smoke.phase_actor_server(dev, "cpu", cfg, 0,
                                                  server, checksum)
    finally:
        if actor is not None:
            ray_tpu_torch.kill(actor)
        ray_tpu_torch.shutdown()
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    assert r2["resources"]["GPU"] == 1.0 and r2["worker_device"] == "cpu"
    after = r2["gpu_after_default_tasks"]
    assert len(after["call_s"]) == 3
    assert (after["workers"], after["new_workers"]) == (1, 0), after
    assert r3["streams_equal"] == 16 and r3["divergences"] == []
    assert (r3["prefill_chunks"], r3["decode_steps"]) == \
        (server["prefill_chunks"], server["decode_steps"])
    assert r3["paged_launches"] == 0
    assert len(failed) == 2 and all("launches" in f for f in failed), failed


def test_serve_phases_on_the_cpu(monkeypatch):
    """S1 and S2 at gptj-tiny width on the CPU, each on a runtime of its
    own: ``LLMServer`` behind ``serve.run`` answers phase 4's requests
    over HTTP and a handle, and the disaggregated pair its 4 longest,
    with phase 4's streams, clean pools and the shipped bytes of
    ``kv_ship_bytes``; the replicas serve on the CPU because their
    workers are on the CPU platform. The paged wrapper launches nothing
    on the CPU, so the four launch checks (phase 4's, one replica's in
    S1, two in S2) are the only ones that fail here."""
    import dataclasses

    import cloudpickle

    import ray_tpu_torch.models as models
    from ray_tpu_torch.models import get_config, init_params
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cfg = dataclasses.replace(get_config("gptj-tiny"), max_seq_len=1024)
    monkeypatch.setattr(models, "get_config", lambda name: cfg)
    cloudpickle.register_pickle_by_value(chip_smoke)
    dev = torch.device("cpu")
    try:
        params = init_params(cfg, seed=0, device=dev, dtype=cfg.dtype)
        server = chip_smoke.phase_server(dev, "cpu", cfg, params, 0)
        out = chip_smoke.serve_phases(dev, "cpu", 0, server, server,
                                      chip_smoke.weights_checksum(params))
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    s1, s2 = out["S1"], out["S2"]
    assert s1["streams_equal"] == 17 and s1["divergences"] == []
    assert s1["handle_stream_equal_http"] and s1["device"] == "cpu"
    assert s1["generated_tokens"] == 16 * 48 and s1["paged_launches"] == 0
    assert (s1["prefill_chunks"], s1["decode_steps"]) != (0, 0)
    assert s2["streams_equal"] == 4 and s2["divergences"] == []
    assert s2["prefill"]["device"] == s2["decode"]["device"] == "cpu"
    assert s2["router_stats"] == {"requests": 0, "retries": 0,
                                  "handoff_errors": 0}
    assert s2["kv_ship_bytes"] == sum(
        chip_smoke.handoff_bytes(n, "bf16", cfg)
        for n in s2["prompt_tokens"])
    assert len(failed) == 4 and all("launches" in f for f in failed), failed


def test_rlhf_phases_on_the_cpu(monkeypatch):
    """RL1 and RL2 at gptj-tiny width (the phases' depths, 16 new tokens
    a rollout) on the CPU: the anakin rounds meet their bars (16
    trajectories, prefix hit rate over 0.5, no sync stall, staleness
    within the lag, one publish a round), version-0 logprobs recomputed by the learner's forward match
    the engine's with the one-late control outside, the probe reads the
    published tree; the sebulba round uses both remote learners on
    disjoint shards and leaves their weights bit-identical. The kernel
    wrappers launch nothing on the CPU, so the launch checks (RL1's paged
    and four flash counts and its check's forwards, RL2's paged count and
    each learner's four flash counts) are the only ones that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.serve import llm_engine
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(
        llm_engine, "_server_device",
        lambda device: torch.device("cpu" if device is None else device))
    monkeypatch.setattr(chip_smoke, "rl_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, max_seq_len=1024))
    monkeypatch.setattr(chip_smoke, "RL_NEW", 16)   # fewer CPU decode steps
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke.rlhf_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    rl1, rl2 = out["RL1"], out["RL2"]
    assert [r["trajectories"] for r in rl1["rounds"]] == \
        [16] * chip_smoke.RL1_ROUNDS
    assert rl1["compute_gradients_calls"] == 4 * chip_smoke.RL1_ROUNDS
    assert rl1["v0_logprob_abs_err_max"] < 1e-4
    assert rl1["control_abs_err_max"] > chip_smoke.LOGPROB_ABS_TOL
    assert rl1["probe"]["versions"] == [1] * 4
    assert rl2["round"]["learners_used"] == 2.0
    assert all(r["prefix_hit_rate"] > 0.5 for r in rl1["rounds"])
    assert len(set(rl2["weights_sha256"])) == 1
    assert [len(w["compute_gradients"]) for w in rl2["learner_walls"]] \
        == [1, 1]
    assert rl1["paged_launches"] == rl2["paged_launches"] == 0
    assert len(failed) == 1 + 4 + 1 + 1 + 8 and all(
        "launch" in f or "forwards" in f for f in failed), failed


def test_sharding_phases_on_the_cpu(monkeypatch):
    """P1-P3 at gptj-tiny width (the phases' depths) on four gloo ranks
    on the CPU, P3 on a one-rank gloo group: P1's losses equal on every
    rank and falling with FSDP_RULES' shard shapes and tp-replicated
    leaves bit-identical; P2's sharded gradients match the one-device
    ones (the faulty control does not), int8 with the sharded update stays
    within JAX's bound and its wire bytes are tree_wire_bytes'; P3's ops
    return their input. The flash wrappers launch nothing on the CPU, so
    P1's launch checks (four kernels on four ranks) are the only ones that
    fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "shard_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16))
    monkeypatch.setattr(chip_smoke, "P3_BACKEND", "gloo")
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke.sharding_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    p1, p2, p3 = out["P1"], out["P2"], out["P3"]
    losses = [r["losses"] for r in p1["ranks"]]
    assert all(row == losses[0] for row in losses)
    assert losses[0][-1] < losses[0][0]
    assert all(r["launches"] == dict.fromkeys(r["launches"], 0)
               for r in p1["ranks"])
    assert p2["sharded"]["grad_rel_l2"] <= chip_smoke.P2_GRAD_REL_L2_BOUND
    assert p2["control"]["worst_leaf_rel_l2"] > \
        chip_smoke.P2_LEAF_REL_L2_BOUND
    assert p2["control"]["worst_leaf"].rsplit(".", 1)[1] in ("wk", "wv")
    assert p2["int8_wire_bytes"] == p2["int8_want_wire_bytes"]
    assert p2["int8_loss_diff_last"] < chip_smoke.INT8_LOSS_BOUND
    assert p3["world_size"] == 1 and all(
        r["equal"] for r in p3.values() if isinstance(r, dict))
    assert len(failed) == 16 and all("launched" in f for f in failed), failed


def test_moe_ring_phases_on_the_cpu(monkeypatch):
    """M1-M3 at gptj-tiny width (the phases' depths; M1's model with 4
    experts) on four gloo ranks on the CPU: M1's losses equal on every
    rank and falling, the expert leaves split over ep and the rest
    bit-identical within each ep pair, tokens dropped for capacity
    reported equal on every rank; M2's ring exchanges as many and as
    large as ``ring_step_bytes`` says, the flash wrappers never called;
    M3's sharded gradients match one device's on both meshes and each
    control does not. The flash wrappers launch nothing on the CPU, so
    M1's launch checks (four kernels on four ranks) are the only ones
    that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "shard_model",
                        lambda n: dataclasses.replace(
                            get_config("gptj-tiny"), n_layers=n,
                            dtype=torch.bfloat16))
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke.moe_ring_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    m1, m2, m3 = out["M1"], out["M2"], out["M3"]
    for rec in (m1, m2):
        losses = [r["losses"] for r in rec["ranks"]]
        assert all(row == losses[0] for row in losses)
        assert losses[0][-1] < losses[0][0]
        assert all(r["launches"] == dict.fromkeys(r["launches"], 0)
                   for r in rec["ranks"])
    assert m1["moe_wi_shard"] == [chip_smoke.M1_LAYERS, 2, 32, 256]
    assert len(m1["dropped_share_by_layer"][0]) == chip_smoke.M1_LAYERS
    want = m2["ring"]["bytes_per_exchange"]
    assert want == 2 * 1 * 64 * 4 * 16 * 4
    assert all(c == m2["ring"]["exchanges_per_step"] and b == c * want
               for steps in m2["ring"]["by_rank_and_step"]
               for c, b, _ in steps)
    for name in ("ep", "sp"):
        assert m3[name]["sharded"]["grad_rel_l2"] <= \
            chip_smoke.M3_GRAD_REL_L2_BOUND
        assert m3[name]["control"]["grad_rel_l2"] > \
            chip_smoke.M3_GRAD_REL_L2_BOUND
    assert len(failed) == 16 and all("launched" in f for f in failed), failed
