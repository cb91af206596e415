"""``chip_smoke.py``'s bookkeeping, on the CPU: how it files the kernels a
train-step profile names, reads ptxas's report, bounds the backward, and
that it refuses to run without a card. The phases themselves need the
card and run only there (``python3 chip_smoke.py``)."""

import json
import math

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


def test_pipeline_phases_on_the_cpu(monkeypatch):
    """PL1-PL4 at gptj-tiny width (bf16, the phases' depths) on the CPU:
    the MPMD pipeline through ParallelPlan on two stage actors (v=1, then
    v=2 with PL2's first loss equal to PL1's) with losses falling and no
    gradient reaching the driver; PL3's gradients against one device
    within P2's bounds and the seed-1 control outside, the pipeline's
    checkpoint reloaded into it and into one device; PL4's GPipe over four
    gloo ranks against the sequential layers, its control outside. The
    flash wrappers launch nothing on the CPU, so the launch checks (two
    stages in PL1 and PL2, four ranks in PL4, four kernels each) are the
    only ones that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "pipe_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16,
        remat=None, remat_policy="dots", ce_chunk_size=32))
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke.pipeline_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    pl1, pl2, pl3, pl4 = (out[k] for k in ("PL1", "PL2", "PL3", "PL4"))
    for rec in (pl1, pl2):
        assert rec["losses"][-1] < rec["losses"][0]
        assert rec["stage_gpus"] == 0.5
        assert rec["driver_bytes_per_step"] < 1e6
        assert all(c == dict.fromkeys(c, 0)
                   for c in rec["launches_last_step"])
        act = 1 * 128 * 64 * 2        # a microbatch's activation, bf16
        last = rec["stages_last_step"]
        assert last[0]["sent_bytes"] >= act * chip_smoke.PIPE_MICROBATCHES
    assert pl1["bubble_analytic"] == pytest.approx(0.2)
    assert pl2["bubble_analytic"] == pytest.approx(1 / 9)
    assert pl2["first_loss_rel_to_pl1"] <= chip_smoke.PL2_FIRST_LOSS_REL
    assert pl3["pipeline"]["grad_rel_l2"] <= chip_smoke.P2_GRAD_REL_L2_BOUND
    assert pl3["control"]["grad_rel_l2_at_least"] > \
        chip_smoke.P2_GRAD_REL_L2_BOUND
    assert set(pl3["reload"]["rel"]) == {"pp2_v1", "pp1"}
    assert all(r <= chip_smoke.PL3_RELOAD_LOSS_REL
               for r in pl3["reload"]["rel"].values())
    assert pl4["gpipe"]["out_rel_l2"] <= chip_smoke.PL4_OUT_REL_L2
    assert pl4["gpipe"]["grad_rel_l2"] <= chip_smoke.PL4_GRAD_REL_L2
    assert pl4["control"]["grad_rel_l2"] > chip_smoke.PL4_GRAD_REL_L2
    ticks = chip_smoke.PIPE_MICROBATCHES + chip_smoke.PL4_STAGES - 1
    assert all(e["calls"] == 2 * ticks - 1 for e in pl4["gpipe"]["exchanges"])
    assert len(failed) == 32 and all("launched" in f for f in failed), failed


def test_mesh_and_elastic_phases_on_the_cpu(monkeypatch):
    """PL5, PL6 and EL1 at gptj-tiny width (bf16, the phases' depths) on
    the CPU, each on a runtime of its own: PL5's stage-mesh gradients
    (pp 2 x dp 2, four rank actors) against one device within P2's
    bounds, its control outside at twice the reference's norm, an f32
    reduction a rank; PL6 with int8 transport and the flat update: losses
    falling, a stage's ranks bit-identical, the int8 reduction under a
    third of the f32 gradient's bytes, half the Adam bytes, under 1 MB a
    step to the driver; EL1's notice fold and killed-actor recovery
    against the one-device plan step for step, with the slice and elastic
    events. The flash wrappers launch nothing on the CPU, so the launch
    checks are the only ones that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "pipe_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16,
        remat=None, remat_policy="dots", ce_chunk_size=32))
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        out = chip_smoke.mesh_elastic_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    pl5, pl6, el1 = (out[k] for k in ("PL5", "PL6", "EL1"))
    assert pl5["num_gpus_a_rank"] == 0.25
    assert pl5["pipeline"]["grad_rel_l2"] <= chip_smoke.P2_GRAD_REL_L2_BOUND
    assert abs(pl5["control"]["ratio"] - 2) <= chip_smoke.PL5_CONTROL_RATIO_TOL
    assert [(r["stage"], r["rank"]) for r in pl5["reduction"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["reduce_bytes"] > 0 for r in pl5["reduction"])
    assert pl6["losses"][-1] < pl6["losses"][0]
    assert pl6["replicas_bit_identical"] == [True, True]
    assert pl6["driver_bytes_per_step"] < 1e6
    for st, r in zip(pl6["stages_last_step"], pl6["replicas"]):
        assert 0 < st["reduce_bytes"] < r["grad_f32_bytes"] / 3
        assert r["adam_bytes"] <= 0.51 * r["adam_bytes_plain"]
    assert [(r["trigger"], r["steps_lost"]) for r in el1["recoveries"]] == \
        [("notice", 0), ("failure", 3)]
    assert all(st["rel"] <= chip_smoke.EL1_LOSS_REL for st in el1["steps"])
    assert el1["slice_state"] == "RELEASED"
    assert {"SLICE_DRAIN", "SLICE_DOWN", "ELASTIC_RESUME"} <= set(el1["events"])
    # 4 kernels: PL5's and PL6's four ranks, EL1's first program's four,
    # the second's surviving rank, the last program's two
    assert len(failed) == 4 * (4 + 4 + 4 + 1 + 2) \
        and all("launched" in f for f in failed), failed


def test_rllib_phases_on_the_cpu(monkeypatch):
    """RLL1, RLL2 and RLL3 at hiddens (16, 16) and a small batch on the
    CPU, on one runtime as after EL1 on the card: PPO's two iterations
    and the streamed one with the runners' weights, ``save``/``restore``
    bit for bit and the repeated update (its control outside the bound);
    one iteration of PG, IMPALA, APPO and multi-agent PPO, V-trace, and
    the group of two remote learners against one, bit-identical, its
    control outside; DQN past its target sync, discrete and continuous
    SAC, TD3 (its delayed policy step), then CQL, BC, MARWIL and the
    estimators from the port's JSON files, every off-policy learner's
    update repeated from its state (the control outside the bound),
    ``update_many`` against single updates. No kernel runs here, so
    every check holds."""
    import cloudpickle
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "RLL_HIDDENS", (16, 16))
    monkeypatch.setattr(chip_smoke, "RLL1", dict(
        chip_smoke.RLL1, train_batch_size=256, minibatch_size=64,
        num_epochs=2))
    monkeypatch.setattr(chip_smoke, "RLL_MA_BATCH", 128)
    monkeypatch.setattr(chip_smoke, "RLL_GROUP_ROWS", 64)
    monkeypatch.setattr(chip_smoke, "RLL3_OFFLINE_ROWS", 400)
    monkeypatch.setattr(chip_smoke, "RLL3_TRAINING", {
        "num_steps_sampled_before_learning_starts": 64,
        "target_network_update_freq": 100})
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        with chip_smoke.runtime():
            out = chip_smoke.rllib_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    assert failed == []
    rll1, rll2 = out["RLL1"], out["RLL2"]
    assert [it["updates"] for it in rll1["iterations"][:2]] == [8, 8]
    assert rll1["restored_sha"] == rll1["weights_sha"][-1]
    agree = rll1["agreement"]
    assert agree["count"] == 8
    assert agree["loss_rel"] <= chip_smoke.RLL_LOSS_REL
    assert agree["update_rel"] <= chip_smoke.RLL_UPDATE_REL \
        < agree["control_rel"]
    assert rll1["learner_device"] == ["cpu"]
    for name in ("PG", "IMPALA", "APPO", "MultiAgentPPO"):
        assert rll2[name]["iteration"]["steps_lifetime"] > 0
    assert rll2["APPO"]["vtrace"]["vs_rel"] <= chip_smoke.RLL_VTRACE_REL
    group = rll2["group"]
    assert group["replica_sha"][0] == group["replica_sha"][1]
    assert group["update_rel"] <= chip_smoke.RLL_GROUP_REL \
        < group["control_rel"]
    rll3 = out["RLL3"]
    assert rll3["DQN"]["updates"] == 100 + chip_smoke.RLL3_PAST_SYNC
    assert rll3["DQN"]["target"]["at_sync"] == 0.0
    assert rll3["TD3"]["delay"]["odd"]["pi_count"] == 0
    for rec in (rll3["DQN"], rll3["SAC"]["continuous"], rll3["TD3"],
                rll3["offline"]["CQL"]):
        assert rec["learner_device"] == ["cpu"]
        agree = rec["agreement"]
        assert agree["loss_rel"] <= chip_smoke.RLL_LOSS_REL
        assert agree["update_rel"] <= chip_smoke.RLL_UPDATE_REL \
            < agree["control_rel"]
    assert rll3["SAC"]["continuous"]["burst"]["state_gap"] \
        <= chip_smoke.RLL3_BURST_ABS
    offline = rll3["offline"]
    assert offline["json_bit_for_bit"] == {"random": True, "pendulum": True}
    assert offline["estimators"]["is_rel"] <= chip_smoke.RLL3_IS_RTOL
    assert set(rll3["summary"]["update_ms_median"]) == {
        "DQN", "SAC discrete", "SAC continuous", "TD3", "CQL", "BC",
        "MARWIL"}


def test_trainer_and_tuner_phases_on_the_cpu(monkeypatch):
    """TR1 and TN1 at gptj-tiny width (bf16; TN1 at its depth, TR1 at 2
    layers: the card's TR1 runs at TR_LAYERS = 1, where gptj-tiny's loss
    does not fall within its steps at TR_LR) on the
    CPU, on one runtime as after RLL3 on the card: TR1's two workers (half
    a GPU each) train over fsdp 2, report the gathered state after step
    0, lose rank 1 after its first step-2 update and resume from the
    checkpoint: one restart, the re-run steps' losses equal to the killed
    attempt's, losses equal on both ranks and falling, the checkpoint loading
    back with its step; TN1's two trials of one worker each, the best the
    one with the lower last loss. The flash wrappers launch nothing on
    the CPU, so the launch checks (four kernels for each attempt of each
    TR1 rank and each TN1 trial) are the only ones that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "shard_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16))
    monkeypatch.setattr(chip_smoke, "TR_LAYERS", 2)
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        with chip_smoke.runtime():
            out = chip_smoke.train_tune_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    tr1, tn1 = out["TR1"], out["TN1"]
    assert [(s["attempt"], s["step"]) for s in tr1["steps"]] == [
        (0, 0), (0, 1), (0, 2), (1, 1), (1, 2)]
    assert tr1["rerun_losses"] == tr1["killed_losses"]
    assert sorted(tr1["rerun_losses"]) == [1, 2]
    assert tr1["steps"][-1]["loss"] < tr1["steps"][0]["loss"]
    assert tr1["devices"] == ["cpu"]
    assert tr1["checkpoint"]["gb"] > 0
    assert tr1["restart_s"] > 0 and tr1["gang_start_s"]["first"] > 0
    assert [t["lr"] for t in tn1["trials"]] == list(chip_smoke.TN_LRS)
    low = min(tn1["trials"], key=lambda t: t["losses"][-1])
    assert tn1["best_lr"] == low["lr"]
    assert all(len(t["losses"]) == chip_smoke.TN_STEPS
               for t in tn1["trials"])
    assert len(failed) == 4 * (2 * 2 + 2) \
        and all("launched" in f for f in failed), failed


def test_data_and_pbt_phases_on_the_cpu(monkeypatch):
    """D1 and TN2 at gptj-tiny width (bf16, the phases' depths) on the
    CPU, on one runtime as after TN1 on the card: D1's dataset (range ->
    map_batches -> random_shuffle) streamed into two workers over fsdp 2,
    every id consumed once and three a rank, each row the one its id
    builds, losses equal on both ranks and falling, step 0 against one
    device; TN2's PBT round cloning one trial's state into the other,
    the clone's checksums and next loss equal to the source's. The flash
    wrappers launch nothing on the CPU, so the launch checks (four
    kernels for each D1 rank and each TN2 trial actor) are the only ones
    that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "shard_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16))
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        with chip_smoke.runtime():
            out = chip_smoke.data_tune_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    d1, tn2 = out["D1"], out["TN2"]
    assert sorted(i for r in d1["ids_a_rank"] for i in r) == list(range(6))
    assert [len(r) for r in d1["ids_a_rank"]] == [3, 3]
    assert [s["step"] for s in d1["steps"]] == [0, 1, 2]
    assert d1["steps"][-1]["loss"] < d1["steps"][0]["loss"]
    assert d1["loss_rel"] <= chip_smoke.P2_LOSS_REL_BOUND
    assert d1["devices"] == ["cpu"] and d1["rows_bytes"] > 0
    assert tn2["perturbations"] >= 1 and len(tn2["exploits"]) >= 1
    x = tn2["exploits"][0]
    assert x["loss"][0] == x["loss"][1] and x["target"] != x["source"]
    actors = sum(t["actors"] for t in tn2["trials"].values())
    assert actors == 3      # the trial that paused first restarts once
    assert all(t["state_steps"][-1] == chip_smoke.TN2_STEPS - 1
               for t in tn2["trials"].values())
    assert len(failed) == 4 * (2 + actors) \
        and all("launched" in f for f in failed), failed


def test_dag_and_job_phases_on_the_cpu(monkeypatch):
    """DG1 and JC1 at gptj-tiny width (bf16, DG1's depth) on the CPU, on
    one runtime as after TN2 on the card: the compiled DAG builds its
    channel pipeline, each row's loss through the two stage actors is
    bit-equal to the stage functions run in the driver and comes back a
    CPU tensor, no channel file or actor is left; a job submitted
    through the dashboard and a ``ray://`` client each run the flash
    forward's wrapper (its plain version on the CPU) on the seeded
    inputs and agree with the driver's, the sleeping job is stopped,
    the cluster status lists the GPU, and a whole-GPU task runs once the
    client has gone. The flash wrapper launches nothing on the CPU, so
    the launch checks (DG1's two stage actors, JC1's job task and client
    actor) are the only ones that fail here."""
    import dataclasses

    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "shard_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16))
    monkeypatch.setattr(chip_smoke, "JC_SHAPE", (1, 64, 2, 16))
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        with chip_smoke.runtime():
            out = chip_smoke.dag_job_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    dg1, jc1 = out["DG1"], out["JC1"]
    assert len(dg1["losses"]) == chip_smoke.DG_ROWS
    assert all(math.isfinite(x) for x in dg1["losses"])
    assert dg1["hop_shape"] == [1, 128, 64]
    assert dg1["hop_bytes"] > dg1["hop_tensor_bytes"] > 0
    assert len(dg1["later_execute_s"]) == chip_smoke.DG_ROWS - 1
    assert len(set(dg1["stage_pids"])) == 2
    assert jc1["job_launches"]["flash_fwd"] == 0 \
        and jc1["client_launches"]["flash_fwd"] == 0
    assert jc1["submit_to_succeeded_s"] < chip_smoke.JC_JOB_S
    assert len(failed) == 4 and all("launched" in f for f in failed), failed


def test_a_group_mismatch_prints_leaf_checksums_and_names_the_leaf(capsys):
    """RLL2's group check (``same_trees``): two weight trees that differ
    in one leaf print a checksum line for every leaf of both (path,
    shape, dtype, float64 sum; the differing one marked) and the
    learner actors' worker ids, then fail naming that leaf; equal trees
    pass silently."""
    import numpy as np
    rng = np.random.default_rng(0)
    a = {"pi": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                "b": np.zeros(3, np.float32)},
         "vf": [rng.normal(size=(3,)).astype(np.float32)]}
    b = {"pi": {"w": a["pi"]["w"].copy(), "b": a["pi"]["b"].copy()},
         "vf": [a["vf"][0].copy()]}
    chip_smoke.same_trees("RLL2 trees", a, b, ["w0", "w1"])
    assert capsys.readouterr().out == ""
    b["vf"][0][1] += 1e-3
    with pytest.raises(chip_smoke.SmokeFailure, match=r"\['vf/0'\] differ"):
        chip_smoke.same_trees("RLL2 trees", a, b, ["w0", "w1"])
    out = capsys.readouterr().out.splitlines()
    leaves = [line for line in out if ": leaf " in line]
    assert [line.split(": leaf ")[1].split(":")[0] for line in leaves] \
        == ["pi/b", "pi/w", "vf/0"]
    assert [line.endswith("DIFFERS") for line in leaves] \
        == [False, False, True]
    assert "(4, 3), 'float32'" in leaves[1]
    assert any("worker ids ['w0', 'w1']" in line for line in out)


# ------------------------------------------------- AR1, WF1, CL1 checks
_FLASH = ("flash_fwd", "flash_delta", "flash_dkdv", "flash_dq")


def _ar1_record():
    """A record AR1's checks pass: the card's, as the phase builds it."""
    n = chip_smoke.AR_LAYERS
    dp2, one = "spmd[dp=2 fp32]", "spmd[single-device fp32]"
    stages = ["dp=2"] * chip_smoke.AR_STEPS[0] \
        + ["folded"] * chip_smoke.AR_STEPS[1] \
        + ["regrown"] * chip_smoke.AR_STEPS[2]
    steps = [{"step": k + 1, "stage": st, "loss": 11.0 - k,
              "loss_one_device": 11.0 - k, "rel": 1e-4,
              "plan": one if st == "folded" else dp2}
             for k, st in enumerate(stages)]
    rank = [{"launches": {f: c * n for f in _FLASH}, "pid": 7}
            for c in (chip_smoke.AR_STEPS[0], chip_smoke.AR_STEPS[2])]
    return {
        "steps": steps,
        "recoveries": [{"trigger": "notice", "from_plan": dp2,
                        "to_plan": one, "steps_lost": 0},
                       {"trigger": "regrow", "from_plan": one,
                        "to_plan": dp2, "steps_lost": 0}],
        "preemptions": 1, "returns": 1, "preempt_reason": "queue-depth",
        "train_sid": "t0", "serve_sid": "s0", "regrown_sid": "t1",
        "events": [{"ev": "ARBITER_PREEMPT", "slice": "t0",
                    "reason": "queue-depth"},
                   {"ev": "ARBITER_RETURN", "slice": "t1",
                    "reason": "pressure-ebbed"}],
        "slices": {"t0": "RELEASED", "s0": "UP", "t1": "UP"},
        "arbiter_rows": [{"slice_id": "s0"}, {"slice_id": "t1"}],
        "train_row": {"train_tokens_per_s": 5000.0},
        "replica_row": {"queue_depth": 15.0}, "burst_queue_depth_max": 15.0,
        "stream_lengths": [48] * 16, "divergences": [],
        "prefill_chunks": 40, "decode_steps": 60, "paged_launches": 100 * n,
        "launches": [[rank[0], rank[0]], [], [rank[1], rank[1]]],
        "driver_launches": {f: (sum(chip_smoke.AR_STEPS)
                                + chip_smoke.AR_STEPS[1]) * n
                            for f in _FLASH}}


def _set(rec, path, value):
    *head, last = path
    for k in head:
        rec = rec[k]
    rec[last] = value


@pytest.mark.parametrize("path,value", [
    (("steps", 3, "rel"), 3e-3),                        # EL1's bound
    (("steps", 2, "plan"), "spmd[dp=2 fp32]"),          # never folded
    (("recoveries", 0, "steps_lost"), 2),
    (("recoveries", 1, "trigger"), "failure"),
    (("preemptions",), 2),
    (("returns",), 0),
    (("preempt_reason",), "ttft-p99"),
    (("events", 1, "slice"), "t9"),
    (("slices", "t0"), "UP"),                           # not released
    (("arbiter_rows", 1, "slice_id"), "t0"),
    (("train_row",), {"train_tokens_per_s": 0.0}),
    (("replica_row", "queue_depth"), 3.0),
    (("stream_lengths", 5), 47),
    (("divergences",), [{"near_tie": False}]),
    (("paged_launches",), 99),
    (("launches", 2, 1, "launches", "flash_dq"), 0),
    (("driver_launches", "flash_fwd"), 0),
])
def test_ar1_checks_fail_on_a_wrong_record(path, value):
    n = chip_smoke.AR_LAYERS
    chip_smoke.ar1_checks(_ar1_record(), n)
    bad = _ar1_record()
    _set(bad, path, value)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.ar1_checks(bad, n)


def _wf1_record():
    log = [{"launches": {f: int(f == "flash_fwd") for f in _FLASH},
            "current": "cuda:0", "pid": 5}]
    return {"first_run_error": "TaskError: WF1: the reduce's first "
                               "attempt fails",
            "status_after_failure": "FAILED",
            "launches_before_resume": log, "launches_after_resume": list(log),
            "straight_launches": [dict(log[0], pid=6)],
            "status": "SUCCESSFUL", "stored_bit_equal_straight": True,
            "bit_equal_driver": True, "listed": ["wf1", "wf1-straight"],
            "listed_after_delete": ["wf1-straight"],
            "timer": {"fired": 12.5}, "timer_target": 12.5,
            "timer_status": "SUCCESSFUL"}


@pytest.mark.parametrize("path,value", [
    (("first_run_error",), None),
    (("status_after_failure",), "SUCCESSFUL"),
    (("launches_after_resume",), [{"launches": {"flash_fwd": 1},
                                   "current": "cuda:0"}] * 2),
    (("straight_launches", 0, "current"), "cpu"),
    (("straight_launches", 0, "launches", "flash_fwd"), 0),
    (("status",), "FAILED"),
    (("stored_bit_equal_straight",), False),
    (("bit_equal_driver",), False),
    (("listed_after_delete",), ["wf1", "wf1-straight"]),
    (("timer",), {"fired": 12.0}),
])
def test_wf1_checks_fail_on_a_wrong_record(path, value):
    chip_smoke.wf1_checks(_wf1_record(), "cuda:0")
    bad = _wf1_record()
    _set(bad, path, value)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.wf1_checks(bad, "cuda:0")


def _cl1_record():
    from ray_tpu_torch.scripts.perf import BASELINES
    return {"up": {"created": True, "slices": ["slice-host-1"]},
            "submit": {"current": "cuda:0", "launches": {
                f: int(f == "flash_fwd") for f in _FLASH}},
            "job": {"id": "j", "status": "SUCCEEDED"},
            "status": "Nodes: 2 alive / 2 total\nResources:\n  GPU: 1/1",
            "nodes": [{"alive": True, "labels": {}},
                      {"alive": True,
                       "labels": {"ray-tpu-slice-id": "slice-host-1"}}],
            "microbenchmark": [{"metric": k, "value": 1.0}
                               for k in BASELINES],
            "down": {"rc": 0}, "head_group_gone": True, "left": [],
            "left_on_gpu": [], "tree": 6}


@pytest.mark.parametrize("path,value", [
    (("up", "slices"), []),
    (("submit", "current"), "cpu"),
    (("submit", "launches", "flash_fwd"), 2),
    (("job", "status"), "FAILED"),
    (("status",), "Nodes: 1 alive / 1 total\nResources:\n  GPU: 1/1"),
    (("nodes", 1, "labels"), {}),
    (("microbenchmark",), [{"metric": "tasks_sync_per_s", "value": 1.0}]),
    (("down", "rc"), 1),
    (("head_group_gone",), False),
    (("left",), [1234]),
    (("left_on_gpu",), [1234]),
])
def test_cl1_checks_fail_on_a_wrong_record(path, value):
    chip_smoke.cl1_checks(_cl1_record(), "cuda:0")
    bad = _cl1_record()
    _set(bad, path, value)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.cl1_checks(bad, "cuda:0")
