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
