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
