"""``chip_smoke.py``'s AR1, WF1 and CL1 rehearsed on the CPU at
gptj-tiny width (bf16; AR1's depth), on one runtime as after JC1 on the
card: the slice arbiter preempts the trainer's slice for the held burst
and returns it once the queue ebbs, the trainer folding to dp=1 and
regrowing to dp=2 with every loss within EL1's bound of the one-device
plan; a workflow whose reduce fails once resumes without running the
flash step again, its output bit-equal to a straight run's; the command
line brings a local cluster up, submits a script and a job, lists its
two nodes, runs the microbenchmark and takes it all down. The wrappers
launch nothing on the CPU, so the launch checks (AR1's replica's paged
launches, its ranks' and driver's flash launches, WF1's two flash steps,
CL1's submitted task) are the only ones that fail here."""

import dataclasses

import torch

import chip_smoke
from test_torch_chip_smoke import _cpu_card


def test_arbiter_workflow_and_cli_phases_on_the_cpu(monkeypatch):
    import cloudpickle

    from ray_tpu_torch.models import get_config
    _cpu_card(monkeypatch)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "pipe_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16,
        remat=None, remat_policy="dots", ce_chunk_size=32))
    monkeypatch.setattr(chip_smoke, "shard_model", lambda n: dataclasses.replace(
        get_config("gptj-tiny"), n_layers=n, dtype=torch.bfloat16,
        max_seq_len=1024))
    monkeypatch.setattr(chip_smoke, "JC_SHAPE", (1, 64, 2, 16))
    # a tiny step is shorter than the default interval: report each step
    monkeypatch.setattr(chip_smoke, "AR_TELEMETRY_S", 1e-6)
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        with chip_smoke.runtime():
            out = chip_smoke.ar_wf_cl_phases(torch.device("cpu"), "cpu", 0)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    ar1, wf1, cl1 = out["AR1"], out["WF1"], out["CL1"]
    assert [r["trigger"] for r in ar1["recoveries"]] == \
        ["notice", "regrow"], failed
    assert ar1["preemptions"] == ar1["returns"] == 1
    assert ar1["preempt_reason"] == "queue-depth"
    assert all(st["rel"] <= chip_smoke.EL1_LOSS_REL for st in ar1["steps"])
    assert ar1["train_row"]["train_tokens_per_s"] > 0
    assert ar1["replica_row"]["queue_depth"] >= 4
    assert sorted(r["slice_id"] for r in ar1["arbiter_rows"]) == \
        sorted([ar1["serve_sid"], ar1["regrown_sid"]])
    assert ar1["divergences"] == [] and ar1["paged_launches"] == 0
    assert wf1["status"] == "SUCCESSFUL" and wf1["stored_bit_equal_straight"]
    assert len(wf1["launches_after_resume"]) == 1
    assert wf1["bit_equal_driver"]
    assert cl1["job"]["status"] == "SUCCEEDED" and cl1["head_group_gone"]
    assert cl1["left"] == [] and cl1["submit"]["current"] == "cpu"
    # AR1: the replica's paged launches, 4 kernels on each of the two
    # dp=2 programs' two ranks and in the driver; WF1's two flash steps;
    # CL1's task
    assert len(failed) == 1 + 4 * (2 + 2 + 1) + 2 + 1 and all(
        "launch" in f for f in failed), failed
