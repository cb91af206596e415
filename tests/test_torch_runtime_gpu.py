"""The port's runtime on the card: CUDA tensors through tasks and the
store, and a worker forked from the zygote using the card.

Every test here needs a CUDA device; without one each skips. Run on the
card with ``python -m pytest -m gpu tests/test_torch_runtime_gpu.py``.
"""

import os

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the test files of the CPU runtime keep workers off the card
    monkeypatch.delenv("RAY_TPU_TORCH_PLATFORM", raising=False)
    import ray_tpu_torch
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_cuda_tensor_through_a_task_and_back(on_card):
    """A CUDA tensor put from the driver comes back from ``get`` as a CPU
    tensor of the same bits; a ``num_gpus=1`` task moves its argument to
    the card and returns a CUDA tensor, which the driver gets as the same
    bits on the CPU."""
    rt = on_card
    rt.init(num_cpus=2, _num_initial_workers=0)
    assert rt.cluster_resources().get("GPU") == torch.cuda.device_count()
    g = torch.Generator().manual_seed(0)
    host = torch.randn(1024, 1536, generator=g).to(torch.bfloat16)
    dev = host.cuda()
    back = rt.get(rt.put(dev), timeout=120)
    assert back.device.type == "cpu" and torch.equal(back, host)

    @rt.remote(num_gpus=1)
    def double_on_card(t):
        d = t.cuda()
        return d * 2, d.float().sum().item(), torch.cuda.get_device_name()

    out, total, name = rt.get(double_on_card.remote(dev), timeout=300)
    assert out.device.type == "cpu" and torch.equal(out, host * 2)
    assert total == dev.float().sum().item()
    assert name == torch.cuda.get_device_name(0)


def test_a_zygote_forked_worker_uses_the_card(on_card):
    """The zygote imported the worker stack without touching CUDA, so a
    worker it forks can initialise the card. ``chip_smoke.start_zygote``
    starts it and leaves no cold worker idle, so the actor's worker is a
    fork."""
    import cloudpickle

    import chip_smoke
    rt = on_card
    rt.init(num_cpus=2, _num_initial_workers=0,
            _system_config={"prestart_workers": 0})
    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        chip_smoke.start_zygote()

        @rt.remote(num_gpus=1)
        class OnCard:
            def run(self):
                x = torch.arange(1 << 20, device="cuda", dtype=torch.float64)
                return (os.getpid(), x.sum().item(),
                        torch.cuda.get_device_name())

        pid, total, name = rt.get(OnCard.remote().run.remote(), timeout=300)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    assert total == float((1 << 20) * ((1 << 20) - 1) // 2)
    assert name == torch.cuda.get_device_name(0)
    assert chip_smoke.forked(pid), f"worker {pid} was not forked"
