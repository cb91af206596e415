"""GPU accelerator detection and isolation.

The port's counterpart of ``ray_tpu/core/accelerators.py`` (TPU chips),
after the reference's ``python/ray/_private/accelerators/nvidia_gpu.py``
(NvidiaGPUAcceleratorManager): count the CUDA devices this host offers
the runtime, as the ``GPU`` resource, and keep a CPU-only worker off
every card through ``CUDA_VISIBLE_DEVICES``, which also bounds the
count. A node told its count (``init(num_gpus=...)``, ``--num-gpus``)
does not detect.

Counting must not initialise CUDA in a process that later forks: a child
forked after ``cuInit`` cannot use the card. ``torch.cuda.device_count``
asks NVML first and does not initialise the CUDA runtime when NVML
answers; the runtime counts in the head (the driver process) and in
node managers, which start workers through ``exec``, never in the
zygote.
"""

from __future__ import annotations

import os


def gpu_count() -> int:
    """CUDA devices this process may use: ``torch.cuda.device_count``,
    which honours ``CUDA_VISIBLE_DEVICES`` (0 without a card or torch)."""
    try:
        import torch
    except ImportError:
        return 0
    return torch.cuda.device_count()


def hide_gpus() -> None:
    """Keep this process off every card (a CPU-only worker)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
