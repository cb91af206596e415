"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package imports
nothing from it. Entry points (``init_params``, ``LLMEngine``,
``make_train_step``, ``make_eval_step``) run on the CUDA device unless
the caller passes ``device="cpu"``, and raise when no CUDA device is
present.
"""

from ray_tpu_torch.exceptions import (EngineDeadError, RayTpuTorchError,
                                      RequestTooLargeError)

__all__ = ["EngineDeadError", "RayTpuTorchError", "RequestTooLargeError"]
