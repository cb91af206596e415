"""Numerical ops of the port: norms, rotary, attention (paged and flash,
each with its hand-written kernels; ring attention over a sequence
group) and the LM cross entropy."""

from ray_tpu_torch.ops.attention import (attention_reference,
                                         multihead_attention,
                                         paged_attention)
from ray_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                             fused_lm_head_loss)
from ray_tpu_torch.ops.flash_attention import (default_flash_blocks,
                                               flash_attention,
                                               flash_delta, flash_dkdv,
                                               flash_dq, flash_fwd)
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.paged_flash import (default_paged_block_r,
                                           paged_flash_attention,
                                           paged_flash_attention_plain,
                                           paged_work_pages)
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_table

__all__ = [
    "apply_rotary", "attention_reference", "cross_entropy_loss",
    "default_flash_blocks", "default_paged_block_r", "flash_attention",
    "flash_delta", "flash_dkdv", "flash_dq", "flash_fwd",
    "fused_lm_head_loss", "layer_norm", "multihead_attention",
    "paged_attention", "paged_flash_attention",
    "paged_flash_attention_plain", "paged_work_pages", "ring_attention",
    "rms_norm", "rotary_table",
]
