"""Numerical ops of the port: norms, rotary, attention and the paged
attention kernel's wrapper."""

from ray_tpu_torch.ops.attention import attention_reference, paged_attention
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.paged_flash import (default_paged_block_r,
                                           paged_flash_attention,
                                           paged_flash_attention_plain,
                                           paged_work_pages)
from ray_tpu_torch.ops.rotary import apply_rotary, rotary_table

__all__ = [
    "apply_rotary", "attention_reference", "default_paged_block_r",
    "layer_norm", "paged_attention", "paged_flash_attention",
    "paged_flash_attention_plain", "paged_work_pages", "rms_norm",
    "rotary_table",
]
