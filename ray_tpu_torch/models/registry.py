"""Named model configurations: the JAX package's five, with torch
dtypes. ``gptj-6b`` is EleutherAI GPT-J-6B (28 layers, d_model 4096,
16 heads x 256, rotary_dim 64, d_ff 16384, vocab 50400, bf16);
``llama2-7b`` is Llama-2-7B; ``*-tiny`` keep the block structure at test
scale."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ray_tpu_torch.models.transformer import TransformerConfig

MODEL_CONFIGS: Dict[str, TransformerConfig] = {
    "gptj-6b": TransformerConfig(
        vocab_size=50400, d_model=4096, n_layers=28, n_heads=16,
        head_dim=256, d_ff=16384, max_seq_len=2048, rotary_dim=64,
        block_style="gptj"),
    "moe-tiny": TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=128, max_seq_len=128, rotary_dim=8, block_style="gptj",
        n_experts=4, dtype=torch.float32, remat=False),
    "gptj-tiny": TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=256, max_seq_len=128, rotary_dim=8, block_style="gptj",
        dtype=torch.float32, remat=False),
    "llama2-7b": TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        head_dim=128, d_ff=11008, max_seq_len=4096, rotary_dim=128,
        block_style="llama"),
    "llama2-tiny": TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        n_kv_heads=2, d_ff=128, max_seq_len=128, rotary_dim=16,
        block_style="llama", dtype=torch.float32, remat=False),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(
            f"unknown model {name!r}; have {sorted(MODEL_CONFIGS)}")
    cfg = MODEL_CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
