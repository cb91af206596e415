"""Models of the port: the decoder-only transformer's serving path and
the named configurations."""

from ray_tpu_torch.models.registry import MODEL_CONFIGS, get_config
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              decode_step, init_kv_cache,
                                              init_params, prefill,
                                              resolve_device)

__all__ = ["MODEL_CONFIGS", "TransformerConfig", "decode_step",
           "get_config", "init_kv_cache", "init_params", "prefill",
           "resolve_device"]
