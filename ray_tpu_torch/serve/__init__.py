"""Serving in the port: the continuous-batching engine over the paged
KV cache and its refcounted prefix-sharing block pool."""

from ray_tpu_torch.serve.llm_engine import EngineConfig, LLMEngine
from ray_tpu_torch.serve.prefix_cache import PrefixBlockPool

__all__ = ["EngineConfig", "LLMEngine", "PrefixBlockPool"]
