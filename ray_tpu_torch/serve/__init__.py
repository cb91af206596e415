"""Serving in the port: the continuous-batching engine over the paged
KV cache, its refcounted prefix-sharing block pool, the KV hand-off's
wire codec, and per-request tracing with its SLO watchdog."""

from ray_tpu_torch.serve.disagg import (DisaggHandoffError, kv_ship_bytes,
                                        pack_kv_blocks, unpack_kv_blocks)
from ray_tpu_torch.serve.llm_engine import EngineConfig, LLMEngine
from ray_tpu_torch.serve.prefix_cache import (PrefixBlockPool,
                                              prefix_fingerprint)
from ray_tpu_torch.serve.request_trace import (RequestTrace, RequestTracer,
                                               RequestTraceStore,
                                               new_request_id)
from ray_tpu_torch.serve.slo import SLOBudget, SLOWatchdog

__all__ = ["DisaggHandoffError", "EngineConfig", "LLMEngine",
           "PrefixBlockPool", "RequestTrace", "RequestTraceStore",
           "RequestTracer", "SLOBudget", "SLOWatchdog", "kv_ship_bytes",
           "new_request_id", "pack_kv_blocks", "prefix_fingerprint",
           "unpack_kv_blocks"]
