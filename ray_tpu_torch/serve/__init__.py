"""ray_tpu_torch.serve: model serving (reference: ``python/ray/serve/``).

The port's copy of ``ray_tpu.serve``, with the same surface:
``@serve.deployment``, ``serve.run``, DeploymentHandle composition,
``@serve.batch`` dynamic batching, admission control, queue-depth
autoscaling, a JSON-over-HTTP proxy (and a gRPC one), and the LLM
serving stack over the paged engine: ``LLMServer`` and the
disaggregated prefill/decode pair (``deploy_disaggregated``,
``DisaggRouter``). Beyond the JAX list it also exports the per-request
tracing and SLO classes that earlier slices exported.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    grpc_proxy_address,
    proxy_address,
    proxy_addresses,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.admission import (
    AdmissionController, AdmissionPolicy, PRIORITY_CLASSES)
from ray_tpu_torch.serve.http import Request, Response, ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.deployment import (
    Application, AutoscalingConfig, Deployment, deployment)
from ray_tpu_torch.serve.disagg import (
    DisaggHandoffError, DisaggRouter, deploy_disaggregated,
    kv_ship_bytes, migrate_warm_prefixes, pack_kv_blocks,
    unpack_kv_blocks)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle, DeploymentResponse, DeploymentResponseGenerator)
from ray_tpu_torch.serve._private.replica import get_multiplexed_model_id
from ray_tpu_torch.serve.llm_engine import (
    EngineConfig, EngineDeadError, LLMEngine, LLMServer,
    RequestTooLargeError)
from ray_tpu_torch.serve.prefix_cache import PrefixBlockPool, prefix_fingerprint
from ray_tpu_torch.serve.request_trace import (RequestTrace, RequestTracer,
                                               RequestTraceStore,
                                               new_request_id)
from ray_tpu_torch.serve.slo import SLOBudget, SLOWatchdog

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "Application",
    "AutoscalingConfig",
    "PRIORITY_CLASSES",
    "Deployment",
    "DeploymentHandle",
    "DisaggHandoffError",
    "DisaggRouter",
    "deploy_disaggregated",
    "kv_ship_bytes",
    "migrate_warm_prefixes",
    "pack_kv_blocks",
    "unpack_kv_blocks",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "EngineConfig",
    "EngineDeadError",
    "LLMEngine",
    "LLMServer",
    "PrefixBlockPool",
    "RequestTooLargeError",
    "RequestTrace",
    "RequestTraceStore",
    "RequestTracer",
    "SLOBudget",
    "SLOWatchdog",
    "new_request_id",
    "prefix_fingerprint",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "grpc_proxy_address",
    "ingress",
    "proxy_address",
    "proxy_addresses",
    "Request",
    "Response",
    "run",
    "shutdown",
    "start",
    "status",
]
