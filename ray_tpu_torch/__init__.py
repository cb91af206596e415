"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package imports
nothing from it. The core runtime (tasks, actors, the shared-memory
object store; ``init``, ``remote``, ``get``, ``put``, ...) is its copy,
carrying torch tensors (CUDA ones leave through a copy to host) and
scheduling CUDA devices as the ``GPU`` resource (``num_gpus``). Entry
points of the model, serving and training subpackages (``init_params``,
``LLMEngine``, ``make_train_step``, ``make_eval_step``) run on the CUDA
device unless the caller passes ``device="cpu"``, and raise when no CUDA
device is present.
"""

from ray_tpu_torch._version import __version__
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.streaming import ObjectRefGenerator, wait_any
from ray_tpu_torch.actor import ActorClass, ActorHandle, ActorMethod
from ray_tpu_torch.api import (
    init,
    shutdown,
    is_initialized,
    remote,
    get,
    put,
    wait,
    kill,
    cancel,
    get_actor,
    method,
    nodes,
    cluster_resources,
    available_resources,
    get_runtime_context,
    timeline,
)
from ray_tpu_torch.exceptions import (
    RayTpuError,
    TaskError,
    ActorError,
    ActorDiedError,
    ActorUnavailableError,
    ObjectLostError,
    TaskCancelledError,
    OutOfMemoryError,
    GetTimeoutError,
    RpcTimeoutError,
    DeliveryFailedError,
    StreamCancelledError,
    AdmissionRejectedError,
    EngineDeadError,
    RequestTooLargeError,
)
from ray_tpu_torch.runtime_context import RuntimeContext

# The model, serving and training subpackages are imported on use: they
# pull in torch.
from ray_tpu_torch import util  # noqa: F401

__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "method",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "wait_any",
    "ActorClass",
    "ActorHandle",
    "ActorMethod",
    "RuntimeContext",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ObjectLostError",
    "TaskCancelledError",
    "OutOfMemoryError",
    "GetTimeoutError",
    "RpcTimeoutError",
    "AdmissionRejectedError",
    "DeliveryFailedError",
    "StreamCancelledError",
    "EngineDeadError",
    "RequestTooLargeError",
]
