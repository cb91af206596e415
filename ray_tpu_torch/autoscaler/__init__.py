"""Autoscaler: scale node pools — and whole slices — to pending demand.
The port's copy of ``ray_tpu/autoscaler``.

Reference: ``python/ray/autoscaler/`` (v1 StandardAutoscaler + providers).
The slice layer (``slices.py``) adds the gang unit: atomic multi-host
slices acquired for SLICE_PACK/SLICE_SPREAD placement groups, drained
preemption-aware on maintenance events, released whole. The port copies
the slice manager, the node providers (the fake single-node and slice
providers start the port's node managers) and the v1 autoscaler with its
monitor. The cloud providers (GCE, GKE), the launcher, the train+serve
slice arbiter and the v2 autoscaler are ROADMAP Queue 1 item 11 and raise
``NotImplementedError``.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerMonitor, NodeTypeConfig, StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider, FakeSliceProvider, NodeProvider,
    SliceCapacityError)
from ray_tpu_torch.autoscaler.slices import (
    SliceInfo, SliceManager, SliceTypeConfig, hosts_for_topology)

__all__ = [
    "AutoscalerMonitor",
    "FakeNodeProvider",
    "FakeSliceProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "SliceCapacityError",
    "SliceInfo",
    "SliceManager",
    "SliceTypeConfig",
    "StandardAutoscaler",
    "hosts_for_topology",
]

#: what the JAX package's autoscaler has and the port does not yet
_NOT_PORTED = {
    "gce": "the GCE TPU provider (autoscaler/gce.py)",
    "gke": "the GKE provider (autoscaler/gke.py)",
    "launcher": "the cluster launcher (autoscaler/launcher.py)",
    "arbiter": "the train+serve slice arbiter (autoscaler/arbiter.py)",
    "ArbiterPolicy": "the train+serve slice arbiter (autoscaler/arbiter.py)",
    "SliceArbiter": "the train+serve slice arbiter (autoscaler/arbiter.py)",
    "SliceClaim": "the train+serve slice arbiter (autoscaler/arbiter.py)",
    "v2": "the v2 autoscaler (autoscaler/v2.py)",
    "AutoscalerV2": "the v2 autoscaler (autoscaler/v2.py)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.autoscaler.{name}: {_NOT_PORTED[name]} is "
            f"ROADMAP Queue 1 item 11, not ported yet")
    raise AttributeError(name)
