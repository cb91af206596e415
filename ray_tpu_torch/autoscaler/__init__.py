"""Autoscaler: scale node pools — and whole slices — to pending demand.
The port's copy of ``ray_tpu/autoscaler``.

Reference: ``python/ray/autoscaler/`` (v1 StandardAutoscaler + providers).
The slice layer (``slices.py``) adds the gang unit: atomic multi-host
slices acquired for SLICE_PACK/SLICE_SPREAD placement groups, drained
preemption-aware on maintenance events, released whole. A slice's hosts
count their CUDA devices as ``GPU``. Beside it: the node providers (the
fake single-node and slice providers start the port's node managers;
``gce.py`` and ``gke.py`` drive the cloud APIs), the v1 autoscaler with
its monitor, the v2 autoscaler (``v2.py``), the train+serve slice
arbiter (``arbiter.py``) and the cluster launcher (``launcher.py``).
"""

from ray_tpu_torch.autoscaler.arbiter import (
    ArbiterPolicy, SliceArbiter, SliceClaim)
from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerMonitor, NodeTypeConfig, StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider, FakeSliceProvider, NodeProvider,
    SliceCapacityError)
from ray_tpu_torch.autoscaler.slices import (
    SliceInfo, SliceManager, SliceTypeConfig, hosts_for_topology)
from ray_tpu_torch.autoscaler.v2 import AutoscalerV2

__all__ = [
    "ArbiterPolicy",
    "AutoscalerMonitor",
    "AutoscalerV2",
    "FakeNodeProvider",
    "FakeSliceProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "SliceArbiter",
    "SliceCapacityError",
    "SliceClaim",
    "SliceInfo",
    "SliceManager",
    "SliceTypeConfig",
    "StandardAutoscaler",
    "hosts_for_topology",
]
