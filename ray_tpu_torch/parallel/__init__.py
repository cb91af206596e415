"""Parallelism layer of the port: meshes, sharding rules and collectives
on ``torch.distributed`` (the counterpart of ``ray_tpu.parallel``), and
the int8 blockwise wire format (:mod:`ray_tpu_torch.parallel.
quantization`).

Device meshes with named axes (dp/fsdp/tp/sp/ep/pp) over the ranks of a
process group, the JAX package's logical-axis rule tables as explicit
per-rank shards, and eager and autograd-aware collectives over nccl,
gloo or the runtime's KV store. The MPMD pipeline, parallel plans and
elastic training (ROADMAP Queue 1 item 9) are not ported yet.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    local_mesh,
    chip_spec,
    ChipSpec,
)
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    logical_to_mesh_axes,
    shard_params,
    batch_sharding,
    constrain,
)
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel import quantization

__all__ = [
    "mpmd_pipeline",
    "ParallelPlan",
    "ElasticTrainer",
    "MeshSpec",
    "build_mesh",
    "local_mesh",
    "chip_spec",
    "ChipSpec",
    "ShardingRules",
    "logical_to_mesh_axes",
    "shard_params",
    "batch_sharding",
    "constrain",
    "collective",
    "quantization",
]


def __getattr__(name):
    if name in ("mpmd_pipeline", "ParallelPlan", "ElasticTrainer"):
        raise NotImplementedError(
            f"ray_tpu_torch.parallel.{name}: the MPMD pipeline, parallel "
            f"plans and elastic training are ROADMAP Queue 1 item 9, not "
            f"ported yet")
    raise AttributeError(name)
