"""Parallelism layer of the port: meshes, sharding rules and collectives
on ``torch.distributed`` (the counterpart of ``ray_tpu.parallel``), and
the int8 blockwise wire format (:mod:`ray_tpu_torch.parallel.
quantization`).

Device meshes with named axes (dp/fsdp/tp/sp/ep/pp) over the ranks of a
process group, the JAX package's logical-axis rule tables as explicit
per-rank shards, and eager and autograd-aware collectives over nccl,
gloo or the runtime's KV store. ``mpmd_pipeline`` (the MPMD pipeline of
stage actors, with a dp x fsdp mesh of rank actors inside each stage),
``ParallelPlan`` (one grid lowered to the SPMD step, the pipeline or the
nested ``mpmd3d`` pipeline) and ``ElasticTrainer`` (drain, re-lower,
resume) resolve lazily.
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
    # mpmd_pipeline / plan / elastic import lazily: they pull in the
    # runtime and model layers, which plain sharding users should not pay
    # for at import time
    if name == "mpmd_pipeline":
        import importlib
        return importlib.import_module(
            "ray_tpu_torch.parallel.mpmd_pipeline")
    if name == "ParallelPlan":
        from ray_tpu_torch.parallel.plan import ParallelPlan
        return ParallelPlan
    if name == "ElasticTrainer":
        from ray_tpu_torch.parallel.elastic import ElasticTrainer
        return ElasticTrainer
    raise AttributeError(name)
