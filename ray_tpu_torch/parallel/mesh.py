"""Device meshes over the ranks of a ``torch.distributed`` process group:
the port of ``ray_tpu/parallel/mesh.py``.

The axis vocabulary is the JAX package's:

- ``dp``   pure data parallel (params replicated)
- ``fsdp`` data parallel with parameter/optimizer sharding (ZeRO-3-like)
- ``tp``   tensor parallel
- ``sp``   sequence/context parallel (ring attention axis)
- ``ep``   expert parallel (MoE)
- ``pp``   pipeline parallel

:func:`build_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
with ``mesh_dim_names=AXIS_ORDER`` over the ranks of the default process
group, rank ``r`` at the coordinates of ``r`` unravelled in
``AXIS_ORDER``: the order in which JAX's ``build_mesh`` reshapes
``jax.devices()``, so port rank ``i`` holds what JAX device ``i`` holds.
Each process is one rank; a rank's tensors are its shards.

Collectives along one axis use the mesh's own group for it
(``mesh.get_group(axis)``); :func:`axis_group` also gives the groups over
several axes (the data axes ``("dp", "fsdp")``, the whole mesh), which
:func:`build_mesh` creates on every rank in one order, as
``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware numbers for MFU accounting (the JAX package's
    fields; ``ici_gbps`` is the chip-to-chip link rate, NVLink on the
    card)."""
    name: str
    bf16_flops: float          # peak dense bf16 FLOP/s per chip
    hbm_bytes: int
    hbm_gbps: float            # HBM bandwidth GB/s
    ici_gbps: float            # chip-to-chip link bandwidth GB/s


# NVIDIA's H100 SXM data sheet (dense, no sparsity; NVLink 4 total).
CHIP_SPECS: Dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", 989e12, 80 << 30, 3350.0, 900.0),
    "cpu": ChipSpec("cpu", 1e11, 8 << 30, 50.0, 10.0),
}


def chip_spec(kind: Optional[str] = None) -> ChipSpec:
    """The named chip's spec, or the current platform's: the H100 row
    when the CUDA device is an H100, ``cpu`` without a CUDA device; any
    other card raises (the port states no number it has not sourced)."""
    if kind is not None:
        return CHIP_SPECS[kind]
    import torch
    if not torch.cuda.is_available():
        return CHIP_SPECS["cpu"]
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        return CHIP_SPECS["h100"]
    raise KeyError(f"no chip spec for {name!r}; have {sorted(CHIP_SPECS)}")


@dataclasses.dataclass
class MeshSpec:
    """Named-axis mesh shape; -1 on at most one axis means "infer".

    Example: ``MeshSpec(fsdp=-1, tp=2)`` over 8 ranks -> (fsdp=4, tp=2).
    """
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.axis_sizes()
        infer = [a for a, s in sizes.items() if s == -1]
        if len(infer) > 1:
            raise ValueError("at most one axis may be -1")
        known = math.prod(s for s in sizes.values() if s != -1)
        if infer:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}")
            sizes[infer[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {known} devices, have {n_devices}")
        return MeshSpec(**sizes)

    @property
    def nontrivial_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if getattr(self, a) > 1)


def _require_device_mesh(mesh):
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"expected a torch DeviceMesh from ray_tpu_torch.parallel."
            f"build_mesh, got {type(mesh).__module__}.{type(mesh).__name__}"
            f" (a JAX Mesh cannot drive the port)")
    return mesh


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh from :func:`build_mesh`."""
    mesh = _require_device_mesh(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coordinate(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """``{axis: index}`` of ``rank`` (default: this process's rank)."""
    import torch
    import torch.distributed as dist
    mesh = _require_device_mesh(mesh)
    rank = dist.get_rank() if rank is None else int(rank)
    where = (mesh.mesh == rank).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names,
                    (int(i) for i in where[0].to(torch.int64))))


class AxisGroup:
    """The ranks that share every coordinate but those of ``axes``: a
    process group (``pg``, None when it holds this rank alone), its
    ``size`` and this rank's index in it (``rank``, the axes' coordinates
    raveled in ``AXIS_ORDER``, as JAX ravels a tuple of mesh axes)."""

    def __init__(self, axes: Tuple[str, ...], pg, size: int, rank: int):
        self.axes, self.pg, self.size, self.rank = axes, pg, size, rank

    def __repr__(self):
        return f"AxisGroup({self.axes}, size={self.size}, rank={self.rank})"


def _canonical(mesh, axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    unknown = [a for a in axes if a not in sizes]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; have {AXIS_ORDER}")
    return tuple(a for a in AXIS_ORDER if a in axes and sizes[a] > 1)


def axis_group(mesh, axes) -> AxisGroup:
    """The group over mesh axis ``axes`` (a name or a tuple of names; axes
    of size 1 drop out) that holds this rank."""
    import torch.distributed as dist
    key = _canonical(mesh, axes)
    sizes, coord = axis_sizes(mesh), mesh_coordinate(mesh)
    size = math.prod(sizes[a] for a in key)
    rank = 0
    for a in key:
        rank = rank * sizes[a] + coord[a]
    if size == 1:
        return AxisGroup(key, None, 1, 0)
    if len(key) == 1:
        pg = mesh.get_group(key[0])
    elif key == _canonical(mesh, AXIS_ORDER) \
            and mesh.mesh.numel() == dist.get_world_size():
        pg = dist.group.WORLD
    else:
        pg = mesh._ray_tpu_groups[key]
    if dist.get_rank(pg) != rank:
        raise ValueError(
            f"the group over {key} orders its ranks otherwise than the mesh "
            f"(rank {dist.get_rank(pg)}, coordinate {rank}): pass build_mesh "
            f"its ranks in increasing order")
    return AxisGroup(key, pg, size, rank)


def _multi_axis_groups(mesh) -> Dict[Tuple[str, ...], object]:
    """Every group over two or more nontrivial axes (but all of them when
    the mesh spans the world, whose group is the default one), made on
    every rank in one order; this rank's group of each."""
    import torch
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    live = _canonical(mesh, AXIS_ORDER)
    top = len(live) + (mesh.mesh.numel() != dist.get_world_size())
    mine = {}
    for k in range(2, top):
        for key in itertools.combinations(live, k):
            dims = [names.index(a) for a in key]
            rest = [d for d in range(len(names)) if d not in dims]
            arr = mesh.mesh.permute(*rest, *dims).reshape(
                -1, math.prod(mesh.mesh.shape[d] for d in dims))
            for row in arr.to(torch.int64).tolist():
                pg = dist.new_group(ranks=row)
                if dist.get_rank() in row:
                    mine[key] = pg
    return mine


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None,
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` over ``devices`` (global ranks of the default
    process group; default: all of them), its dims named ``AXIS_ORDER``
    with ``pp`` outermost and ``tp`` innermost. ``device_type`` is
    ``"cuda"`` unless the caller names another (``"cpu"`` for gloo ranks
    on the CPU); without a CUDA device and none named, raise. Every rank
    of the default group calls this with the same arguments."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs torch.distributed: call ray_tpu_torch.parallel"
            ".collective.init_torch_distributed (or init_process_group) "
            "on every rank first")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: build_mesh places the mesh on the card by "
                "default; pass device_type='cpu' for gloo ranks on the CPU")
        device_type = "cuda"
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    spec = spec.resolve(len(ranks))
    sizes = spec.axis_sizes()
    arr = torch.tensor(ranks, dtype=torch.int64).reshape(
        *[sizes[a] for a in AXIS_ORDER])
    mesh = DeviceMesh(device_type, arr, mesh_dim_names=AXIS_ORDER)
    mesh._ray_tpu_groups = _multi_axis_groups(mesh)
    return mesh


def local_mesh(spec: Optional[MeshSpec] = None,
               device_type: Optional[str] = None):
    """Mesh over every rank of the default group (one rank per process;
    the port has no notion of a host's local devices beyond its ranks)."""
    import torch.distributed as dist
    if spec is None:
        spec = MeshSpec(tp=dist.get_world_size())
    return build_mesh(spec, device_type=device_type)


def mesh_shape_for_slice(pod_type: str, spec: MeshSpec) -> MeshSpec:
    """Resolve a MeshSpec against a named slice type whose last field is
    its chip count, e.g. ``h100-4``."""
    n = int(pod_type.rsplit("-", 1)[1])
    return spec.resolve(n)
