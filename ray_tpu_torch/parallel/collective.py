"""Collective communication API: the port of
``ray_tpu/parallel/collective.py`` on ``torch.distributed``.

Backends (the caller names one; the layer never picks one by itself):

- ``"nccl"`` and ``"gloo"``: the torch counterparts of the JAX package's
  in-graph ``"xla"`` backend, over a ``torch.distributed`` process group.
  :func:`init_torch_distributed` (the counterpart of
  ``init_jax_distributed``) makes the default group: rank 0 publishes a
  ``TCPStore`` address in the runtime's KV and every rank calls
  ``init_process_group`` against it. gloo reduces CUDA tensors only for
  some ops; for the others this layer copies the tensor through a host
  buffer itself (:func:`_via_host`) and writes the result back on the
  caller's device, and an op gloo cannot run raises.
- ``"host"``: control-plane collectives of host values between actors
  through the runtime's KV store, ported whole.

Eager calls take **this rank's tensor**, as ``ray.util.collective`` does:
``allreduce`` returns the reduction, ``allgather`` the ranks' tensors
stacked ``(world, *shape)``, ``reducescatter`` this rank's dim-0 chunk
of the reduction. The JAX ``"xla"`` stubs take the per-rank tensors
stacked ``(world, *shape)`` instead, an artefact of one controller
driving every device; the host backend is the same on both.

:func:`quantized_psum` is the JAX package's two-leg int8 all-reduce
(EQuARX, arXiv:2506.17615) with real int8 on both legs: each rank
quantizes its payload blockwise, an all-to-all moves int8 values and f32
scales so that each rank accumulates one chunk in f32 (in rank order),
the reduced chunk is requantized, and an all-gather moves int8 again.
With deterministic rounding it gives the JAX function's numbers.

Autograd-aware ops for the model (:func:`copy_to_region`,
:func:`reduce_from_region`, :func:`gather_shards`,
:func:`gather_slices`, and :func:`ppermute`, the ring attention's
neighbour exchange) take an :class:`~ray_tpu_torch.parallel.mesh.
AxisGroup`; a group of one rank makes each of them the identity.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.parallel import quantization as qz
from ray_tpu_torch.parallel.mesh import AxisGroup, axis_group

_groups: Dict[str, "Group"] = {}
_lock = threading.Lock()
BACKENDS = ("nccl", "gloo", "host")

# gloo ops that take a CUDA tensor themselves (torch 2.11 on the H100:
# each gave the right values, fp32, bf16 and int8, and P1's step ran 1.9x
# faster than through host copies); every other op on a CUDA tensor goes
# through a host copy in _via_host. gloo's send and recv abort the whole
# process on a CUDA tensor ("writev ... Bad address"), so they stay out.
_GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                            "all_to_all", "broadcast"})

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
# the names torch 2.13 gives the tensor forms (older releases: *_tensor)
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Group:
    def __init__(self, name: str, world_size: int, rank: int, backend: str,
                 axis: Optional[AxisGroup] = None):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        #: the torch process group of an nccl/gloo group
        self.axis = axis
        # Sequence numbers are tracked per op kind (and per peer pair for
        # p2p) so an asymmetric op, a send between two ranks, say, can't
        # desynchronize the keys the whole group uses for its next barrier.
        self._seqs: Dict[str, int] = {}
        # Host-backend KV hygiene: keys this rank wrote, per op kind, as
        # {kind: [(seq, key), ...]}; consumed lazily by _gc (see below).
        self._written: Dict[str, List[Tuple[int, bytes]]] = {}
        self._bcast_pending: List[Tuple[bytes, List[bytes]]] = []

    def next_seq(self, kind: str) -> int:
        self._seqs[kind] = self._seqs.get(kind, 0) + 1
        return self._seqs[kind]


def axis_world_size(mesh, axes) -> int:
    """Total rank count across the named mesh axes."""
    return axis_group(mesh, axes).size


# ------------------------------------------------ torch.distributed calls
# Every call into torch.distributed goes through one of these wrappers,
# so a caller can time or count the collectives by wrapping them.

def _via_host(op: str, t: torch.Tensor, pg) -> bool:
    """Whether ``op`` on ``t`` must cross a host buffer: a CUDA tensor on a
    gloo group, for an op gloo does not run on CUDA tensors itself."""
    return (t.is_cuda and "nccl" not in str(dist.get_backend(pg))
            and op not in _GLOO_CUDA_OPS)


def _run(op: str, fn, out: torch.Tensor, *inputs: torch.Tensor, pg) -> None:
    """``fn(out, *inputs)`` on ``pg``, through host copies of the tensors
    where :func:`_via_host` says so; ``out`` holds the result on its own
    device afterwards."""
    if not _via_host(op, out, pg):
        fn(out, *inputs)
        return
    host_out = out.to("cpu")
    fn(host_out, *(t.to("cpu") for t in inputs))
    out.copy_(host_out)


def _all_reduce(t: torch.Tensor, group: AxisGroup, op: str = "sum"
                ) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor over ``group``."""
    if group.size == 1:
        return t
    _run("all_reduce", lambda o: dist.all_reduce(
        o, _REDUCE_OPS[op], group=group.pg), t, pg=group.pg)
    return t


def _all_gather(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``(size, *t.shape)``: every rank's ``t`` in group-rank order."""
    if group.size == 1:
        return t.detach().clone().unsqueeze(0)
    flat = t.contiguous().reshape(-1)
    out = torch.empty(group.size * flat.numel(), dtype=t.dtype,
                      device=t.device)
    _run("all_gather", lambda o, i: _all_gather_into(o, i, group=group.pg),
         out, flat, pg=group.pg)
    return out.view((group.size,) + tuple(t.shape))


def _reduce_scatter(t: torch.Tensor, group: AxisGroup,
                    op: str = "sum") -> torch.Tensor:
    """This rank's dim-0 chunk of the reduction of ``t`` over ``group``."""
    if t.shape[0] % group.size:
        raise ValueError(f"reducescatter dim 0 ({t.shape[0]}) not "
                         f"divisible by world size {group.size}")
    if group.size == 1:
        return t.clone()
    t = t.contiguous()
    out = torch.empty((t.shape[0] // group.size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _run("reduce_scatter", lambda o, i: _reduce_scatter_into(
        o, i, _REDUCE_OPS[op], group=group.pg), out, t, pg=group.pg)
    return out


def _all_to_all(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Dim-0 chunk ``j`` of ``t`` goes to rank ``j``; chunk ``j`` of the
    result came from rank ``j``."""
    t = t.contiguous()
    if group.size == 1:
        return t.clone()
    out = torch.empty_like(t)
    _run("all_to_all", lambda o, i: dist.all_to_all_single(
        o, i, group=group.pg), out, t, pg=group.pg)
    return out


def _broadcast(t: torch.Tensor, src: int, group: AxisGroup) -> torch.Tensor:
    """In-place broadcast from group rank ``src``."""
    if group.size == 1:
        return t
    src_global = dist.get_global_rank(group.pg, src)
    _run("broadcast", lambda o: dist.broadcast(o, src_global,
                                                group=group.pg),
         t, pg=group.pg)
    return t


def _ppermute(t: torch.Tensor, group: AxisGroup,
              perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """This rank's result of ``jax.lax.ppermute``: ``t`` goes to the group
    rank that a ``(src, dst)`` pair of ``perm`` names for this rank, and
    what the pair naming this rank as ``dst`` sends arrives (zeros where
    none does). The send and the receive are posted together
    (``batch_isend_irecv``), so neither waits for the other; on a gloo
    group a CUDA tensor crosses a host buffer (:func:`_via_host`)."""
    dst = [d for s, d in perm if s == group.rank]
    src = [s for s, d in perm if d == group.rank]
    if dst == [group.rank]:
        return t.clone()
    t = t.contiguous()
    out = torch.empty_like(t) if src else torch.zeros_like(t)
    if not dst and not src:
        return out

    def exchange(o, i):
        ops = [dist.P2POp(dist.isend, i, dist.get_global_rank(
                   group.pg, dst[0]), group.pg)] if dst else []
        if src:
            ops.append(dist.P2POp(dist.irecv, o, dist.get_global_rank(
                group.pg, src[0]), group.pg))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _run("ppermute", exchange, out, t, pg=group.pg)
    return out


# ------------------------------------------------ int8 quantized reduction
def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    # by a tensor: CUDA's division by a Python scalar multiplies by its
    # rounded reciprocal, 1 ulp off the quotient JAX computes
    return x / torch.full_like(x, float(n))


def quantized_psum(x: torch.Tensor, axes, world: Optional[int] = None,
                   block_size: Optional[int] = None,
                   stochastic_rounding: bool = False,
                   generator: Optional[torch.Generator] = None,
                   mean: bool = False, mesh=None) -> torch.Tensor:
    """Two-leg int8-quantized all-reduce of this rank's ``x`` over
    ``axes`` (mesh axis names resolved on ``mesh``, or an
    :class:`AxisGroup`): the JAX function's arithmetic with real int8 on
    both legs. The payload is padded to ``world`` chunks of whole quant
    blocks (no block straddles two ranks' chunks) and quantized
    blockwise (stochastically from ``generator`` if asked); an all-to-all
    carries int8 values and f32 scales, each rank sums the ``world``
    dequantized copies of its chunk in f32 in rank order, requantizes
    the sum, and an all-gather carries the int8 chunks and scales back.
    Returns the reduced tensor in ``x``'s shape (f32), divided by
    ``world`` when ``mean``."""
    group = axes if isinstance(axes, AxisGroup) else axis_group(mesh, axes)
    if world is not None and world != group.size:
        raise ValueError(f"world {world} != the group's {group.size} ranks")
    world = group.size
    block = int(block_size or qz.DEFAULT_BLOCK_SIZE)
    n = x.numel()
    chunk = qz._padded_len(-(-n // world), block)
    padded = F.pad(x.to(torch.float32).reshape(-1), (0, chunk * world - n))
    # the scales of the JAX function under jit (quantize_int8's
    # jitted_scales), so deterministic rounding gives its numbers exactly
    q, s = qz.quantize_int8(padded, block, stochastic_rounding, generator,
                            jitted_scales=True)
    parts = qz.dequantize_int8(_all_to_all(q, group),
                               _all_to_all(s, group)).view(world, chunk)
    mine = parts[0]
    for j in range(1, world):                      # f32 accumulation leg
        mine = mine + parts[j]
    q2, s2 = qz.quantize_int8(mine, block, jitted_scales=True)  # gather
    qg = _all_gather(q2, group)
    sg = _all_gather(s2, group)
    full = (qg.to(torch.float32) * sg[..., None]).reshape(-1)
    if mean:
        full = _divide(full, world)
    return full[:n].reshape(x.shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def rank_generator(device, *seed_parts: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed_parts`` (a base seed,
    a step, a leaf, a rank, ...), so that no two of them share a rounding
    stream, as the JAX package folds each into its key."""
    seed = 0x5EED
    for p in seed_parts:
        seed = (seed * 1_000_003 + int(p)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def psum_tree(tree, axes, world: Optional[int] = None,
              transport: str = "fp32", block_size: Optional[int] = None,
              stochastic_rounding: bool = False, seed: int = 0,
              mean: bool = False, mesh=None):
    """Reduce every leaf of a nested dict (or one tensor) over ``axes``:
    ``transport="fp32"`` is a plain all-reduce (exact); ``"int8"`` routes
    each leaf through :func:`quantized_psum`. With
    ``stochastic_rounding`` each leaf draws from its own generator (the
    seed, its index and this rank's), as the JAX package folds the leaf
    index into its key. Returns new tensors."""
    group = axes if isinstance(axes, AxisGroup) else axis_group(mesh, axes)
    if world is not None and world != group.size:
        raise ValueError(f"world {world} != the group's {group.size} ranks")
    if transport not in ("fp32", "int8"):
        raise ValueError(f"transport must be fp32 or int8, got {transport!r}")
    out = []
    for i, g in enumerate(_leaves(tree)):
        if transport == "fp32":
            r = _all_reduce(g.detach().clone().contiguous(), group)
            out.append(_divide(r, group.size) if mean else r)
        else:
            gen = rank_generator(g.device, seed, i, dist.get_rank()) \
                if stochastic_rounding else None
            out.append(quantized_psum(
                g, group, block_size=block_size,
                stochastic_rounding=stochastic_rounding, generator=gen,
                mean=mean))
    return _rebuild(tree, iter(out))


# ---------------------------------------------- autograd-aware model ops
@dataclasses.dataclass
class GradTransport:
    """How :func:`gather_shards` reduce-scatters gradients: ``"fp32"``
    or ``"int8"`` (:func:`quantized_psum`, this rank's chunk), the quant
    block, and stochastic rounding from per-call generators seeded from
    ``seed``."""
    kind: str = "fp32"
    block_size: int = qz.DEFAULT_BLOCK_SIZE
    stochastic: bool = False
    seed: int = 0
    calls: int = 0

    def reduce_scatter(self, g: torch.Tensor,
                       group: AxisGroup) -> torch.Tensor:
        if self.kind == "fp32":
            return _reduce_scatter(g, group)
        self.calls += 1
        gen = rank_generator(g.device, self.seed, self.calls,
                             dist.get_rank()) if self.stochastic else None
        full = quantized_psum(g, group, block_size=self.block_size,
                              stochastic_rounding=self.stochastic,
                              generator=gen)
        return full.view(group.size, -1)[group.rank].view(
            (g.shape[0] // group.size,) + tuple(g.shape[1:]))


FP32 = GradTransport()


class _CopyToRegion(torch.autograd.Function):
    """Identity forward, all-reduce backward: the entry of a tensor
    replicated over ``group`` into work split over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce forward, identity backward: the sum of partial results
    (a row-parallel product) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherShards(torch.autograd.Function):
    """All-gather of dim ``dim`` forward (after a cast to ``dtype``),
    reduce-scatter backward in f32 (or int8, per ``transport``): a
    parameter sharded over ``group`` and used by every rank of it on its
    own data."""

    @staticmethod
    def forward(ctx, x, dim, group, dtype, transport):
        ctx.dim, ctx.group, ctx.transport = dim, group, transport
        ctx.in_dtype = x.dtype
        xs = x.to(dtype) if dtype is not None else x
        g = _all_gather(xs.movedim(dim, 0), group)
        return g.reshape((-1,) + tuple(g.shape[2:])).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.to(torch.float32).movedim(ctx.dim, 0).contiguous()
        mine = ctx.transport.reduce_scatter(full, ctx.group)
        return (mine.movedim(0, ctx.dim).to(ctx.in_dtype).contiguous(), None,
                None, None, None)


class _GatherSlices(torch.autograd.Function):
    """All-gather of dim ``dim`` forward, this rank's slice backward: a
    result split over ``group`` and used alike by every rank of it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        g = _all_gather(x.movedim(dim, 0), group)
        return g.reshape((-1,) + tuple(g.shape[2:])).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
                .contiguous(), None, None)


class _PPermute(torch.autograd.Function):
    """:func:`_ppermute` forward, the inverse permutation backward: each
    rank's gradient goes back to the rank its input came from."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group: AxisGroup, perm) -> torch.Tensor:
    """The counterpart of ``jax.lax.ppermute`` over ``group``: ``perm``
    lists ``(src, dst)`` pairs of group ranks (each rank at most once as
    a source and once as a destination); a rank that no pair sends to
    gets zeros. Differentiable: the backward applies the inverse
    permutation, so reverse-mode through a ring runs the reverse ring."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if group.size == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, perm)


def copy_to_region(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    return x if group.size == 1 else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    return x if group.size == 1 else _ReduceFromRegion.apply(x, group)


def gather_shards(x: torch.Tensor, dim: int, group: AxisGroup,
                  dtype: Optional[torch.dtype] = None,
                  transport: GradTransport = FP32) -> torch.Tensor:
    """``x``'s shards over ``group`` joined along ``dim``, cast to
    ``dtype`` first; the backward reduce-scatters the gradient in f32
    (or through ``transport``) and returns it in ``x``'s dtype."""
    if group.size == 1:
        return x.to(dtype) if dtype is not None else x
    return _GatherShards.apply(x, dim, group, dtype, transport)


def gather_slices(x: torch.Tensor, dim: int,
                  group: AxisGroup) -> torch.Tensor:
    return x if group.size == 1 else _GatherSlices.apply(x, dim, group)


# ------------------------------------------------------------------ API
def _check_backend(backend: str) -> None:
    if backend == "xla":
        raise ValueError(
            "backend 'xla' is the JAX package's in-graph backend; the "
            "port's are 'nccl', 'gloo' and 'host'")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def init_collective_group(world_size: int, rank: int, backend: str,
                          group_name: str = "default") -> None:
    """Join a collective group (call from every participating actor).
    An nccl or gloo group is the default ``torch.distributed`` group,
    made by :func:`init_torch_distributed` unless it exists already (of
    this world size); a group of another backend than the default
    group's becomes a new group over the same ranks."""
    _check_backend(backend)
    axis = None
    if backend != "host":
        if not dist.is_initialized():
            init_torch_distributed(group_name, backend=backend,
                                   num_processes=world_size,
                                   process_id=rank)
        if dist.get_world_size() != world_size \
                or dist.get_rank() != rank:
            raise ValueError(
                f"group {group_name!r} (world {world_size}, rank {rank}) "
                f"does not match the default process group (world "
                f"{dist.get_world_size()}, rank {dist.get_rank()})")
        pg = dist.group.WORLD
        if backend not in str(dist.get_backend()):
            pg = dist.new_group(ranks=list(range(world_size)),
                                backend=backend)
        axis = AxisGroup((group_name,), pg, world_size, rank)
    with _lock:
        _groups[group_name] = Group(group_name, world_size, rank, backend,
                                    axis)
    if backend == "host":
        _host_rendezvous(group_name, world_size, rank)


def _actor_join(actor_self, world_size, rank, backend, group_name):
    init_collective_group(world_size, rank, backend, group_name)
    return rank


def create_collective_group(actors: List, world_size: int, ranks: List[int],
                            backend: str,
                            group_name: str = "default") -> None:
    """Declarative creation (reference: ``create_collective_group`` :151):
    tell each actor to join via the generic ``__ray_call__`` invoke."""
    import ray_tpu_torch
    _check_backend(backend)
    ray_tpu_torch.get([
        a.__ray_call__.remote(_actor_join, world_size, r, backend, group_name)
        for a, r in zip(actors, ranks)], timeout=300)


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        _groups.pop(group_name, None)


def get_group(group_name: str = "default") -> Group:
    g = _groups.get(group_name)
    if g is None:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return g


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def _as_tensor(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"the {'nccl/gloo'} backends take a torch tensor, "
                        f"got {type(tensor).__name__}")
    return tensor


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """This rank's ``tensor`` reduced over the group (``op``: sum, mean,
    max, min); a new tensor on ``tensor``'s device."""
    g = get_group(group_name)
    if g.backend == "host":
        return _host_allreduce(g, tensor, op)
    t = _as_tensor(tensor).detach().clone().contiguous()
    if op == "mean":
        return _divide(_all_reduce(t, g.axis), g.world_size)
    return _all_reduce(t, g.axis, op)


def allgather(tensor, group_name: str = "default"):
    """Every rank's ``tensor``, stacked ``(world, *shape)`` (a list on the
    host backend, as in the JAX package)."""
    g = get_group(group_name)
    if g.backend == "host":
        return _host_allgather(g, tensor)
    return _all_gather(_as_tensor(tensor).detach(), g.axis)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """This rank's dim-0 chunk of the reduction of every rank's
    ``tensor``."""
    g = get_group(group_name)
    if g.backend == "host":
        return _host_reducescatter(g, tensor, op)
    t = _as_tensor(tensor).detach()
    if op == "mean":
        return _divide(_reduce_scatter(t, g.axis), g.world_size)
    return _reduce_scatter(t, g.axis, op)


def _check_quant_op(op: str) -> None:
    if op not in ("sum", "mean"):
        raise ValueError(
            f"quantized collectives support op='sum'/'mean', got {op!r} "
            "(max/min don't survive blockwise requantization)")


def _quant_generator(g: Group, kind: str, device, stochastic: bool):
    if not stochastic:
        return None
    return rank_generator(device, g.next_seq(kind), g.rank)


def quantized_allreduce(tensor, group_name: str = "default",
                        op: str = "sum",
                        block_size: Optional[int] = None,
                        stochastic_rounding: bool = False):
    """All-reduce with int8 blockwise-quantized transport
    (:func:`quantized_psum`); the result carries the quantization error
    of both wire legs (half a quantization step per leg per block)."""
    _check_quant_op(op)
    g = get_group(group_name)
    if g.backend == "host":
        return _host_quantized_allreduce(g, tensor, op, block_size)
    t = _as_tensor(tensor).detach()
    return quantized_psum(
        t, g.axis, block_size=block_size,
        stochastic_rounding=stochastic_rounding,
        generator=_quant_generator(g, "q_ar", t.device,
                                   stochastic_rounding),
        mean=op == "mean")


def quantized_reducescatter(tensor, group_name: str = "default",
                            op: str = "sum",
                            block_size: Optional[int] = None,
                            stochastic_rounding: bool = False):
    """Reduce-scatter with int8-quantized transport: this rank's dim-0
    chunk of :func:`quantized_allreduce`, as the JAX stub computes it."""
    _check_quant_op(op)
    g = get_group(group_name)
    if g.backend == "host":
        summed = _host_quantized_allreduce(g, tensor, op, block_size)
        if tensor.shape[0] % g.world_size:
            raise ValueError(
                f"reducescatter dim 0 ({tensor.shape[0]}) not divisible "
                f"by world size {g.world_size}")
        return np.split(summed, g.world_size, axis=0)[g.rank]
    t = _as_tensor(tensor).detach()
    if t.shape[0] % g.world_size:
        raise ValueError(
            f"reducescatter dim 0 ({t.shape[0]}) not divisible by world "
            f"size {g.world_size}")
    full = quantized_psum(
        t, g.axis, block_size=block_size,
        stochastic_rounding=stochastic_rounding,
        generator=_quant_generator(g, "q_rs", t.device,
                                   stochastic_rounding),
        mean=op == "mean")
    return torch.chunk(full, g.world_size, dim=0)[g.rank].clone()


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum"):
    out = allreduce(tensor, group_name, op)
    g = get_group(group_name)
    return out if g.rank == dst_rank else tensor


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """``src_rank``'s ``tensor`` on every rank (a new tensor)."""
    g = get_group(group_name)
    if g.backend == "host":
        return _host_broadcast(g, tensor, src_rank)
    t = _as_tensor(tensor).detach().clone().contiguous()
    return _broadcast(t, src_rank, g.axis)


def barrier(group_name: str = "default") -> None:
    g = get_group(group_name)
    if g.backend == "host":
        _host_barrier(g)
        return
    dev = "cuda" if "nccl" in str(dist.get_backend(g.axis.pg)) else "cpu"
    _all_reduce(torch.zeros(1, device=dev), g.axis)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    g = get_group(group_name)
    if g.backend != "host":
        t = _as_tensor(tensor).detach().contiguous()
        dst = dist.get_global_rank(g.axis.pg, dst_rank)
        _run("send", lambda o: dist.send(o, dst, group=g.axis.pg), t,
             pg=g.axis.pg)
        return
    seq = g.next_seq(f"p2p/{g.rank}->{dst_rank}")
    _kv_put(_key(g, f"p2p/{g.rank}->{dst_rank}/{seq}"),
            _dumps(_to_numpy(tensor)))


def recv(shape, dtype, src_rank: int, group_name: str = "default",
         device=None):
    """A tensor of ``shape`` and ``dtype`` from ``src_rank``: on
    ``device`` (default: the CPU) for the nccl/gloo backends; numpy on
    the host backend, as in the JAX package."""
    g = get_group(group_name)
    if g.backend != "host":
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        src = dist.get_global_rank(g.axis.pg, src_rank)
        _run("recv", lambda o: dist.recv(o, src, group=g.axis.pg), out,
             pg=g.axis.pg)
        return out
    seq = g.next_seq(f"p2p/{src_rank}->{g.rank}")
    key = _key(g, f"p2p/{src_rank}->{g.rank}/{seq}")
    return _loads(_kv_take(key)).reshape(shape).astype(dtype)


# ------------------------------------------------ host backend internals
def _kv(self=None):
    from ray_tpu_torch.core.global_state import global_worker
    return global_worker()


def _key(g: Group, suffix: str) -> bytes:
    return f"collective/{g.name}/{suffix}".encode()


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").numpy()
    return np.asarray(value)


def _like(result: np.ndarray, like):
    """The host backend's result in the caller's kind: numpy for numpy,
    a tensor on the caller's device for a tensor."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(result)).to(like.device)
    return result


def _dumps(arr: np.ndarray) -> bytes:
    import io
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _loads(blob: bytes) -> np.ndarray:
    import io
    return np.load(io.BytesIO(blob), allow_pickle=False)


def _kv_put(key: bytes, value: bytes) -> None:
    _kv().kv_put(key, value, ns="collective")


def _kv_take(key: bytes, timeout: float = 120.0) -> bytes:
    w = _kv()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = w.kv_get(key, ns="collective")
        if v is not None:
            w.kv_del(key, ns="collective")
            return v
        time.sleep(0.005)
    raise TimeoutError(f"collective recv timed out on {key!r}")


def _kv_wait(key: bytes, timeout: float = 120.0) -> bytes:
    w = _kv()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = w.kv_get(key, ns="collective")
        if v is not None:
            return v
        time.sleep(0.005)
    raise TimeoutError(f"collective wait timed out on {key!r}")


def _host_rendezvous(group_name: str, world_size: int, rank: int) -> None:
    # Join keys persist for the group's lifetime (one tiny key per rank):
    # stragglers that rendezvous late must still find every key.
    g = get_group(group_name)
    _kv_put(_key(g, f"join/{rank}"), b"1")
    for r in range(world_size):
        _kv_wait(_key(g, f"join/{r}"))


def _gc_symmetric(g: Group, kind: str, seq: int, key: bytes) -> None:
    """Lag-2 GC for symmetric ops (every rank writes and reads each seq).

    When this rank starts seq s, every rank has started s-1 (this rank
    finished s-1 only after reading all ranks' s-1 keys, which they write
    on entry), hence every rank has finished s-2 and read our s-2 key,
    so our keys with seq <= s-2 are dead and safe to delete.
    """
    written = g._written.setdefault(kind, [])
    w = _kv()
    while written and written[0][0] <= seq - 2:
        _, old_key = written.pop(0)
        w.kv_del(old_key, ns="collective")
    written.append((seq, key))


_HOST_REDUCE = {"sum": lambda s: s.sum(0), "mean": lambda s: s.mean(0),
                "max": lambda s: s.max(0), "min": lambda s: s.min(0)}


def _host_allreduce(g: Group, tensor, op: str):
    arr = _to_numpy(tensor)
    seq = g.next_seq("ar")
    key = _key(g, f"ar/{seq}/{g.rank}")
    _gc_symmetric(g, "ar", seq, key)
    _kv_put(key, _dumps(arr))
    parts = [_loads(_kv_wait(_key(g, f"ar/{seq}/{r}")))
             for r in range(g.world_size)]
    return _like(_HOST_REDUCE[op](np.stack(parts)), tensor)


def _host_allgather(g: Group, tensor):
    arr = _to_numpy(tensor)
    seq = g.next_seq("ag")
    key = _key(g, f"ag/{seq}/{g.rank}")
    _gc_symmetric(g, "ag", seq, key)
    _kv_put(key, _dumps(arr))
    return [_like(_loads(_kv_wait(_key(g, f"ag/{seq}/{r}"))), tensor)
            for r in range(g.world_size)]


def _host_reducescatter(g: Group, tensor, op: str):
    """Host-backend reduce-scatter: every rank contributes its local
    tensor and takes home the ``rank``-th dim-0 chunk of the elementwise
    reduction. Symmetric (every rank writes and reads each seq), so the
    lag-2 GC argument holds exactly as for allreduce/allgather."""
    arr = _to_numpy(tensor)
    if arr.shape[0] % g.world_size:
        raise ValueError(
            f"reducescatter dim 0 ({arr.shape[0]}) not divisible by "
            f"world size {g.world_size}")
    seq = g.next_seq("rs")
    key = _key(g, f"rs/{seq}/{g.rank}")
    _gc_symmetric(g, "rs", seq, key)
    _kv_put(key, _dumps(arr))
    parts = [_loads(_kv_wait(_key(g, f"rs/{seq}/{r}")))
             for r in range(g.world_size)]
    out = _HOST_REDUCE[op](np.stack(parts))
    return _like(np.split(out, g.world_size, axis=0)[g.rank], tensor)


def _host_quantized_allreduce(g: Group, tensor, op: str,
                              block_size: Optional[int]):
    """Host-backend quantized all-reduce: each rank publishes int8 block
    values + f32 scales (the KV wire bytes shrink ~4x against the f32
    payload of ``_host_allreduce``); readers dequantize into f32
    accumulators. Single-leg: there is no separate gather hop to
    requantize on the KV-store topology."""
    block = int(block_size or qz.DEFAULT_BLOCK_SIZE)
    arr = _to_numpy(tensor)
    q, s = qz.quantize_int8_np(arr, block)
    seq = g.next_seq("qar")
    qkey = _key(g, f"qar/{seq}/q/{g.rank}")
    skey = _key(g, f"qar/{seq}/s/{g.rank}")
    _gc_symmetric(g, "qar.q", seq, qkey)
    _gc_symmetric(g, "qar.s", seq, skey)
    _kv_put(qkey, _dumps(q))
    _kv_put(skey, _dumps(s))
    out = np.zeros(arr.shape, np.float32)
    for r in range(g.world_size):
        rq = _loads(_kv_wait(_key(g, f"qar/{seq}/q/{r}")))
        rs = _loads(_kv_wait(_key(g, f"qar/{seq}/s/{r}")))
        out += qz.dequantize_int8_np(rq, rs, arr.shape)
    return _like(out / g.world_size if op == "mean" else out, tensor)


def _host_broadcast(g: Group, tensor, src_rank: int):
    # Broadcast is asymmetric (receivers never write), so lag-GC's
    # self-synchronization argument doesn't hold; receivers ack instead
    # and the source reaps fully-acked payloads on its next broadcast.
    seq = g.next_seq("bc")
    data_key = _key(g, f"bc/{seq}")
    if g.rank == src_rank:
        w = _kv()
        still_pending = []
        for old_data, acks in g._bcast_pending:
            if all(w.kv_get(a, ns="collective") is not None for a in acks):
                w.kv_del(old_data, ns="collective")
                for a in acks:
                    w.kv_del(a, ns="collective")
            else:
                still_pending.append((old_data, acks))
        g._bcast_pending = still_pending
        _kv_put(data_key, _dumps(_to_numpy(tensor)))
        g._bcast_pending.append(
            (data_key, [_key(g, f"bc/{seq}/ack/{r}")
                        for r in range(g.world_size) if r != src_rank]))
        return tensor
    out = _loads(_kv_wait(data_key))
    _kv_put(_key(g, f"bc/{seq}/ack/{g.rank}"), b"1")
    return _like(out, tensor)


def _host_barrier(g: Group) -> None:
    seq = g.next_seq("bar")
    key = _key(g, f"bar/{seq}/{g.rank}")
    _gc_symmetric(g, "bar", seq, key)
    _kv_put(key, b"1")
    for r in range(g.world_size):
        _kv_wait(_key(g, f"bar/{seq}/{r}"))


# ----------------------------------------- torch.distributed rendezvous
RENDEZVOUS_TIMEOUT_S = 300.0


def init_torch_distributed(group_name: str = "train", backend: str = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           address: str = "127.0.0.1") -> None:
    """Multi-process bring-up, the counterpart of the JAX package's
    ``init_jax_distributed`` (and of the reference's TCPStore rendezvous,
    ``train/torch/config.py:64-116``): rank 0 opens a ``TCPStore`` on a
    free port of ``address`` and publishes ``host:port`` in the runtime's
    KV; every rank calls ``torch.distributed.init_process_group(backend,
    store=...)`` against it. ``backend`` (``"nccl"`` or ``"gloo"``),
    ``num_processes`` and ``process_id`` are required. Rank 0 deletes the
    key once every rank has joined, so the name can be used again."""
    from datetime import timedelta
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_torch_distributed needs backend 'nccl' or "
                         f"'gloo', got {backend!r}")
    if process_id is None or num_processes is None:
        raise ValueError(
            "init_torch_distributed requires explicit num_processes and "
            "process_id (rank 0 hosts the store)")
    w = _kv()
    key = f"torchdist/{group_name}/store".encode()
    timeout = timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    if process_id == 0:
        store = dist.TCPStore(address, 0, num_processes, True,
                              timeout=timeout, wait_for_workers=False)
        w.kv_put(key, f"{address}:{store.port}".encode(), ns="collective")
    else:
        host, port = _kv_wait(key, RENDEZVOUS_TIMEOUT_S).decode().rsplit(
            ":", 1)
        store = dist.TCPStore(host, int(port), num_processes, False,
                              timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _all_reduce(torch.zeros(1, device="cuda" if backend == "nccl"
                            else "cpu"),
                AxisGroup(("world",), dist.group.WORLD, num_processes,
                          process_id))
    if process_id == 0:
        w.kv_del(key, ns="collective")
