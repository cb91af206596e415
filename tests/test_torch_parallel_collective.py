"""The port's collective layer against the JAX package's, on the CPU.

On four gloo ranks (actors of the port's runtime), each eager op takes
this rank's tensor and gives what the JAX ``"xla"`` stub gives for the
per-rank tensors stacked ``(world, *shape)``: sums, means, maxima and
gathers within 1e-6 (gloo sums in its own order), the int8 quantized
all-reduce and reduce-scatter bit for bit (deterministic rounding; the
port carries real int8 on both legs), and ``psum_tree`` over a mesh axis
as JAX's ``psum_tree`` inside ``shard_map``, int8 included. Stochastic
rounding cannot match JAX's PRNG bits: it is held to unbiasedness and
to JAX's own 0.2 bound. The autograd-aware ops (identity/all-reduce,
all-reduce/identity, all-gather/reduce-scatter in f32 and int8, the
slice gather) are held to their sums.
"""

import copy
import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.parallel import collective as jcol
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu.util.jax_compat import shard_map
from ray_tpu_torch.parallel import collective as col
from ray_tpu_torch.parallel import quantization as qz

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

W = 4
ATOL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    ray_tpu_torch.init(num_cpus=W, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(W, "gloo", group_name="col-tests")
        yield actors
    finally:
        stop_ranks(actors)
        ray_tpu_torch.shutdown()


def _run(ranks, fn, *args):
    """``fn`` on every rank, the results copied out of the store. The
    runtime pickles a function of an importable module by reference, and
    the workers cannot import this test module: the lambda goes through
    cloudpickle, which sends ``fn`` by value (the module is registered)."""
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    return copy.deepcopy(run_on_ranks(
        ranks, lambda rank, *a: fn(rank, *a), *args))


@pytest.fixture(scope="module")
def jax_group(cpu_mesh_devices):
    jcol.init_collective_group(W, 0, "xla", "jx")
    yield "jx"
    jcol.destroy_collective_group("jx")


def _eager_on_rank(rank, stacked, big):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import collective as col
    r = dist.get_rank()
    name = "col-tests"
    x = torch.tensor(stacked[r])
    b = torch.tensor(big[r])
    out = {op: col.allreduce(x, name, op=op).numpy()
           for op in ("sum", "mean", "max", "min")}
    out["allgather"] = col.allgather(x, name).numpy()
    out["reducescatter"] = col.reducescatter(x, name).numpy()
    out["reduce"] = col.reduce(x, 1, name).numpy()
    out["broadcast"] = col.broadcast(x, 2, name).numpy()
    out["q_sum"] = col.quantized_allreduce(b, name, block_size=16).numpy()
    out["q_mean"] = col.quantized_allreduce(b, name, op="mean",
                                            block_size=16).numpy()
    out["q_rs"] = col.quantized_reducescatter(b, name,
                                              block_size=16).numpy()
    out["q_sr"] = col.quantized_allreduce(b, name, block_size=32,
                                          stochastic_rounding=True).numpy()
    col.barrier(name)
    # a ring of sends: rank r sends its tensor to r + 1
    world = dist.get_world_size()
    if r % 2 == 0:
        col.send(x, (r + 1) % world, name)
        got = col.recv(x.shape, x.dtype, (r - 1) % world, name)
    else:
        got = col.recv(x.shape, x.dtype, (r - 1) % world, name)
        col.send(x, (r + 1) % world, name)
    out["recv"] = got.numpy()
    for bad in (lambda: col.quantized_allreduce(b, name, op="max"),
                lambda: col.reducescatter(torch.ones(3), name)):
        try:
            bad()
            out.setdefault("not_raised", []).append(True)
        except ValueError:
            pass
    out["group"] = (col.get_rank(name), col.get_collective_group_size(name),
                    col.is_group_initialized(name))
    return out


def test_eager_ops_match_the_xla_stubs(ranks, jax_group):
    rng = np.random.RandomState(4)
    stacked = rng.randn(W, 8, 3).astype(np.float32)
    big = rng.randn(W, 1004).astype(np.float32)
    outs = _run(ranks, _eager_on_rank, stacked, big)
    js = jnp.asarray(stacked)
    jb = jnp.asarray(big)
    want = {op: np.asarray(jcol.allreduce(js, jax_group, op=op))
            for op in ("sum", "mean", "max", "min")}
    jag = np.asarray(jcol.allgather(js, jax_group))
    jrs = np.asarray(jcol.reducescatter(js, jax_group))
    jq = np.asarray(jcol.quantized_allreduce(jb, jax_group, block_size=16))
    jqm = np.asarray(jcol.quantized_allreduce(jb, jax_group, op="mean",
                                              block_size=16))
    exact = np.asarray(jcol.allreduce(jb, jax_group))
    for r, out in enumerate(outs):
        for op in ("sum", "mean", "max", "min"):
            np.testing.assert_allclose(out[op], want[op], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(out["allgather"], jag)
        np.testing.assert_allclose(out["reducescatter"], jrs[r], atol=ATOL)
        np.testing.assert_allclose(out["reduce"], want["sum"] if r == 1
                                   else stacked[r], atol=ATOL)
        np.testing.assert_array_equal(out["broadcast"], stacked[2])
        # int8 on both legs, deterministic rounding: JAX's numbers exactly
        np.testing.assert_array_equal(out["q_sum"], jq)
        np.testing.assert_array_equal(out["q_mean"], jqm)
        np.testing.assert_array_equal(
            out["q_rs"], np.split(jq, W, axis=0)[r])
        # JAX's bound for stochastic rounding against the exact sum
        np.testing.assert_allclose(out["q_sr"], exact, atol=0.2)
        np.testing.assert_array_equal(out["recv"], stacked[(r - 1) % W])
        assert "not_raised" not in out
        assert out["group"] == (r, W, True)


def _psum_tree_on_rank(rank, tree_np, block, stochastic):
    import torch.distributed as dist

    from ray_tpu_torch.parallel.collective import psum_tree
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    r = dist.get_rank()
    tree = {k: torch.tensor(v[r]) for k, v in tree_np.items()}
    out = {}
    for transport in ("fp32", "int8"):
        red = psum_tree(tree, "fsdp", 2, transport=transport,
                        block_size=block, stochastic_rounding=stochastic,
                        seed=3, mesh=mesh)
        out[transport] = {k: v.numpy() for k, v in red.items()}
        mean = psum_tree(tree, ("fsdp",), transport=transport,
                         block_size=block, mean=True, mesh=mesh)
        out[transport + "_mean"] = {k: v.numpy() for k, v in mean.items()}
    return out


def _jax_psum_tree(devices, tree_np, block, transport, mean=False):
    mesh = jbuild_mesh(JMeshSpec(fsdp=2, tp=2), devices[:W])
    spec = P(("fsdp", "tp"))

    def body(tree):
        local = {k: v[0] for k, v in tree.items()}
        red = jcol.psum_tree(local, "fsdp", 2, transport=transport,
                             block_size=block, mean=mean)
        return {k: v[None] for k, v in red.items()}
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                           out_specs=spec, check_vma=False))
    return {k: np.asarray(v) for k, v in
            fn({k: jnp.asarray(v) for k, v in tree_np.items()}).items()}


def test_psum_tree_over_a_mesh_axis_matches_jax(ranks, cpu_mesh_devices):
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(W, 7, 9).astype(np.float32),
            "b": rng.randn(W, 300).astype(np.float32)}
    outs = _run(ranks, _psum_tree_on_rank, tree, 32, False)
    for transport in ("fp32", "int8"):
        for mean in (False, True):
            want = _jax_psum_tree(cpu_mesh_devices, tree, 32, transport,
                                  mean)
            key = transport + ("_mean" if mean else "")
            for r, out in enumerate(outs):
                for k in tree:
                    if transport == "int8":
                        np.testing.assert_array_equal(out[key][k],
                                                      want[k][r])
                    else:
                        np.testing.assert_allclose(out[key][k], want[k][r],
                                                   rtol=0, atol=ATOL)


def test_stochastic_rounding_is_unbiased():
    """``floor(x / s + u)``: the mean of many stochastic round trips is the
    input (deterministic rounding is not, for values between grid
    points), every draw within one step of it."""
    x = torch.linspace(-1.0, 1.0, 64) * 0.37
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([qz.fake_quant(x, 64, True, gen)
                         for _ in range(4000)])
    step = x.abs().max() / 127
    assert (draws - x).abs().max() <= step * (1 + 1e-6)
    assert (draws.mean(0) - x).abs().max() < 0.05 * step
    det = qz.fake_quant(x, 64)
    assert (det - x).abs().max() <= step / 2 * (1 + 1e-6)
    with pytest.raises(ValueError, match="generator"):
        qz.quantize_int8(x, 64, stochastic_rounding=True)


def test_jitted_scales_match_jax_under_jit():
    x = np.random.RandomState(2).randn(1000).astype(np.float32) * 2
    jq = jax.jit(lambda v: __import__(
        "ray_tpu.parallel.quantization", fromlist=["q"]).quantize_int8(
        v, 16))(jnp.asarray(x))
    q, s = qz.quantize_int8(torch.tensor(x), 16, jitted_scales=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq[0]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq[1]))
    assert qz.compression_ratio(1000, 16) == pytest.approx(
        4000 / (63 * 16 + 4 * 63))
    assert qz.tree_wire_bytes([(10, 10), 5], 16) == \
        qz.wire_bytes(100, 16) + qz.wire_bytes(5, 16)


def _autograd_on_rank(rank):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import collective as col
    from ray_tpu_torch.parallel.mesh import MeshSpec, axis_group, build_mesh
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    tp = axis_group(mesh, "tp")
    r = dist.get_rank()
    out = {}
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = col.copy_to_region(x, tp)
    (y * (r + 1)).sum().backward()
    out["copy"] = (y.detach().numpy(), x.grad.numpy())
    x = (torch.arange(6.0).reshape(2, 3) * (r + 1)).requires_grad_()
    y = col.reduce_from_region(x, tp)
    (y * 2).sum().backward()
    out["reduce"] = (y.detach().numpy(), x.grad.numpy())
    for kind in ("fp32", "int8"):
        x = (torch.arange(12.0).reshape(3, 4) + 100 * r).requires_grad_()
        t = col.GradTransport(kind, block_size=4)
        y = col.gather_shards(x, 1, tp, transport=t)
        (y * (torch.arange(8.0) + 10 * r)).sum().backward()
        out["gather_" + kind] = (y.detach().numpy(), x.grad.numpy())
    x = (torch.arange(4.0) + 10 * r).requires_grad_()
    y = col.gather_slices(x, 0, tp)
    (y * torch.arange(8.0)).sum().backward()
    out["slices"] = (y.detach().numpy(), x.grad.numpy())
    return out


def test_autograd_ops_forward_and_backward(ranks, cpu_mesh_devices):
    outs = _run(ranks, _autograd_on_rank)
    jcol.init_collective_group(2, 0, "xla", "jx2")
    base = np.arange(6.0).reshape(2, 3)
    for r, out in enumerate(outs):
        pair = (r // 2) * 2 + np.arange(2)          # the tp group of r
        y, g = out["copy"]
        np.testing.assert_array_equal(y, base)
        np.testing.assert_array_equal(g, np.full((2, 3), float(
            sum(p + 1 for p in pair))))
        y, g = out["reduce"]
        np.testing.assert_array_equal(y, base * sum(p + 1 for p in pair))
        np.testing.assert_array_equal(g, np.full((2, 3), 2.0))
        tp = r % 2
        xs = [np.arange(12.0).reshape(3, 4) + 100 * p for p in pair]
        ups = [np.broadcast_to(np.arange(8.0) + 10 * p, (3, 8)) for p in pair]
        full_grad = sum(ups)[:, 4 * tp:4 * tp + 4]
        y, g = out["gather_fp32"]
        np.testing.assert_array_equal(y, np.concatenate(xs, 1))
        np.testing.assert_array_equal(g, full_grad)
        y, g = out["gather_int8"]
        # the reduce-scatter is this rank's chunk of JAX's quantized sum of
        # the pair's gradients, laid out with the gathered dim first
        jq = np.asarray(jcol.quantized_allreduce(
            jnp.asarray(np.stack([u.T for u in ups])), "jx2", block_size=4))
        np.testing.assert_array_equal(g, jq[4 * tp:4 * tp + 4].T)
        y, g = out["slices"]
        np.testing.assert_array_equal(
            y, np.concatenate([np.arange(4.0) + 10 * p for p in pair]))
        np.testing.assert_array_equal(g, np.arange(8.0)[4 * tp:4 * tp + 4])
    jcol.destroy_collective_group("jx2")


def test_backends_are_named_never_picked():
    with pytest.raises(ValueError, match="xla"):
        col.init_collective_group(1, 0, "xla", "bad")
    with pytest.raises(TypeError):
        col.init_collective_group(1, 0)
    with pytest.raises(ValueError, match="backend"):
        col.init_torch_distributed("bad", backend=None, num_processes=1,
                                   process_id=0)
    assert not col._via_host("all_reduce", torch.zeros(1), None)
    with pytest.raises(ValueError, match="not initialized"):
        col.get_group("never-made")
