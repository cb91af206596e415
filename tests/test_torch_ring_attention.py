"""The port's ring attention and ``ppermute`` against the JAX package's,
on four gloo ranks on the CPU.

Each rank holds its contiguous chunk of the sequence (rank ``i`` at
positions ``[i*sl, (i+1)*sl)``), as JAX's ``shard_map`` over an ``sp``
axis of four CPU devices places them, with inputs drawn by numpy from a
seed:

- ``ring_attention``'s output and the gradients of ``sum(out * w)``
  with respect to q, k and v (the K/V gradients travel back around the
  ring) against JAX's ring at 1e-5 in f32, causal and not;
- the same against plain attention (``attention_reference``) at JAX's
  own bars (``tests/ops/test_attention.py``: 2e-5 forward, 1e-4
  gradients);
- ``ppermute`` over a permutation that leaves one rank without a
  source: its values, zeros where nothing arrives, and its backward the
  inverse permutation, as ``jax.lax.ppermute``'s transpose.

The JAX bodies ``test_ring_attention_matches_reference`` and
``test_ring_attention_grads`` run JAX's ring through ``shard_map`` on
JAX arrays, so the loader cannot run them on the port; the first two
cases here are their twins on the port's ranks.
"""

import copy
import functools
import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.ops import attention_reference as jax_attention_reference
from ray_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from ray_tpu.util.jax_compat import shard_map

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

W = 4
TOL = dict(rtol=1e-5, atol=1e-5)
# JAX's bars for its ring against plain attention
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (2, 32, 2, 8)          # batch, global seq, heads, head_dim


@pytest.fixture(scope="module")
def ranks():
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    ray_tpu_torch.init(num_cpus=W, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(W, "gloo", group_name="ring-tests")
        yield actors
    finally:
        stop_ranks(actors)
        ray_tpu_torch.shutdown()


def _run(ranks, fn, *args):
    from ray_tpu_torch.parallel.dryrun import run_on_ranks
    return copy.deepcopy(run_on_ranks(
        ranks, lambda rank, *a: fn(rank, *a), *args))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _sp_group():
    from ray_tpu_torch.parallel.mesh import MeshSpec, axis_group, build_mesh
    return axis_group(build_mesh(MeshSpec(sp=W), device_type="cpu"), "sp")


def _ring_on_rank(rank, q, k, v, w, causal):
    """This rank's chunk of the output and of the gradients of
    ``sum(out * w)``."""
    from ray_tpu_torch.ops import ring_attention
    group = _sp_group()
    sl = q.shape[1] // W
    mine = slice(group.rank * sl, (group.rank + 1) * sl)
    qt, kt, vt = (torch.tensor(x[:, mine]).requires_grad_()
                  for x in (q, k, v))
    out = ring_attention(qt, kt, vt, group, causal=causal)
    grads = torch.autograd.grad((out * torch.tensor(w[:, mine])).sum(),
                                (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _joined(outs):
    """The ranks' chunks joined along the sequence."""
    out = np.concatenate([o for o, _ in outs], 1)
    grads = [np.concatenate([g[i] for _, g in outs], 1) for i in range(3)]
    return out, grads


def _jax_ring(devices, causal):
    mesh = Mesh(np.asarray(devices[:W]).reshape(W), ("sp",))
    return shard_map(
        functools.partial(jax_ring_attention, axis_name="sp",
                          causal=causal),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring(ranks, cpu_mesh_devices, causal):
    q, k, v, w = _inputs(3)
    ring = _jax_ring(cpu_mesh_devices, causal)
    jout, jvjp = jax.vjp(ring, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = jvjp(jnp.asarray(w))
    out, grads = _joined(_run(ranks, _ring_on_rank, q, k, v, w, causal))
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)


def test_ring_matches_plain_attention_at_jax_bars(ranks):
    q, k, v, w = _inputs(4)
    ref, vjp = jax.vjp(lambda *a: jax_attention_reference(*a, causal=True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(w))
    out, grads = _joined(_run(ranks, _ring_on_rank, q, k, v, w, True))
    np.testing.assert_allclose(out, np.asarray(ref), **FWD_TOL)
    for g, rg in zip(grads, ref_grads):
        np.testing.assert_allclose(g, np.asarray(rg), **GRAD_TOL)


PERM = ((0, 2), (1, 0), (2, 3))      # rank 1 receives nothing


def _ppermute_on_rank(rank, x, w):
    from ray_tpu_torch.parallel.collective import ppermute
    group = _sp_group()
    xt = torch.tensor(x[group.rank]).requires_grad_()
    out = ppermute(xt, group, PERM)
    (g,) = torch.autograd.grad((out * torch.tensor(w[group.rank])).sum(),
                               (xt,))
    return out.detach().numpy(), g.numpy()


def test_ppermute_and_its_backward_match_jax(ranks, cpu_mesh_devices):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((W, 3, 5)).astype(np.float32)
    w = rng.standard_normal((W, 3, 5)).astype(np.float32)
    mesh = Mesh(np.asarray(cpu_mesh_devices[:W]).reshape(W), ("sp",))
    perm = shard_map(lambda t: jax.lax.ppermute(t, "sp", PERM), mesh=mesh,
                     in_specs=P("sp"), out_specs=P("sp"))
    jout, vjp = jax.vjp(perm, jnp.asarray(x.reshape(W * 3, 5)))
    (jgrad,) = vjp(jnp.asarray(w.reshape(W * 3, 5)))
    outs = _run(ranks, _ppermute_on_rank, x, w)
    got = np.stack([o for o, _ in outs])
    np.testing.assert_array_equal(got.reshape(W * 3, 5), np.asarray(jout))
    np.testing.assert_array_equal(got[1], 0.0)
    grads = np.stack([g for _, g in outs])
    np.testing.assert_array_equal(grads.reshape(W * 3, 5),
                                  np.asarray(jgrad))
    for src, dst in PERM:        # the inverse permutation
        np.testing.assert_array_equal(grads[src], w[dst])
    np.testing.assert_array_equal(grads[3], 0.0)
