"""The port's meshes and sharding rules against the JAX package's, on the
CPU.

- ``MeshSpec.resolve``, the rule tables' specs, ``logical_axes``, the
  flat update helpers and the unannotated-params heuristic equal JAX's.
- Rank ``i``'s slice of every leaf (``local_slices``) is the data of the
  addressable shard JAX's ``NamedSharding`` places on device ``i``, for
  ``FSDP_RULES`` and ``DDP_RULES`` on (fsdp 2, tp 2) and (dp 2, fsdp 2,
  tp 2), at ``gptj-tiny`` and ``llama2-tiny``.
- On four gloo ranks (actors of the port's runtime on the CPU):
  ``build_mesh`` places rank ``i`` at JAX device ``i``'s coordinates,
  ``shard_params`` hands it that device's shards, ``axis_group`` gives
  each axis's group, ``constrain`` checks and moves nothing.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import get_config
from ray_tpu_torch.models.transformer import logical_axes
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
# functions run on the ranks travel by value (workers cannot import tests)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

MESHES = {"fsdp2_tp2": dict(fsdp=2, tp=2),
          "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2)}
RULES = {"fsdp": (jsh.FSDP_RULES, tsh.FSDP_RULES),
         "ddp": (jsh.DDP_RULES, tsh.DDP_RULES)}


@pytest.mark.parametrize("kw,n", [(dict(fsdp=-1, tp=2), 8),
                                  (dict(dp=2, fsdp=2, tp=2), 8),
                                  (dict(tp=-1), 4), (dict(), 1),
                                  (dict(pp=2, sp=-1), 8)])
def test_meshspec_resolve_matches_jax(kw, n):
    j = jmesh.MeshSpec(**kw).resolve(n)
    t = tmesh.MeshSpec(**kw).resolve(n)
    assert t.axis_sizes() == j.axis_sizes()
    assert t.nontrivial_axes == j.nontrivial_axes
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("kw,n", [(dict(fsdp=-1, tp=-1), 8),
                                  (dict(fsdp=3), 8), (dict(fsdp=2, tp=-1), 7)])
def test_meshspec_resolve_errors_match_jax(kw, n):
    with pytest.raises(ValueError):
        jmesh.MeshSpec(**kw).resolve(n)
    with pytest.raises(ValueError):
        tmesh.MeshSpec(**kw).resolve(n)
    assert tmesh.mesh_shape_for_slice("h100-8", tmesh.MeshSpec(fsdp=-1)) \
        == tmesh.MeshSpec(fsdp=8)


def test_chip_specs_keep_the_card_and_the_cpu():
    assert set(tmesh.CHIP_SPECS) == {"h100", "cpu"}
    h = tmesh.chip_spec("h100")
    assert (h.bf16_flops, h.hbm_bytes, h.hbm_gbps) == (989e12, 80 << 30,
                                                       3350.0)
    assert tmesh.CHIP_SPECS["cpu"] == tmesh.ChipSpec(
        *jmesh.CHIP_SPECS["cpu"].__dict__.values())
    if not torch.cuda.is_available():
        assert tmesh.chip_spec() == tmesh.CHIP_SPECS["cpu"]


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny", "gptj-6b",
                                  "llama2-7b"])
def test_logical_axes_and_specs_match_jax(name):
    jaxes = jtf.logical_axes(jax_get_config(name))
    taxes = logical_axes(get_config(name))
    assert taxes == jaxes
    for jr, tr in RULES.values():
        flat_j = jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(
            x, tuple))
        for axes in flat_j:
            assert tr.spec_for(axes) == tuple(jr.spec_for(axes))
            assert tsh.logical_to_mesh_axes(axes, tr) == tuple(
                jsh.logical_to_mesh_axes(axes, jr))
    assert tsh.batch_sharding(None, tsh.FSDP_RULES, ("batch", "sequence")) \
        == (("dp", "fsdp"), "sp")
    assert tsh.replicated(None) == tuple(P())


def test_moe_logical_axes_raise():
    """MoE configs have their logical axes now, JAX's (the experts split
    over ep by both rule tables); what still raises for them is the paged
    serving path, as the JAX package's does."""
    from ray_tpu_torch.models import init_kv_cache, init_params, prefill
    cfg = get_config("moe-tiny")
    jaxes = jtf.logical_axes(jax_get_config("moe-tiny"))
    assert logical_axes(cfg) == jaxes
    for jr, tr in RULES.values():
        for axes in jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(
                x, tuple)):
            assert tr.spec_for(axes) == tuple(jr.spec_for(axes))
    assert tsh.FSDP_RULES.spec_for(jaxes["layers"]["moe_wi"]) == \
        (None, "ep", "fsdp", "tp")
    cache = init_kv_cache(cfg, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        prefill(cfg, init_params(cfg, 0, "cpu"), torch.ones((1, 4),
                dtype=torch.int32), cache, torch.tensor([[1]]),
                torch.tensor([0]), torch.tensor([4]))


@pytest.mark.parametrize("n,shards,block", [(1, 1, 256), (1000, 8, 16),
                                            (35, 4, 16), (4096, 2, 256),
                                            (17, 3, 4)])
def test_flat_helpers_match_jax(n, shards, block):
    assert tsh.flat_pad_len(n, shards, block) == \
        jsh.flat_pad_len(n, shards, block)
    x = np.arange(n, dtype=np.float32).reshape(-1, 1) * 0.5
    jf = np.asarray(jsh.flatten_leaf(jnp.asarray(x), shards, block))
    tf = tsh.flatten_leaf(torch.tensor(x), shards, block)
    np.testing.assert_array_equal(tf.numpy(), jf)
    tree = {"a": torch.tensor(x), "b": {"c": torch.ones(3, 2)}}
    back = tsh.unflatten_like(tree, tsh.flatten_tree(tree, shards, block))
    assert torch.equal(back["a"], tree["a"]) and \
        torch.equal(back["b"]["c"], tree["b"]["c"])


def test_infer_param_logical_axes_matches_jax():
    shapes = {"big": (64, 2048), "tall": (4096, 32), "small": (8, 8),
              "vec": (1 << 17,)}
    jt = {k: jnp.zeros(s) for k, s in shapes.items()}
    tt = {k: torch.zeros(s) for k, s in shapes.items()}
    assert tsh.infer_param_logical_axes(tt) == \
        jsh.infer_param_logical_axes(jt)


def test_a_jax_mesh_is_refused():
    mesh = jmesh.build_mesh(jmesh.MeshSpec(tp=1), jax.devices()[:1])
    with pytest.raises(TypeError, match="JAX Mesh"):
        tmesh.axis_sizes(mesh)


def _rank_coord(i, spec_kw):
    sizes = tmesh.MeshSpec(**spec_kw).axis_sizes()
    return sizes, dict(zip(tmesh.AXIS_ORDER, (int(c) for c in np.unravel_index(
        i, [sizes[a] for a in tmesh.AXIS_ORDER]))))


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_rank_slices_are_jax_device_shards(cpu_mesh_devices, rules,
                                           mesh_name, name):
    spec_kw = MESHES[mesh_name]
    n = int(np.prod(list(spec_kw.values())))
    devices = cpu_mesh_devices[:n]
    mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw), devices)
    jr, tr = RULES[rules]
    cfg = jax_get_config(name)
    params = jax.tree.map(np.asarray,
                          jtf.init_params(cfg, jax.random.PRNGKey(0)))
    axes = jtf.logical_axes(cfg)
    leaves = jax.tree.leaves(params)
    leaf_axes = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
    for arr, ax in zip(leaves, leaf_axes):
        placed = jax.device_put(arr, NamedSharding(mesh, jr.spec_for(ax)))
        by_dev = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        for i, d in enumerate(devices):
            sizes, coord = _rank_coord(i, spec_kw)
            mine = arr[tsh.local_slices(arr.shape, tr.spec_for(ax), sizes,
                                        coord)]
            np.testing.assert_array_equal(mine, by_dev[d])
            assert mine.shape == tsh.local_shape(arr.shape,
                                                 tr.spec_for(ax), sizes)


# ------------------------------------------------------ on gloo ranks
@pytest.fixture(scope="module")
def ranks():
    import ray_tpu_torch
    from ray_tpu_torch.parallel.dryrun import start_ranks, stop_ranks
    ray_tpu_torch.init(num_cpus=4, _num_initial_workers=0)
    actors = []
    try:
        actors = start_ranks(4, "gloo", group_name="mesh-tests")
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


def _mesh_on_rank(rank, params_np):
    import torch.distributed as dist

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh, constrain,
                                        shard_params)
    from ray_tpu_torch.parallel.sharding import FSDP_RULES
    from ray_tpu_torch.parallel.mesh import (axis_group, axis_sizes,
                                             mesh_coordinate)
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), device_type="cpu")
    params = {k: ({n: torch.tensor(v) for n, v in t.items()}
                  if isinstance(t, dict) else torch.tensor(t))
              for k, t in params_np.items()}
    shards = shard_params(params, logical_axes(get_config("gptj-tiny")),
                          FSDP_RULES, mesh)
    groups = {a: (g.size, g.rank) for a, g in
              (("fsdp", axis_group(mesh, "fsdp")),
               ("tp", axis_group(mesh, "tp")),
               ("data", axis_group(mesh, ("dp", "fsdp"))),
               ("all", axis_group(mesh, ("fsdp", "tp"))),
               ("dp", axis_group(mesh, "dp")))}
    x = torch.zeros(2, 3, 4)
    same = constrain(x, mesh, FSDP_RULES, ("batch", "sequence", None)) is x
    with pytest.raises(ValueError):
        constrain(x, mesh, FSDP_RULES, ("batch", None))
    return {"rank": dist.get_rank(), "names": list(mesh.mesh_dim_names),
            "sizes": axis_sizes(mesh), "coord": mesh_coordinate(mesh),
            "groups": groups, "constrain_is_identity": same,
            "shards": {k: ({n: t.numpy() for n, t in v.items()}
                           if isinstance(v, dict) else v.numpy())
                       for k, v in shards.items()}}


def test_build_mesh_and_shard_params_on_gloo_ranks(ranks, cpu_mesh_devices):
    cfg = jax_get_config("gptj-tiny")
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    outs = _run(ranks, _mesh_on_rank, params_np)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(fsdp=2, tp=2),
                            cpu_mesh_devices[:4])
    jaxes = jtf.logical_axes(cfg)
    for i, out in enumerate(outs):
        assert out["rank"] == i
        assert out["names"] == list(jmesh.AXIS_ORDER)
        assert out["sizes"] == dict(mesh.shape)
        # JAX device i sits at the same coordinates
        where = np.argwhere(mesh.devices == cpu_mesh_devices[i])[0]
        assert out["coord"] == dict(zip(mesh.axis_names,
                                        (int(c) for c in where)))
        fsdp, tp = out["coord"]["fsdp"], out["coord"]["tp"]
        assert out["groups"] == {"fsdp": (2, fsdp), "tp": (2, tp),
                                 "data": (2, fsdp),
                                 "all": (4, 2 * fsdp + tp), "dp": (1, 0)}
        assert out["constrain_is_identity"]
        for path, arr in jax.tree_util.tree_leaves_with_path(params):
            keys = [p.key for p in path]
            axes, got = jaxes, out["shards"]
            for k in keys:
                axes, got = axes[k], got[k]
            placed = jax.device_put(arr, NamedSharding(
                mesh, jsh.FSDP_RULES.spec_for(axes)))
            want = [np.asarray(s.data) for s in placed.addressable_shards
                    if s.device == cpu_mesh_devices[i]][0]
            np.testing.assert_array_equal(got, want)
