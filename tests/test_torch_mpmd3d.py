"""The port's stage mesh (the ``mpmd3d`` lowering of
``ray_tpu_torch.parallel.mpmd_pipeline``: a dp x fsdp mesh of rank actors
inside each pipeline stage) against the JAX package's nested stages
(``shard_map`` over a stage's devices), on the CPU in f32.

One pool of four rank actors serves the file: ranks 0-1 form stage 0's
collective group and ranks 2-3 stage 1's (gloo), and each case builds its
``PipelineStage`` objects in them (the stage of rank ``2 s + r`` is stage
``s``'s rank ``r``), with JAX's init weights. The driver walks the chunks
serially (``forward_one``/``backward_one`` on every rank of a stage, rank
``r``'s rows of each microbatch, ``P(("dp", "fsdp"))``), sums one squared
norm a stage and runs every rank's optimizer step, as
``tests/parallel/test_parallel_plan.py::_inprocess_train_step`` drives
JAX's nested stages (JAX's side: ``_make_stages(dp=2)`` on the forced
host devices). A random loss mask gives the two ranks of a microbatch
unequal token counts, so the seed ``n_i / N * n_loc / n_mb`` matters.

- dp=2 and fsdp=2 (the stage mesh splits the microbatch over (dp, fsdp)
  alike, so both compute JAX's dp=2 stages): the first step's reduced
  stage gradients at 1e-5, a 5-step trajectory at JAX's bars (loss
  1e-5, grad norm 1e-4), params bit-identical across a stage's ranks;
- int8: the stage reduction bit-exact against JAX's
  ``psum_tree(transport="int8")`` on the same per-rank gradients, the
  3-step trajectory within JAX's ``0 < |int8 - fp32| < 5e-2``, the wire
  bytes under a third of f32's;
- ``shard_weight_update``: losses equal the plain stages' within 1e-5,
  checkpoints param-shaped and equal to the plain stages' (JAX's bar,
  2e-5), Adam bytes a rank about 1/N; the uneven dp=2 -> dp=1 re-slice
  exact, the shrunk stages continuing the trajectory;
- the canonical checkpoint saved under (S=2, v=2, dp=2) equals
  ``train_state_from_jax`` of JAX's merged state, reloads into the
  one-device step and back, and the next losses agree;
- the seed control (each rank seeded with n_i / N, without its share
  n_loc / n_mb) falls outside;
- last (it kills a rank of the pool): a rank killed while its peer waits
  for it in their stage's loss all-reduce fails the peer's call with a
  typed error at the driver within seconds, and leaves no thread of the
  peer inside a collective.
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

from ray_tpu.models import transformer as jt
from ray_tpu.parallel import collective as jcol
from ray_tpu.parallel import mpmd_pipeline as jmp
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu.util.jax_compat import shard_map
from ray_tpu_torch._bridge import train_state_from_jax
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mpmd_pipeline as tmp
from ray_tpu_torch.parallel.quantization import DEFAULT_BLOCK_SIZE
from ray_tpu_torch.parallel.sharding import flat_pad_len

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2, head_dim=16,
            d_ff=64, max_seq_len=32, rotary_dim=8, block_style="gptj",
            remat=False, ce_chunk_size=8)
JCFG = jt.TransformerConfig(**TINY, dtype=jnp.float32)
TCFG = tt.TransformerConfig(**TINY, dtype=torch.float32)
S, M, N = 2, 2, 2
BLOCK = 32       # a small quant block: several blocks a leaf, no padding


def _batch(rows=8, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (rows, seq)).astype(np.int32),
            "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}


BATCH = _batch()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    for path, v in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for p in path:
            t = t[p.key]
        np.testing.assert_allclose(np.asarray(t), v, **(tol or TOL),
                                   err_msg=str(path))


def _rows(x, r):
    n = x.shape[0] // N
    return x[r * n:(r + 1) * n]


# ------------------------------------------------------------ JAX's side
def _jax_stages(v, **kw):
    """tests/parallel/test_parallel_plan.py::_make_stages(dp=2)."""
    return [jmp.PipelineStage(JCFG, s, S, seed=0, n_virtual=v, train=True,
                              learning_rate=1e-3, clip_norm=1.0, dp=2,
                              device_indices=[0, 1], **kw)
            for s in range(S)]


def _jax_step(stages, v, grads_out=None):
    """``_inprocess_train_step`` of the JAX test; with ``grads_out`` the
    stages' reduced gradients before the update are kept there."""
    K = S * v
    ids_mb = np.split(BATCH["input_ids"], M)
    mask_mb = np.split(BATCH["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    total = sum(ns)
    losses = []
    for i in range(M):
        x = ids_mb[i]
        for ch in range(K):
            st = stages[ch % S]
            out = st.forward_one(ch, i, x, ids_mb[i], mask_mb[i]) \
                if ch == K - 1 else st.forward_one(ch, i, x)
            if ch < K - 1:
                x = np.asarray(out)
        losses.append((out["loss"], out["n_tokens"]))
        g = np.float32(ns[i] / total)
        for ch in range(K - 1, -1, -1):
            g = stages[ch % S].backward_one(ch, i, g)
            if g is not None:
                g = np.asarray(g)
    if grads_out is not None:
        for st in stages:
            grads_out.update(_np(st.get_grads()))
    gsq = sum(st.grad_sq_norm() for st in stages)
    mets = [st.apply_opt(gsq) for st in stages]
    return sum(l * n for l, n in losses) / total, mets[0]["grad_norm"]


@pytest.fixture(scope="module")
def jax_dp2():
    """JAX's nested dp=2 stages (v=1) from its init: the first step's
    reduced gradients by chunk, and 5 steps' losses and grad norms."""
    stages = _jax_stages(1)
    grads = {}
    traj = [_jax_step(stages, 1, grads)]
    traj += [_jax_step(stages, 1) for _ in range(4)]
    return {"grads": grads, "traj": traj}


# ----------------------------------------------------------- the port's
@pytest.fixture(scope="module")
def pool():
    """Four rank actors: (stage 0, ranks 0-1) and (stage 1, ranks 0-1),
    each pair in a gloo group of its own."""
    import ray_tpu_torch
    from ray_tpu_torch.parallel.collective import create_collective_group
    from ray_tpu_torch.parallel.dryrun import Rank
    ray_tpu_torch.init(num_cpus=S * N, _num_initial_workers=0)
    actors = []
    try:
        cls = ray_tpu_torch.remote(num_cpus=1)(Rank)
        actors = [cls.remote() for _ in range(S * N)]
        for s in range(S):
            create_collective_group(actors[s * N:(s + 1) * N], N,
                                    list(range(N)), "gloo", f"mesh{s}")
        yield [actors[s * N:(s + 1) * N] for s in range(S)]
    finally:
        for a in actors:
            ray_tpu_torch.kill(a)
        ray_tpu_torch.shutdown()


def _on(actor, fn, *args):
    return actor.__ray_call__.remote(lambda rank, *a: fn(rank, *a), *args)


def _get(refs):
    import ray_tpu_torch
    return copy.deepcopy(ray_tpu_torch.get(refs, timeout=300))


def _build(rank, s, r, v, kw, part):
    rank.state["st"] = st = tmp.PipelineStage(
        TCFG, s, S, seed=0, device="cpu", n_virtual=v, train=True,
        learning_rate=1e-3, rank=r, group_name=f"mesh{s}", **kw)
    st.load_state(part)


def _call(rank, name, *args):
    return getattr(rank.state["st"], name)(*args)


def _local_grads(rank):
    from ray_tpu_torch._bridge import to_numpy
    st = rank.state["st"]
    return {c: to_numpy(tt_map(lambda p: p.grad, st.params[c]))
            for c in st.chunks}


def _params(rank):
    from ray_tpu_torch._bridge import to_numpy
    return to_numpy(rank.state["st"].params)


def tt_map(fn, tree):
    from ray_tpu_torch.models.training import tree_map
    return tree_map(fn, tree)


class Mesh3D:
    """The port's stages of one case on the pool, from ``state``."""

    def __init__(self, pool, v, kw, state):
        self.pool, self.v = pool, v
        parts = tmp.split_train_state(TCFG, state, S, v)
        _get([_on(a, _build, s, r, v, kw, parts[s])
              for s, row in enumerate(pool) for r, a in enumerate(row)])

    def each(self, name, *args):
        """``name(*args)`` on every rank, results by (stage, rank)."""
        out = _get([_on(a, _call, name, *args)
                    for row in self.pool for a in row])
        return [out[s * N:(s + 1) * N] for s in range(S)]

    def fwd_bwd(self, seeds=None):
        """The serial chunk walk; ``seeds(i, r)`` overrides rank ``r``'s
        backward seed of microbatch ``i`` (the driver's n_i / N)."""
        K = S * self.v
        ids_mb = np.split(BATCH["input_ids"], M)
        mask_mb = np.split(BATCH["loss_mask"], M)
        ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
        total = sum(ns)
        self.each("reset_step")
        losses = []
        for i in range(M):
            ids = [_rows(ids_mb[i], r) for r in range(N)]
            masks = [_rows(mask_mb[i], r) for r in range(N)]
            acts = _get([_on(a, _call, "forward_one", 0, i, ids[r])
                         for r, a in enumerate(self.pool[0])])
            for ch in range(1, K):
                row = self.pool[ch % S]
                acts = _get([_on(a, _call, "forward_one", ch, i, acts[r],
                                 ids[r], masks[r]) if ch == K - 1 else
                             _on(a, _call, "forward_one", ch, i, acts[r])
                             for r, a in enumerate(row)])
            assert acts[0] == acts[1]          # the stage's loss
            losses.append((acts[0]["loss"], acts[0]["n_tokens"]))
            gs = [np.float32(ns[i] / total) if seeds is None
                  else seeds(i, r) for r in range(N)]
            for ch in range(K - 1, -1, -1):
                gs = _get([_on(a, _call, "backward_one", ch, i, gs[r])
                           for r, a in enumerate(self.pool[ch % S])])
        return sum(l * n for l, n in losses) / total

    def step(self):
        loss = self.fwd_bwd()
        sq = self.each("grad_sq_norm")
        for row in sq:
            assert row[0] == row[1]            # reduced: one value a stage
        mets = self.each("apply_opt", sum(row[0] for row in sq))
        return loss, mets[0][0]["grad_norm"]

    def grads(self):
        """The stages' reduced gradients by chunk (rank 0's)."""
        out = {}
        for row in self.each("get_grads"):
            assert row[1] == {}
            out.update(row[0])
        return out

    def checkpoint(self):
        parts = self.each("stage_checkpoint")
        assert all(row[1] is None for row in parts)
        return tmp.merge_stage_checkpoints(TCFG, [row[0] for row in parts])

    def same_params_on_each_stage(self):
        for row in self.pool:
            a, b = _get([_on(x, _params) for x in row])
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                assert np.array_equal(x, y)


def _jax_init():
    return {"params": _np(jt.init_params(JCFG, jax.random.PRNGKey(0)))}


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_stage_mesh_gradients_and_five_steps_equal_jax(pool, jax_dp2, axis):
    m = Mesh3D(pool, 1, {axis: 2}, _jax_init())
    loss = m.fwd_bwd()
    assert loss == pytest.approx(jax_dp2["traj"][0][0], rel=1e-5)
    _close(m.grads(), jax_dp2["grads"])
    m.each("reset_step")
    for k, (jloss, jnorm) in enumerate(jax_dp2["traj"]):
        loss, gn = m.step()
        assert abs(loss - jloss) <= 1e-5, k
        assert abs(gn - jnorm) <= 1e-4, k
    m.same_params_on_each_stage()


def _jax_int8_psum(per_rank):
    """JAX's ``psum_tree(transport="int8")`` over a dp=2 mesh of the
    forced host devices, of the ranks' trees ``per_rank``."""
    mesh = jbuild_mesh(JMeshSpec(dp=2), jax.devices()[:2])
    spec = P(("dp", "fsdp"))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per_rank)

    def body(tree):
        local = jax.tree.map(lambda a: a[0], tree)
        return jcol.psum_tree(local, ("dp", "fsdp"), 2, transport="int8",
                              block_size=BLOCK)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                           out_specs=P(), check_vma=False))
    return _np(fn(stacked))


def test_int8_stage_reduction_is_bit_exact_with_jax(pool):
    m = Mesh3D(pool, 1, {"dp": 2, "grad_transport": "int8",
                         "quant_block_size": BLOCK}, _jax_init())
    m.fwd_bwd()
    for row in pool:
        local = _get([_on(a, _local_grads) for a in row])
        want = _jax_int8_psum(local)
        got = _get([_on(a, _call, "get_grads") for a in row])[0]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(x, y)


def test_int8_trajectory_tracks_fp32_and_its_wire_is_int8(pool, jax_dp2):
    m = Mesh3D(pool, 1, {"dp": 2, "grad_transport": "int8",
                         "quant_block_size": BLOCK}, _jax_init())
    diffs = [abs(m.step()[0] - jax_dp2["traj"][k][0]) for k in range(3)]
    assert 0.0 < max(diffs) < 5e-2
    m.same_params_on_each_stage()
    stats = m.each("step_stats")
    for s, row in enumerate(stats):
        sizes = [np.asarray(x).size for x in
                 jax.tree.leaves(_get([_on(pool[s][0], _params)])[0])]
        fp32 = 4 * sum(sizes)
        for st in row:
            assert 0 < st["reduce_bytes"] < fp32 / 3, (st, fp32)


def test_sharded_update_keeps_the_math_and_param_shaped_checkpoints(pool):
    plain = Mesh3D(pool, 1, {"dp": 2}, _jax_init())
    want = [plain.step()[0] for _ in range(2)]
    ck_plain = plain.checkpoint()
    adam_plain = plain.each("adam_bytes")
    flat = Mesh3D(pool, 1, {"dp": 2, "shard_weight_update": True,
                            "quant_block_size": BLOCK}, _jax_init())
    for k in range(2):
        assert abs(flat.step()[0] - want[k]) <= 1e-5, k
    flat.same_params_on_each_stage()
    ck = flat.checkpoint()
    assert jax.tree.structure(ck) == jax.tree.structure(ck_plain)
    for x, y in zip(jax.tree.leaves(ck), jax.tree.leaves(ck_plain)):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_allclose(x, y, rtol=0, atol=2e-5)
    for s, row in enumerate(flat.each("adam_bytes")):
        sizes = [np.asarray(x).size for x in
                 jax.tree.leaves(_get([_on(pool[s][0], _params)])[0])]
        for b in row:
            assert b == 8 * sum(flat_pad_len(n, N, BLOCK) // N
                                for n in sizes)
            assert adam_plain[s][0] / 2 <= b <= adam_plain[s][0] * 0.6


def _inprocess_step(stages):
    """A dp=1 pipeline's serial walk in this process."""
    ids_mb = np.split(BATCH["input_ids"], M)
    mask_mb = np.split(BATCH["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    total = sum(ns)
    for st in stages:
        st.reset_step()
    losses = []
    for i in range(M):
        x = ids_mb[i]
        for ch in range(S):
            out = stages[ch].forward_one(ch, i, x, ids_mb[i], mask_mb[i]) \
                if ch == S - 1 else stages[ch].forward_one(ch, i, x)
            if ch < S - 1:
                x = out.numpy().copy()
        losses.append((out["loss"], out["n_tokens"]))
        g = np.float32(ns[i] / total)
        for ch in range(S - 1, -1, -1):
            g = stages[ch].backward_one(ch, i, g)
            if g is not None:
                g = g.numpy().copy()
    gsq = sum(st.grad_sq_norm() for st in stages)
    for st in stages:
        st.apply_opt(gsq)
    return sum(l * n for l, n in losses) / total


def test_dp_shrink_reslices_uneven_flat_opt_shards(pool):
    """tests/parallel/test_parallel_plan.py:293-334 on the port: the flat
    moments' padding is dropped exactly in the canonical checkpoint, the
    dp=1 stages it reloads into save the same state bit for bit, and
    continue the wide stages' trajectory."""
    wide = Mesh3D(pool, 1, {"dp": 2, "shard_weight_update": True},
                  _jax_init())
    sizes = [np.asarray(x).size for x in
             jax.tree.leaves(_get([_on(pool[0][0], _params)])[0])]
    assert any(flat_pad_len(n, N, DEFAULT_BLOCK_SIZE) > n for n in sizes)
    for _ in range(2):
        wide.step()
    ck = wide.checkpoint()
    narrow = [tmp.PipelineStage(TCFG, s, S, seed=3, device="cpu",
                                train=True, learning_rate=1e-3)
              for s in range(S)]
    for st, part in zip(narrow, tmp.split_train_state(TCFG, ck, S)):
        st.load_state(part)
    ck1 = tmp.merge_stage_checkpoints(
        TCFG, [st.stage_checkpoint() for st in narrow])
    assert ck1["step"] == ck["step"] == 2
    assert jax.tree.structure(ck1) == jax.tree.structure(ck)
    for a, b in zip(jax.tree.leaves(ck1), jax.tree.leaves(ck)):
        np.testing.assert_array_equal(a, b)
    for _ in range(2):
        assert abs(wide.step()[0] - _inprocess_step(narrow)) <= 1e-5


def test_checkpoint_saved_at_v2_dp2_equals_jax_and_reloads_across_lowerings(
        pool):
    from ray_tpu_torch.parallel.plan import ParallelPlan
    jstages = _jax_stages(2)
    m = Mesh3D(pool, 2, {"dp": 2}, _jax_init())
    for _ in range(3):
        m.step()
        _jax_step(jstages, 2)
    jmerged = jmp.merge_stage_checkpoints(
        JCFG, [_np(st.stage_checkpoint()) for st in jstages])
    want = train_state_from_jax(jmerged, TCFG, "cpu")
    ck = m.checkpoint()
    assert ck["step"] == 3 and ck["opt_state"]["count"] == 3
    for key in ("mu", "nu"):
        _close(ck["opt_state"][key],
               jax.tree.map(lambda t: t.numpy(), want["opt_state"][key]))
    _close(ck["params"], jax.tree.map(lambda t: t.numpy(), want["params"]))
    # into the one-device step (S=1), and its state back into the stages
    one = ParallelPlan().build(TCFG, learning_rate=1e-3, seed=5,
                               device="cpu")
    one.load_checkpoint(ck)
    src = m.step()[0]
    assert one.step(BATCH).loss == pytest.approx(src, rel=1e-5)
    back = Mesh3D(pool, 2, {"dp": 2}, one.save_checkpoint())
    assert back.step()[0] == pytest.approx(one.step(BATCH).loss, rel=1e-5)


def test_seed_control_without_the_token_share_falls_outside(pool, jax_dp2):
    """Seeding each rank with the microbatch's n_i / N, without its share
    n_loc / n_mb of the microbatch's tokens, sums about twice the
    gradient over the two ranks: the loss is unchanged, the gradients
    are not."""
    m = Mesh3D(pool, 1, {"dp": 2}, _jax_init())
    mask_mb = np.split(BATCH["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    total = sum(ns)

    def seeds(i, r):
        n_loc = float(_rows(mask_mb[i], r)[:, 1:].sum())
        return np.float32(ns[i] / total * ns[i] / n_loc)
    loss = m.fwd_bwd(seeds)
    assert loss == pytest.approx(jax_dp2["traj"][0][0], rel=1e-5)
    got, want = m.grads(), jax_dp2["grads"]
    num = sum(float(((np.asarray(a) - b) ** 2).sum()) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(want)))
    den = sum(float((b ** 2).sum()) for b in jax.tree.leaves(want))
    assert (num / den) ** 0.5 > 0.5


def _in_collective(rank_self):
    """Threads of this process inside a collective call."""
    import traceback
    return [f.name for frames in sys._current_frames().values()
            for f in traceback.extract_stack(frames)
            if f.filename.endswith("parallel/collective.py")]


def test_a_killed_rank_fails_its_peer_typed_and_frees_it(pool):
    import time

    import ray_tpu_torch
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.exceptions import RayTpuError
    Mesh3D(pool, 1, {"dp": 2}, _jax_init())
    ids = [_rows(np.split(BATCH["input_ids"], M)[0], r) for r in range(N)]
    mask = _rows(np.split(BATCH["loss_mask"], M)[0], 0)
    acts = _get([_on(a, _call, "forward_one", 0, 0, ids[r])
                 for r, a in enumerate(pool[0])])
    peer, victim = pool[1]
    waiting = _on(peer, _call, "forward_one", 1, 0, acts[0], ids[0], mask)
    t0 = time.monotonic()
    ray_tpu_torch.kill(victim)
    with pytest.raises(RayTpuError, match="Connection|closed|reset"):
        ray_tpu_torch.get(waiting, timeout=60)
    assert time.monotonic() - t0 < \
        get_config().pipeline_mailbox_deadline_s / 4
    assert ray_tpu_torch.get(
        peer.__ray_call__.remote(lambda r: _in_collective(r)),
        timeout=30) == []
