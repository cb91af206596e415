"""The port's MPMD pipeline (``ray_tpu_torch.parallel.mpmd_pipeline``) and
stage functions against the JAX package's, on the CPU in f32.

- the schedules (``one_f_one_b_order`` and ``interleaved_orders``) item
  for item, and the analytic bubbles, over S 2-4, M 1-8, v 1-3;
- ``stage_layer_ranges``, ``stage_slice_params`` and
  ``merge_stage_params``; ``stage_forward`` and ``stage_loss`` at
  ``gptj-tiny`` and ``llama2-tiny`` (1e-5);
- in-process stages (S=2, M=2, v=1 and v=2) with JAX's weights: the
  first step's stage gradients against the JAX one-device gradient's
  slices, a 5-step loss trajectory against JAX's ``make_train_step``
  (1e-5); a stage's weights are the one-device init's slices bit for
  bit;
- checkpoints: the merged canonical state after 3 steps at v=2 equals
  ``train_state_from_jax`` of the JAX pipeline's merged state, and
  reloads at v=1 and into the one-device step with the next losses
  equal;
- the typed mailbox timeout, ``abort``, the STAGE_TICK spans; one
  ``MPMDPipeline(train=True)`` step on two CPU stage actors equal to the
  in-process step, with no gradient reaching the driver; the stage-mesh
  options build (``tests/test_torch_mpmd3d.py`` holds them against
  JAX).
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import transformer as jt
from ray_tpu.parallel import mpmd_pipeline as jmp
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu_torch._bridge import params_from_jax, train_state_from_jax
from ray_tpu_torch.models import get_config, init_params, make_train_step
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.parallel import mpmd_pipeline as tmp

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2, head_dim=16,
            d_ff=64, max_seq_len=32, rotary_dim=8, block_style="gptj",
            remat=False, ce_chunk_size=8)
S, M = 2, 2


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jt.TransformerConfig(**kw, dtype=jnp.float32),
            tt.TransformerConfig(**kw, dtype=torch.float32))


def _batch(vocab, rows=4, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    """Every leaf of the numpy tree ``want`` against ``got`` (tensors or
    numpy, any key order)."""
    for path, v in jax.tree_util.tree_leaves_with_path(want):
        t = got
        for p in path:
            t = t[p.key]
        t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
        np.testing.assert_allclose(t, v, **(tol or TOL), err_msg=str(path))


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_schedules_and_bubbles_equal_jax(n_stages):
    for m in range(1, 9):
        for v in (1, 2, 3):
            for s in range(n_stages):
                assert tmp.one_f_one_b_order(s, n_stages, m, v) == \
                    jmp.one_f_one_b_order(s, n_stages, m, v), (s, m, v)
                assert tmp.stage_virtual_chunks(s, n_stages, v) == \
                    jmp.stage_virtual_chunks(s, n_stages, v)
            if v > 1:
                assert tmp.interleaved_orders(n_stages, m, v) == \
                    jmp.interleaved_orders(n_stages, m, v)
            assert tmp.analytic_bubble(n_stages, m, v) == \
                jmp.analytic_bubble(n_stages, m, v)
        assert tmp.analytic_gpipe_bubble(n_stages, m) == \
            jmp.analytic_gpipe_bubble(n_stages, m)


# ------------------------------------------------------ stage functions
def test_stage_split_equals_jax():
    jcfg, tcfg = _cfgs(n_layers=5)
    for n in range(1, 6):
        assert tt.stage_layer_ranges(5, n) == jt.stage_layer_ranges(5, n)
    with pytest.raises(ValueError):
        tt.stage_layer_ranges(5, 6)
    params = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    for K in (2, 3, 5):
        chunks = {c: tt.stage_slice_params(tcfg, params, c, K)
                  for c in range(K)}
        for c in range(K):
            want = _np(jt.stage_slice_params(jcfg, params, c, K))
            assert jax.tree.structure(chunks[c]) == \
                jax.tree.structure(want)
            _close(chunks[c], want, rtol=0, atol=0)
        merged = tt.merge_stage_params(tcfg, chunks)
        _close(merged, params, rtol=0, atol=0)
        # tensors merge as well (the optimizer's moments are tensors)
        tchunks = {c: jax.tree.map(torch.tensor, ch)
                   for c, ch in chunks.items()}
        _close(tt.merge_stage_params(tcfg, tchunks), params, rtol=0, atol=0)
    with pytest.raises(ValueError, match="missing chunks"):
        tt.merge_stage_params(tcfg, {0: chunks[0]})
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.stage_slice_params(get_config("moe-tiny"), {}, 0, 2)


@pytest.mark.parametrize("name", ["gptj-tiny", "llama2-tiny"])
def test_stage_forward_and_loss_equal_jax(name):
    jcfg = dataclasses.replace(jax_get_config(name), n_layers=3)
    tcfg = dataclasses.replace(get_config(name), n_layers=3)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_np(jp), tcfg, "cpu", masters=True)
    b = _batch(jcfg.vocab_size, rows=2, seq=24)
    for ce in (jcfg.ce_chunk_size, 0):
        jc = dataclasses.replace(jcfg, ce_chunk_size=ce)
        tc = dataclasses.replace(tcfg, ce_chunk_size=ce)

        def jax_stages(p, ids, mask, jc=jc):
            hs = [ids]
            for s in range(3):
                hs.append(jt.stage_forward(
                    jc, s, 3, jt.stage_slice_params(jc, p, s, 3), hs[-1]))
            return hs[1:], jt.stage_loss(
                jc, jt.stage_slice_params(jc, p, 2, 3), hs[-1], ids, mask)
        jhs, (jl, jn) = jax.jit(jax_stages)(
            jp, jnp.asarray(b["input_ids"]), jnp.asarray(b["loss_mask"]))
        th = torch.tensor(b["input_ids"])
        for s in range(3):
            th = tt.stage_forward(tc, s, 3, tt.stage_slice_params(
                tc, tp, s, 3), th)
            assert th.dtype == tc.dtype
            np.testing.assert_allclose(th.detach().numpy(),
                                       np.asarray(jhs[s]), **TOL)
        tl, tn = tt.stage_loss(tc, tt.stage_slice_params(tc, tp, 2, 3), th,
                               torch.tensor(b["input_ids"]),
                               torch.tensor(b["loss_mask"]))
        assert float(tn) == float(jn)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)


# ---------------------------------------------------- in-process stages
def _stages(tcfg, v, jparams=None, train=True, **kw):
    stages = [tmp.PipelineStage(tcfg, s, S, seed=0, device="cpu",
                                n_virtual=v, train=train,
                                learning_rate=1e-3, **kw)
              for s in range(S)]
    if jparams is not None:
        parts = tmp.split_train_state(tcfg, {"params": jparams}, S, v)
        for st, p in zip(stages, parts):
            st.load_state(p)
    return stages


def _inprocess_step(stages, batch, v, train=True):
    """The serial chunk walk over in-process stages (activations and
    gradients hop as numpy copies, as through the store), the driver's
    sum of squared norms and every stage's optimizer step. Returns
    (loss, grad_norm)."""
    K = S * v
    ids_mb = np.split(batch["input_ids"], M)
    mask_mb = np.split(batch["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    total = sum(ns)
    for st in stages:
        st.reset_step()
    losses = []
    for i in range(M):
        x = ids_mb[i]
        for ch in range(K):
            st = stages[ch % S]
            out = st.forward_one(ch, i, x, ids_mb[i], mask_mb[i]) \
                if ch == K - 1 else st.forward_one(ch, i, x)
            if ch < K - 1:
                x = out.numpy().copy()
        losses.append((out["loss"], out["n_tokens"]))
        g = np.float32(ns[i] / total)
        for ch in range(K - 1, -1, -1):
            g = stages[ch % S].backward_one(ch, i, g)
            if g is not None:
                g = g.numpy().copy()
    loss = sum(l * n for l, n in losses) / total
    if not train:
        return loss, None
    gsq = sum(st.grad_sq_norm() for st in stages)
    mets = [st.apply_opt(gsq) for st in stages]
    return loss, mets[0]["grad_norm"]


def test_stage_weights_are_the_one_device_slices_bit_for_bit():
    from ray_tpu_torch.models.training import _get, _paths
    _, tcfg = _cfgs()
    full = init_params(tcfg, 0, "cpu")
    for v in (1, 2):
        for st in _stages(tcfg, v, train=False):
            for c in st.chunks:
                want = tt.stage_slice_params(tcfg, full, c, S * v)
                assert sorted(_paths(st.params[c])) == sorted(_paths(want))
                for path in _paths(want):
                    assert torch.equal(_get(st.params[c], path),
                                       _get(want, path)), (c, path)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's one-device run from its init: the first step's loss and
    gradient, and 5 steps of ``make_train_step`` (losses, norms)."""
    jcfg, tcfg = _cfgs()
    b = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(x) for k, x in b.items()}
    mesh = jbuild_mesh(JMeshSpec(dp=1), jax.devices()[:1])
    bundle = jax_make_train_step(jcfg, mesh, learning_rate=1e-3)
    state = bundle.init(seed=0)
    params = _np(state["params"])
    loss, grad = jax.jit(jax.value_and_grad(
        lambda q: jt.lm_loss(jcfg, q, jb)[0]))(state["params"])
    traj = []
    for _ in range(5):
        state, met = bundle.step(state, jb)
        traj.append((float(met["loss"]), float(met["grad_norm"])))
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": b, "params": params,
            "loss": float(loss), "grad": _np(grad), "traj": traj}


@pytest.mark.parametrize("v", [1, 2])
def test_first_step_stage_gradients_equal_jax(v, jax_ref):
    jcfg, tcfg = jax_ref["jcfg"], jax_ref["tcfg"]
    stages = _stages(tcfg, v, jax_ref["params"], train=False)
    loss, _ = _inprocess_step(stages, jax_ref["batch"], v, train=False)
    assert loss == pytest.approx(jax_ref["loss"], rel=1e-5)
    for st in stages:
        got = st.get_grads()
        assert sorted(got) == list(st.chunks)
        for c in st.chunks:
            _close(got[c], _np(jt.stage_slice_params(
                jcfg, jax_ref["grad"], c, S * v)))


@pytest.mark.parametrize("v", [1, 2])
def test_five_train_steps_equal_jax_one_device(v, jax_ref):
    stages = _stages(jax_ref["tcfg"], v, jax_ref["params"])
    for k, (jloss, jnorm) in enumerate(jax_ref["traj"]):
        loss, gn = _inprocess_step(stages, jax_ref["batch"], v)
        assert loss == pytest.approx(jloss, rel=1e-5), k
        assert gn == pytest.approx(jnorm, rel=1e-5), k


def test_checkpoints_merge_to_jax_and_reload_across_v_and_lowerings():
    jcfg, tcfg = _cfgs()
    b = _batch(jcfg.vocab_size)
    jstages = [jmp.PipelineStage(jcfg, s, S, seed=0, n_virtual=2,
                                 train=True, learning_rate=1e-3)
               for s in range(S)]
    jp = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    stages = _stages(tcfg, 2, jp)
    for _ in range(3):
        _inprocess_step(stages, b, 2)
        _jax_inprocess_step(jstages, b, 2)
    jmerged = jmp.merge_stage_checkpoints(
        jcfg, [_np(st.stage_checkpoint()) for st in jstages])
    want = train_state_from_jax(jmerged, tcfg, "cpu")
    merged = tmp.merge_stage_checkpoints(
        tcfg, [st.stage_checkpoint() for st in stages])
    assert set(merged) == {"params", "opt_state", "step"}
    assert merged["step"] == 3 and merged["opt_state"]["count"] == 3
    assert int(want["opt_state"]["count"]) == 3
    for key in ("mu", "nu"):
        _close(merged["opt_state"][key],
               jax.tree.map(lambda t: t.numpy(), want["opt_state"][key]))
    _close(merged["params"], jax.tree.map(lambda t: t.numpy(),
                                          want["params"]))

    # the v=2 stages go on; a v=1 pipeline and the one-device step
    # loaded from the checkpoint give the same next losses
    with pytest.raises(ValueError, match="hosts chunks"):
        stages[0].load_state(tmp.split_train_state(tcfg, merged, S, 1)[0])
    fresh = _stages(tcfg, 1)
    for st, p in zip(fresh, tmp.split_train_state(tcfg, merged, S, 1)):
        st.load_state(p)
    assert fresh[0]._step_count == 3
    one = make_train_step(tcfg, learning_rate=1e-3, device="cpu")
    from ray_tpu_torch.parallel.plan import _loadable
    ostate = train_state_from_jax(_loadable(merged), tcfg, "cpu")
    tb = {k: torch.tensor(x) for k, x in b.items()}
    for _ in range(2):
        src, _ = _inprocess_step(stages, b, 2)
        got, _ = _inprocess_step(fresh, b, 1)
        ostate, met = one.step(ostate, tb)
        assert got == pytest.approx(src, rel=1e-6)
        assert float(met["loss"]) == pytest.approx(src, rel=1e-5)


def _jax_inprocess_step(stages, batch, v):
    """tests/parallel/test_mpmd_pipeline.py::_inprocess_train_step."""
    K = S * v
    ids_mb = np.split(batch["input_ids"], M)
    mask_mb = np.split(batch["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    total = sum(ns)
    for i in range(M):
        x = ids_mb[i]
        for ch in range(K):
            st = stages[ch % S]
            out = st.forward_one(ch, i, x, ids_mb[i], mask_mb[i]) \
                if ch == K - 1 else st.forward_one(ch, i, x)
            if ch < K - 1:
                x = np.asarray(out)
        g = np.float32(ns[i] / total)
        for ch in range(K - 1, -1, -1):
            g = stages[ch % S].backward_one(ch, i, g)
            if g is not None:
                g = np.asarray(g)
    gsq = sum(st.grad_sq_norm() for st in stages)
    for st in stages:
        st.apply_opt(gsq)


# -------------------------------------------- mailboxes and the recorder
def test_mailbox_take_times_out_typed_and_abort_unblocks():
    _, tcfg = _cfgs(n_layers=2)
    st = tmp.PipelineStage(tcfg, 0, 2, device="cpu", mailbox_deadline_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="pipeline_mailbox_deadline_s=0.2"):
        next(st.run(1))
    assert time.monotonic() - t0 < 5.0
    st2 = tmp.PipelineStage(tcfg, 0, 2, device="cpu", mailbox_deadline_s=30)
    t = threading.Timer(0.2, st2.abort)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="aborted"):
        next(st2.run(1))
    assert time.monotonic() - t0 < 5.0
    t.join()
    with pytest.raises(RuntimeError, match="no accumulated grads"):
        tmp.PipelineStage(tcfg, 0, 2, device="cpu", train=True).apply_opt(1.0)
    with pytest.raises(RuntimeError, match="train=False"):
        st.apply_opt(1.0)


def test_streaming_run_records_stage_tick_spans(monkeypatch):
    """Both stages' ``run`` generators driven by hand (the driver's
    routing, in one thread): the op outputs come in the schedule's
    order, and every forward, backward, idle and optimizer interval is
    a STAGE_TICK record with its chunk."""
    _, tcfg = _cfgs()
    records = []

    class Rec:
        def record(self, ev, **kw):
            records.append(dict(kw, ev=ev))

        def maybe_flush(self):
            pass
    monkeypatch.setattr(tmp, "_recorder", lambda: Rec())
    v, K = 2, S * 2
    stages = _stages(tcfg, v)
    b = _batch(tcfg.vocab_size)
    ids_mb = np.split(b["input_ids"], M)
    mask_mb = np.split(b["loss_mask"], M)
    ns = [float(mk[:, 1:].sum()) for mk in mask_mb]
    stages[0].feed(acts={(0, i): ids_mb[i] for i in range(M)})
    stages[-1].feed(targets={i: (ids_mb[i], mask_mb[i]) for i in range(M)},
                    grads={(K - 1, i): np.float32(ns[i] / sum(ns))
                           for i in range(M)})
    gens = [st.run(M) for st in stages]
    orders = [tmp.one_f_one_b_order(s, S, M, v) for s in range(S)]
    # a deterministic interleaving: each stage runs its next op when its
    # inputs are in its mailboxes
    cursor, losses = [0, 0], {}
    while any(c < len(o) for c, o in zip(cursor, orders)):
        progressed = False
        for s in range(S):
            if cursor[s] == len(orders[s]):
                continue
            op, i, ch = orders[s][cursor[s]]
            box = stages[s]._acts if op == "F" else stages[s]._grads_in
            if (ch, i) not in box:
                continue
            out = next(gens[s])
            cursor[s] += 1
            progressed = True
            if op == "F" and ch < K - 1:
                stages[(ch + 1) % S].put_activation(ch + 1, i, out)
            elif op == "F":
                losses[i] = out
            elif ch > 0:
                stages[(ch - 1) % S].put_grad(ch - 1, i, out)
        assert progressed
    gsq = sum(st.grad_sq_norm() for st in stages)
    for st in stages:
        st.apply_opt(gsq)
    ticks = [r for r in records if r["ev"] == "STAGE_TICK"]
    phases = {r["phase"] for r in ticks}
    assert {"forward", "backward", "opt"} <= phases
    assert {(r["stage"], r["vs"]) for r in ticks if "vs" in r} == \
        {(0, 0), (0, 2), (1, 1), (1, 3)}
    assert sum(r["phase"] == "forward" for r in ticks) == K * M
    st = stages[1].step_stats()
    assert st["ops"] == 2 * M * v and st["sent_bytes"] > 0
    assert st["recv_bytes"] > 0


# ------------------------------------------------------ through the runtime
def test_mpmd_pipeline_train_step_on_two_cpu_actors_equals_in_process():
    """One train step through the runtime against the in-process step:
    the loss and grad norm, and the first moments after it (a tenth of
    the gradients; the params after an Adam step are no such test, as a
    gradient within rounding of zero moves its param by a share of the
    learning rate either way); the streamed checkpoint equal to the
    merged one and reloaded block by block; a second step that takes no
    gradient to the driver, and a third on the serial path."""
    import ray_tpu_torch
    from ray_tpu_torch.core.metric_defs import runtime_metrics
    from ray_tpu_torch.util.state import list_task_events
    _, tcfg = _cfgs(vocab_size=2048, d_model=64, head_dim=32)
    b = _batch(tcfg.vocab_size, rows=4, seq=32)
    ray_tpu_torch.init(num_cpus=4, _num_initial_workers=0)
    try:
        pipe = tmp.MPMDPipeline(tcfg, n_stages=S, n_microbatches=M, seed=0,
                                n_virtual=2, train=True, learning_rate=1e-3)
        assert pipe.stage_gpus == 0.0
        stages = _stages(tcfg, 2)
        counter = runtime_metrics().materialized_bytes
        read = lambda: sum(counter._values.values())  # noqa: E731
        res = pipe.step(b)
        want, gn = _inprocess_step(stages, b, 2)
        assert res.loss == pytest.approx(want, rel=1e-5)
        assert res.grad_norm == pytest.approx(gn, rel=1e-5)
        assert res.step == 1 and 0.0 <= res.bubble_fraction < 1.0
        merged = pipe.save_checkpoint()
        local = tmp.merge_stage_checkpoints(
            tcfg, [st.stage_checkpoint() for st in stages])
        _close(merged["opt_state"]["mu"], local["opt_state"]["mu"],
               rtol=1e-4, atol=1e-9)
        # the streamed checkpoint is the same state, and its blocks load
        # worker to worker into the same grid
        refs = pipe.stream_checkpoint_refs()
        streamed = pipe.save_checkpoint_streaming(refs=refs)
        _close(streamed["params"], merged["params"], rtol=0, atol=0)
        _close(streamed["opt_state"]["nu"], merged["opt_state"]["nu"],
               rtol=0, atol=0)
        ray_tpu_torch.get([a.load_state_blocks.remote(*r)
                           for a, r in zip(pipe.stages, refs)], timeout=120)
        del refs
        before = read()
        res = pipe.step(b)
        want, _ = _inprocess_step(stages, b, 2)
        assert res.loss == pytest.approx(want, rel=1e-5)
        # the driver took scalars only: M loss dicts, stats, opt metrics
        assert read() - before < 30_000
        # the serial (unpipelined) baseline takes the same step
        pipe.serial = True
        res = pipe.step(b)
        want, _ = _inprocess_step(stages, b, 2)
        assert res.loss == pytest.approx(want, rel=1e-5) and res.step == 3
        ticks = list_task_events(filters=[("ev", "=", "STAGE_TICK")])
        assert {"forward", "backward", "opt"} <= {t.get("phase")
                                                 for t in ticks}
        pipe.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_stage_mesh_paths_raise_naming_item_9():
    """The stage mesh is ported (``tests/test_torch_mpmd3d.py`` holds it
    against JAX): no mesh option raises ``NotImplementedError`` any
    more. A rank of a dp x fsdp mesh needs its stage's collective group;
    ``stage_mesh=True`` runs the mesh path on one rank, with the int8
    transport and the flat update; a bad transport still raises."""
    _, tcfg = _cfgs()
    for kw in ({"dp": 2}, {"fsdp": 2}):
        with pytest.raises(ValueError, match="group_name"):
            tmp.PipelineStage(tcfg, 0, 2, device="cpu", **kw)
        st = tmp.PipelineStage(tcfg, 0, 2, device="cpu", rank=1,
                               group_name="pp0", **kw)
        assert st.use_mesh and st.n_model == 2 and st.rank == 1
    for kw in ({}, {"grad_transport": "int8"},
               {"shard_weight_update": True}):
        st = tmp.PipelineStage(tcfg, 0, 2, device="cpu", stage_mesh=True,
                               train=True, **kw)
        assert st.use_mesh and st._group().size == 1
    with pytest.raises(ValueError, match="grad_transport"):
        tmp.PipelineStage(tcfg, 0, 2, device="cpu", grad_transport="bf16")
