"""The port's ``ElasticTrainer`` (``ray_tpu_torch.parallel.elastic``)
against the JAX package's, on the CPU in f32.

- The JAX bodies of ``tests/parallel/test_elastic.py`` load through
  ``tests/test_torch_runtime_loader.py``, edited where they name JAX:
  the tiny config's dtype is ``torch.float32``, the batch a seeded numpy
  draw (the JAX bodies draw it with ``jax.random``), the one-device plans
  (those the soak's trainer folds to as well) and the in-process stage
  run on ``device="cpu"``; the bodies whose
  ``ParallelPlan(dp=2)`` is a program of rank actors in the port (one
  process a rank, where JAX runs dp=2 in one process) run on the file's
  runtime. The slow bodies stay slow, as in JAX.
- ``ParallelPlan(dp=2)``, 2 steps, a drain notice, 2 more steps, from
  JAX's start state: the port's losses equal JAX's trainer's at 1e-5,
  the plan folds to dp=1 live and loses no step.
- A failure mid-step on the one-device plan replays the uninterrupted
  trajectory (the port's at 1e-6, JAX's at 1e-5), losing exactly 1 step.
- On CPU actors, ``ParallelPlan(pp=2, dp=2, n_microbatches=2)`` folds
  live to ``pp=2, dp=1`` on a notice, then a stage actor killed mid-step
  recovers on the same grid from the fold's snapshot (3 steps lost,
  replayed); the losses equal JAX's one-device ``ParallelPlan()`` at
  1e-5 step for step, and the ``ELASTIC_*`` events are recorded.
(A rank of a stage mesh killed while its peer waits in their stage's
collective is ``tests/test_torch_mpmd3d.py``'s last test.)
"""

import dataclasses
import os
import sys
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.autoscaler.slices import DrainNotice as JaxDrainNotice
from ray_tpu.models.transformer import TransformerConfig as JConfig
from ray_tpu.parallel.elastic import ElasticTrainer as JaxElasticTrainer
from ray_tpu.parallel.plan import ParallelPlan as JaxPlan
from ray_tpu_torch._bridge import _find_adam_state
from ray_tpu_torch.autoscaler.slices import DrainNotice
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel.elastic import ElasticTrainer
from ray_tpu_torch.parallel.plan import ParallelPlan
from test_torch_runtime_loader import FIXTURES, load_core_tests

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

EDITS = (
    ("import jax\n\nfrom ray_tpu_torch.exceptions",
     "import torch\n\nfrom ray_tpu_torch.exceptions"),
    ("    import jax.numpy as jnp\n", ""),
    ("dtype=jnp.float32", "dtype=torch.float32"),
    ("np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s),\n"
     "                                      0, cfg.vocab_size))",
     "np.random.default_rng(seed).integers(\n"
     "        0, cfg.vocab_size, (b, s)).astype(np.int32)"),
    ("telemetry_interval_s=0", 'telemetry_interval_s=0, device="cpu"'),
    ("PipelineStage(cfg, 0, 2, mailbox_deadline_s=0.3)",
     'PipelineStage(cfg, 0, 2, mailbox_deadline_s=0.3, device="cpu")'),
    ("learning_rate=1e-3, slice_manager=mgr)",
     'learning_rate=1e-3, slice_manager=mgr, device="cpu")'),
)
#: bodies that build ``ParallelPlan(dp=2)``: rank actors on the runtime
ON_THE_RUNTIME = ("test_slice_filter_ignores_foreign_drains",
                  "test_drain_notice_folds_dp_and_continues_trajectory")

_core = load_core_tests("parallel/test_elastic.py", edits=EDITS)
globals().update(FIXTURES)
globals().update(_core)
for _name in ON_THE_RUNTIME:
    globals()[_name] = pytest.mark.usefixtures("runtime")(_core[_name])

TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2, head_dim=16,
            d_ff=64, max_seq_len=32, rotary_dim=8, block_style="gptj",
            remat=False, ce_chunk_size=8)
JCFG = JConfig(**TINY, dtype=jnp.float32)
TCFG = TransformerConfig(**TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def _runtime_of_the_file():
    """Shuts the file's runtime down after its last test."""
    import ray_tpu_torch
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture
def runtime(_runtime_of_the_file):
    """One runtime for the file's tests, started by the first that needs
    it (and again after a loaded body's own fixture shut it down)."""
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=8, _num_initial_workers=0)


def _train_batch(rows=8, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (rows, seq)).astype(np.int32),
            "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}


def _canonical_from_jax(ck):
    """JAX's canonical checkpoint (an optax adamw state) as the port's."""
    adam = _find_adam_state(ck["opt_state"])
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": tree(ck["params"]),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": tree(adam.mu), "nu": tree(adam.nu)},
            "step": int(ck["step"])}


def _notice(cls):
    return cls(slice_id="slice-0", reason="maintenance", hosts=1,
               type="pod", deadline_s=4.0)


def test_notice_fold_of_dp2_equals_jax_elastic_trainer(runtime):
    b = _train_batch()
    jt = JaxElasticTrainer(JaxPlan(dp=2), JCFG, learning_rate=1e-3,
                           telemetry_interval_s=0)
    t = ElasticTrainer(ParallelPlan(dp=2), TCFG, learning_rate=1e-3,
                       device="cpu")
    try:
        t.load_checkpoint(_canonical_from_jax(jt.save_checkpoint()))
        for k in range(4):
            if k == 2:
                t._on_drain(_notice(DrainNotice))
                jt._on_drain(_notice(JaxDrainNotice))
            got, want = t.step(b), jt.step(b)
            assert got.loss == pytest.approx(want.loss, rel=1e-5), k
            assert got.step == want.step == k + 1
        assert t.plan.dp == 1 and t.plan.lowering == "spmd"
        assert dataclasses.asdict(t.plan) == dataclasses.asdict(jt.plan)
        rep = t.recoveries[0]
        assert len(t.recoveries) == 1
        assert rep.trigger == "notice" and rep.steps_lost == 0
        assert rep.from_plan == jt.recoveries[0].from_plan
        assert rep.to_plan == jt.recoveries[0].to_plan
    finally:
        t.shutdown()
        jt.shutdown()


def test_failure_replays_the_uninterrupted_trajectory_losing_one_step():
    from ray_tpu_torch.exceptions import RayTpuError

    class Boom(RayTpuError):
        """A typed runtime failure (an actor's death, say)."""
    b = _train_batch()
    jref = JaxPlan().build(JCFG, learning_rate=1e-3, seed=0,
                           telemetry_interval_s=0)
    start = _canonical_from_jax(jref.save_checkpoint())
    t = ElasticTrainer(ParallelPlan(), TCFG, learning_rate=1e-3,
                       device="cpu")
    ref = ParallelPlan().build(TCFG, learning_rate=1e-3, device="cpu")
    t.load_checkpoint(start)
    ref.load_checkpoint(start)
    for k in range(5):
        if k == 2:
            broken = t.program

            def boom(_):
                raise Boom("slice preempted mid-step")
            broken.step = boom
        got, want, jw = t.step(b), ref.step(b), jref.step(b)
        assert abs(got.loss - want.loss) <= 1e-6 * abs(want.loss), k
        assert got.loss == pytest.approx(jw.loss, rel=1e-5), k
    assert t.program is not broken
    rep, = t.recoveries
    assert rep.trigger == "failure" and rep.steps_lost == 1
    assert rep.from_plan == rep.to_plan and t.steps_lost_total == 1


def _kill_on_first_item(victim):
    """Patch the driver's ``streaming.wait_any`` so that the first item
    of the next pipeline step kills ``victim``: a kill that lands
    mid-step, every time."""
    import ray_tpu_torch
    from ray_tpu_torch.core import streaming
    orig = streaming.wait_any

    def wait_any(*args, **kw):
        out = orig(*args, **kw)
        if streaming.wait_any is wait_any:
            streaming.wait_any = orig
            ray_tpu_torch.kill(victim)
        return out
    streaming.wait_any = wait_any
    return orig


def test_pp2_dp2_folds_on_a_notice_then_survives_a_killed_stage_actor(
        runtime):
    from ray_tpu_torch.core import streaming
    from ray_tpu_torch.util.state import list_task_events
    b = _train_batch()
    jref = JaxPlan().build(JCFG, learning_rate=1e-3, seed=0,
                           telemetry_interval_s=0)
    t = ElasticTrainer(ParallelPlan(pp=2, dp=2, n_microbatches=2), TCFG,
                       learning_rate=1e-3, snapshot_interval=8)
    orig = streaming.wait_any
    try:
        assert t.program.pipeline.n_ranks == 2
        t.load_checkpoint(_canonical_from_jax(jref.save_checkpoint()))
        for k in range(6):
            if k == 2:
                t._on_drain(_notice(DrainNotice))
            if k == 4:
                _kill_on_first_item(t.program.pipeline.stages[1])
            got, want = t.step(b), jref.step(b)
            assert got.loss == pytest.approx(want.loss, rel=1e-5), k
            assert got.step == k + 1
            if k == 2:
                assert (t.plan.pp, t.plan.dp) == (2, 1)
                assert t.program.pipeline.n_ranks == 1
        notice, failure = t.recoveries
        assert notice.trigger == "notice" and notice.steps_lost == 0
        assert notice.live_snapshot
        assert "pp=2" in notice.to_plan and "dp=2" not in notice.to_plan
        assert failure.trigger == "failure" and failure.steps_lost == 3
        assert failure.reason == "ActorDiedError"
        assert failure.from_plan == failure.to_plan == notice.to_plan
        assert t.steps_lost_total == 3
        evs = {e["ev"] for e in list_task_events(limit=100_000)}
        for name in ("ELASTIC_NOTICE", "ELASTIC_SNAPSHOT",
                     "ELASTIC_RELOWER", "ELASTIC_RESUME"):
            assert name in evs, (name, sorted(evs))
    finally:
        streaming.wait_any = orig
        t.shutdown()


class _SliceHosts:
    """What the slice manager sees of a controller: the fake provider's
    hosts are synthetic, so its drain and placement hooks act on
    nothing."""

    def __init__(self):
        from ray_tpu_torch.core.events import FlightRecorder
        self.recorder = FlightRecorder("test", capacity=4096)
        self.scheduler = self
        self.draining = {}
        self.ready_queues, self.tasks, self.leases = {}, {}, {}
        self.actors, self.nodes, self.pending_pgs = {}, {}, []

    def set_draining(self, node_id, flag):
        self.draining[node_id.binary()] = flag

    def call_on_loop(self, fn, timeout=None):
        return fn()

    def _reschedule_pgs_on_nodes(self, node_bs):
        return 0

    def _maybe_schedule(self, force=False):
        pass


def _store_bytes():
    from ray_tpu_torch.core.global_state import global_worker
    return global_worker().shm._segment().stats()[0]


def test_a_shut_down_trainer_gives_the_store_back(runtime):
    """An ``ElasticTrainer`` (pp=2, dp=2, a layer a stage) under a fake
    one-slice ``SliceManager`` folds on the slice's maintenance notice,
    then recovers from a stage actor killed mid-step. Once it is shut
    down and dropped it is collected: the killed actor's error, cached
    for its object, is never raised itself (a raised copy's traceback
    would hold the recovery's frames, the trainer and its host snapshot,
    for as long as the entry lives). And the store's live bytes come back
    to within 1 MB of what they were before it was built (the recoveries
    move some 20 MB through it here, more than 10 MB live at the run's
    peak); the runtime frees an object after
    its grace window, so the check waits for it."""
    import gc
    import threading
    import weakref

    from ray_tpu_torch.autoscaler import (FakeSliceProvider, SliceManager,
                                          SliceTypeConfig)
    from ray_tpu_torch.core import streaming
    from ray_tpu_torch.core.global_state import global_worker
    cfg = dataclasses.replace(TCFG, vocab_size=4096, d_model=64, n_heads=4,
                              n_layers=2)
    b = _train_batch(seed=3)
    b["input_ids"] = np.random.default_rng(3).integers(
        0, cfg.vocab_size, b["input_ids"].shape).astype(np.int32)
    provider = FakeSliceProvider(provider_config={"max_slices": 1})
    mgr = SliceManager(_SliceHosts(), provider,
                       [SliceTypeConfig("host", "1x1", {"CPU": 8})],
                       idle_timeout_s=3600.0, drain_deadline_s=0.0)
    sid = mgr.acquire_slice("host")
    hosts = set(provider.internal_ids(sid))

    def pump():
        mgr.update({"demand": [], "slice_demand": [], "busy_nodes": hosts,
                    "alive_nodes": hosts})
    pump()
    gc.collect()
    before = _store_bytes()
    # the live bytes' peak over the run: a superseded snapshot is freed
    # a flush and a grace window after it is dropped, sooner than the
    # run's end when steps are slow, so the end alone can miss it
    peak, stop = [0], threading.Event()

    def sample():
        while not stop.wait(0.05):
            peak[0] = max(peak[0], _store_bytes() - before)
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t = ElasticTrainer(ParallelPlan(pp=2, dp=2, n_microbatches=2), cfg,
                       learning_rate=1e-3, snapshot_interval=8,
                       slice_manager=mgr)
    orig = streaming.wait_any
    try:
        for k in range(6):
            if k == 2:
                provider.inject_maintenance(sid)
                pump()
            if k == 4:
                _kill_on_first_item(t.program.pipeline.stages[1])
            t.step(b)
        assert [(r.trigger, r.steps_lost) for r in t.recoveries] == \
            [("notice", 0), ("failure", 3)]
        held = max(peak[0], _store_bytes() - before)
    finally:
        stop.set()
        sampler.join()
        streaming.wait_any = orig
        t.shutdown()
        mgr.shutdown()
        provider.shutdown()
    gone = weakref.ref(t)
    del t
    gc.collect()
    assert gone() is None, "the trainer outlived its last reference"
    deadline = time.monotonic() + global_worker().config.free_grace_s + 10
    while _store_bytes() > before + (1 << 20) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    assert held > 10 << 20
    assert _store_bytes() <= before + (1 << 20), (before, held,
                                                  _store_bytes())
