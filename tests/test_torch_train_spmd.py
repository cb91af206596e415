"""``TorchTrainer`` gangs against the JAX package's one-process runs, on
the CPU: the counterpart of ``tests/train/test_multiprocess_spmd.py``.

- Four workers (gloo, ``device="cpu"``) train ``gptj-tiny`` over
  ``MeshSpec(fsdp=2, tp=2)``, starting from the JAX package's initial
  train state: a JAX ``Checkpoint.from_jax`` directory, read by the
  port's ``Checkpoint`` through ``resume_from_checkpoint`` and sharded
  by ``_bridge.shard_train_state_from_jax``. Their four loss
  trajectories match JAX's one-process run on a 4-device CPU mesh with
  the same seed and data at rtol 2e-4 (the JAX body's bound), and each
  other exactly.
- One worker (no process group, no mesh) matches JAX's one-device run at
  the port's 1e-5.
- Kill and resume at ``gptj-tiny`` (the card's TR1 at small size): two
  workers over ``fsdp=2``; rank 0 reports the gathered params and Adam
  moments after step 1; on the first attempt rank 1 dies right after
  its step-3 update; the gang restarts from the step-1 checkpoint. Each
  rank's restored shards of the params, moments, count and step equal
  what it held after step 1, and gathered again they equal the
  checkpoint's arrays; the re-run steps 2 and 3 give the killed
  attempt's losses (step 3's after an update from the restored moments).
"""

import json
import os
import sys

import cloudpickle
import jax
import numpy as np
import pytest

from ray_tpu.models import get_config as jax_get_config
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu.parallel.sharding import FSDP_RULES as JFSDP_RULES
from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu_torch._bridge import _find_adam_state
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N_STEPS = 4
GLOBAL_BATCH = 8
SEQ = 32
SEED = 7
LR = 1e-2


def _batches():
    rng = np.random.RandomState(1234)
    return [rng.randint(1, 512, size=(GLOBAL_BATCH, SEQ)).astype(np.int32)
            for _ in range(N_STEPS)]


@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=6, _num_initial_workers=0)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def _jax_run(mesh_kw, n_devices, rules):
    """JAX's one-process trajectory and its initial state, canonical:
    ``{"params", "opt_state": {"count", "mu", "nu"}, "step"}``."""
    cfg = jax_get_config("gptj-tiny")
    mesh = jbuild_mesh(JMeshSpec(**mesh_kw), jax.devices()[:n_devices])
    bundle = jax_make_train_step(cfg, mesh, rules=rules, learning_rate=LR)
    state = bundle.init(seed=SEED)
    start = jax.tree.map(np.asarray, state)
    adam = _find_adam_state(start["opt_state"])
    canon = {"params": start["params"],
             "opt_state": {"count": adam.count, "mu": adam.mu,
                           "nu": adam.nu},
             "step": start["step"]}
    losses = []
    for ids in _batches():
        state, m = bundle.step(state, {
            "input_ids": ids,
            "loss_mask": np.ones_like(ids, dtype=np.float32)})
        losses.append(float(m["loss"]))
    return losses, JaxCheckpoint.from_jax(canon).path


def _train_from_checkpoint(config):
    """Each worker: the mesh over the gang's process group (none for one
    worker), the state from the trainer's checkpoint, ``n_steps`` steps
    on the global batches; rank 0 reports every rank's losses."""
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch._bridge import (shard_train_state_from_jax,
                                       train_state_from_jax)
    from ray_tpu_torch.models import get_config, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES

    cfg = get_config("gptj-tiny")
    tree = train.get_checkpoint().to_torch()
    if config["mesh"]:
        mesh = build_mesh(MeshSpec(**config["mesh"]), device_type="cpu")
        bundle = make_train_step(cfg, mesh, FSDP_RULES, learning_rate=LR,
                                 device="cpu")
        state = shard_train_state_from_jax(tree, cfg, mesh, FSDP_RULES,
                                           device="cpu")
    else:
        assert not dist.is_initialized()
        bundle = make_train_step(cfg, learning_rate=LR, device="cpu")
        state = train_state_from_jax(tree, cfg, "cpu")
    losses = []
    for ids in config["batches"]:
        state, m = bundle.step(state, {"input_ids": ids})
        losses.append(float(m["loss"]))
    everyone = [losses]
    if dist.is_initialized():
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, losses)
    train.report({"losses": everyone})


def _fit(tmp_path, n_workers, mesh, ckpt_path):
    trainer = TorchTrainer(
        _train_from_checkpoint,
        train_loop_config={"mesh": mesh, "batches": _batches()},
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(num_workers=n_workers),
        run_config=RunConfig(name=f"spmd{n_workers}",
                             storage_path=str(tmp_path)),
        resume_from_checkpoint=Checkpoint(ckpt_path))
    result = trainer.fit()
    assert result.error is None, result.error
    return result.metrics["losses"]


def test_four_workers_on_fsdp2_tp2_match_jax_one_process(runtime, tmp_path):
    want, ckpt = _jax_run(dict(fsdp=2, tp=2), 4, JFSDP_RULES)
    got = _fit(tmp_path, 4, dict(fsdp=2, tp=2), ckpt)
    assert len(got) == 4
    for rank_losses in got:
        assert rank_losses == got[0]
    np.testing.assert_allclose(got[0], want, rtol=2e-4)
    # the optimizer is really stepping
    assert len(set(round(x, 6) for x in got[0])) == N_STEPS


def test_one_worker_matches_jax_one_device(runtime, tmp_path):
    want, ckpt = _jax_run({}, 1, None)
    got = _fit(tmp_path, 1, None, ckpt)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    """A nested dict of tensors or arrays as ``{path: numpy array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "detach"):
        return {prefix: tree.detach().cpu().double().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float64)}


def _train_state_tree(state):
    opt = state["opt_state"]
    return {"params": state["params"], "count": opt["count"],
            "mu": opt["mu"], "nu": opt["nu"], "step": state["step"]}


def _kill_and_resume(config):
    """TR1's protocol: steps 0-3 over fsdp=2, the gathered state
    reported after step 1, rank 1 dying after its first attempt's step-3
    update. Each rank logs ``(attempt, step, every rank's loss)`` a
    step, keeps its shards after step 1 and, on the second attempt,
    writes how far its restored shards, and the restored state gathered
    again, are from those and from the checkpoint's arrays."""
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch._bridge import (gather_to_numpy,
                                       shard_train_state_from_jax)
    from ray_tpu_torch.models import get_config, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES

    cfg = get_config("gptj-tiny")
    rank = train.get_context().get_world_rank()
    mesh = build_mesh(MeshSpec(fsdp=2), device_type="cpu")
    bundle = make_train_step(cfg, mesh, FSDP_RULES, learning_rate=LR,
                             device="cpu")
    def gathered(state):
        opt = state["opt_state"]
        return {"params": gather_to_numpy(state["params"], cfg, mesh,
                                          FSDP_RULES),
                "opt_state": {
                    "count": opt["count"].cpu().numpy(),
                    "mu": gather_to_numpy(opt["mu"], cfg, mesh, FSDP_RULES),
                    "nu": gather_to_numpy(opt["nu"], cfg, mesh, FSDP_RULES)},
                "step": state["step"].cpu().numpy()}

    shards = os.path.join(config["dir"], f"shards{rank}.npz")
    ckpt = train.get_checkpoint()
    if ckpt is None:
        state = bundle.init(seed=SEED)
    else:
        tree = ckpt.to_torch()
        state = shard_train_state_from_jax(tree, cfg, mesh, FSDP_RULES,
                                           device="cpu")
        mine = _flat(_train_state_tree(state))
        with np.load(shards) as kept:
            before = {k: kept[k] for k in kept.files}
        again = _flat(_train_state_tree(gathered(state)))
        saved = _flat(_train_state_tree(tree))
        report = {
            "keys": sorted(mine) == sorted(before) == sorted(again),
            "shards_max_abs": max(float(np.max(np.abs(mine[k] - before[k])))
                                  for k in mine),
            "gathered_max_abs": max(float(np.max(np.abs(again[k] - saved[k])))
                                    for k in again),
            "count": int(mine["/count"]), "step": int(mine["/step"]),
            "mu_max_abs": max(float(np.max(np.abs(v)))
                              for k, v in mine.items()
                              if k.startswith("/mu/")),
            "nu_max_abs": max(float(np.max(np.abs(v)))
                              for k, v in mine.items()
                              if k.startswith("/nu/"))}
        with open(os.path.join(config["dir"], f"restored{rank}.json"),
                  "w") as f:
            json.dump(report, f)
    killed = os.path.join(config["dir"], "killed_loss.json")
    attempt = int(os.path.exists(killed))
    for step in range(int(state["step"]), 4):
        # tokens from an eighth of the vocabulary, seeded by the step:
        # what a model can learn, so the loss falls
        rng = np.random.default_rng(step)
        ids = rng.integers(0, cfg.vocab_size // 8, (4, SEQ)).astype(
            np.int32)
        state, m = bundle.step(state, {"input_ids": ids})
        losses = [None, None]
        dist.all_gather_object(losses, float(m["loss"]))
        with open(os.path.join(config["dir"], f"rank{rank}.jsonl"),
                  "a") as f:
            f.write(json.dumps([attempt, step, losses]) + "\n")
        if step == 3 and rank == 1 and attempt == 0:
            with open(killed, "w") as f:
                json.dump(losses[1], f)
            os._exit(1)
        out = None
        if step == 1:
            full = gathered(state)
            if attempt == 0:
                np.savez(shards, **_flat(_train_state_tree(state)))
            if rank == 0:
                out = Checkpoint.from_torch(full, step=step)
        train.report({"step": step, "loss": losses[rank]}, checkpoint=out)


def test_a_killed_gang_resumes_from_its_checkpoint(runtime, tmp_path):
    from ray_tpu_torch.train import CheckpointConfig
    trainer = TorchTrainer(
        _kill_and_resume,
        train_loop_config={"dir": str(tmp_path)},
        torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="kill", storage_path=str(tmp_path / "runs"),
            checkpoint_config=CheckpointConfig(num_to_keep=1),
            failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == 3
    with open(tmp_path / "killed_loss.json") as f:
        killed = json.load(f)
    logs = {}
    for r in (0, 1):
        with open(tmp_path / f"rank{r}.jsonl") as f:
            logs[r] = [tuple(json.loads(line)[:2]) + (json.loads(line)[2],)
                       for line in f]
    # one restart: the first attempt ran steps 0-3, the second 2-3
    assert [(a, s) for a, s, _ in logs[0]] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (1, 2), (1, 3)]
    assert logs[0] == logs[1][:len(logs[0])]
    for _, _, losses in logs[0]:
        assert losses[0] == losses[1]
    loss = {(a, s): ls[0] for a, s, ls in logs[0]}
    assert loss[(0, 3)] == killed
    # each rank's restored shards are what it held after step 1 (the
    # moments non-zero, two updates counted), and gathered again they
    # are the checkpoint's arrays
    for r in (0, 1):
        with open(tmp_path / f"restored{r}.json") as f:
            restored = json.load(f)
        assert restored["keys"]
        assert restored["shards_max_abs"] == 0.0
        assert restored["gathered_max_abs"] == 0.0
        assert restored["count"] == 2 and restored["step"] == 2
        assert restored["mu_max_abs"] > 0 and restored["nu_max_abs"] > 0
    # the re-run of step 2 starts from the same params and batch; step
    # 3's loss follows step 2's update from the restored moments
    assert loss[(1, 2)] == loss[(0, 2)]
    assert loss[(1, 3)] == loss[(0, 3)]
    assert loss[(1, 3)] < loss[(0, 0)]
    # one checkpoint kept, the step-1 state, whole and loadable
    tree = result.checkpoint.to_torch()
    assert result.checkpoint.to_dict()["step"] == 1
    assert int(tree["step"]) == 2
    assert tree["params"]["embed"].shape == (512, 64)
    dirs = [d for d in os.listdir(result.path)
            if d.startswith("checkpoint_")]
    assert len(dirs) == 1
