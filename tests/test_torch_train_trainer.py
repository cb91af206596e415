"""The JAX package's ``tests/train/test_trainer.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): the dict checkpoint,
``DataParallelTrainer`` on two workers, top-2 retention, a gang restart
from the last checkpoint after a worker's death, a user error, restore,
and a ragged finish.

Left out, each with a twin here:

- ``test_checkpoint_jax_roundtrip``: ``Checkpoint.from_jax``/``to_jax``
  are the JAX package's; the port's are ``from_torch``/``to_torch``.
- ``test_jax_trainer_single_host``: ``JaxTrainer`` runs a jitted JAX
  step; the port's trainer is ``TorchTrainer`` over ``TorchConfig``.
"""

import pytest
import torch

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)

LEAVE_OUT = {
    "test_checkpoint_jax_roundtrip":
        "from_jax/to_jax are the JAX package's: twin "
        "test_checkpoint_torch_roundtrip",
    "test_jax_trainer_single_host":
        "JaxTrainer steps a jitted JAX function: twin "
        "test_torch_trainer_two_workers",
}

globals().update(FIXTURES)
globals().update(load_core_tests(
    "train/test_trainer.py", LEAVE_OUT,
    edits=[("JaxTrainer, RunConfig", "RunConfig")]))
globals()["ray_session"] = ray_session


def test_checkpoint_torch_roundtrip():
    tree = {"w": torch.arange(4.0), "b": {"x": torch.ones((2, 2))}}
    ckpt = Checkpoint.from_torch(tree, step=7)
    restored = ckpt.to_torch()
    assert restored["b"]["x"].shape == (2, 2)
    assert float(restored["w"][3]) == 3.0
    assert ckpt.to_dict()["step"] == 7


def test_torch_trainer_two_workers(ray_session, storage_path):
    """Two workers in one gloo process group: each adds its rank's
    tensor into an all-reduce twice; rank 0's checkpoint holds the sum,
    on every rank equal."""

    def train_func():
        import torch
        import torch.distributed as dist

        import ray_tpu_torch.train as train
        ctx = train.get_context()
        assert dist.get_world_size() == ctx.get_world_size() == 2
        assert dist.get_rank() == ctx.get_world_rank()
        assert dist.get_backend() == "gloo"
        w = torch.zeros(())
        for _ in range(2):
            x = torch.ones(()) * (ctx.get_world_rank() + 1)
            dist.all_reduce(x)
            w = w + x
            train.report({"w": float(w)},
                         checkpoint=(Checkpoint.from_torch({"w": w})
                                     if ctx.get_world_rank() == 0
                                     else None))

    trainer = TorchTrainer(
        train_func,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="torch", storage_path=storage_path))
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["w"] == 6.0
    assert float(result.checkpoint.to_torch()["w"]) == 6.0


def test_torch_config_picks_gloo_unless_each_worker_has_a_card():
    from ray_tpu_torch.train.torch.config import _pick_backend
    assert TorchConfig().backend is None
    assert _pick_backend(0.0) == "gloo"
    assert _pick_backend(0.5) == "gloo"
    assert _pick_backend(1.0) == "nccl"


def test_scaling_config_speaks_gpus():
    assert ScalingConfig(num_workers=2).worker_bundle() == {"CPU": 1.0}
    assert ScalingConfig(use_gpu=True).worker_bundle() == {
        "CPU": 0.0, "GPU": 1.0}
    sc = ScalingConfig(num_workers=2, use_gpu=True,
                       resources_per_worker={"GPU": 0.5})
    assert sc.worker_bundle() == {"CPU": 0.0, "GPU": 0.5}
    assert sc.total_resources == {"CPU": 1.0, "GPU": 1.0}
    for bad in (dict(use_tpu=True), dict(topology="v5e-64")):
        with pytest.raises(ValueError, match="CUDA"):
            ScalingConfig(**bad)


def test_the_jax_trainer_names_raise_naming_the_torch_ones():
    import ray_tpu_torch.train as train
    for name, torch_name in (("JaxTrainer", "TorchTrainer"),
                             ("JaxConfig", "TorchConfig")):
        with pytest.raises(NotImplementedError, match=torch_name):
            getattr(train, name)


def test_to_torch_reads_every_member_as_np_load_and_checks_its_crc(tmp_path):
    """``to_torch`` reads each stored member of the npz in place: the
    arrays ``np.load`` gives (f32, int, 0-d, a Fortran-ordered one), and
    a flipped data byte fails the member's CRC-32 as ``zipfile`` would."""
    import zipfile

    import numpy as np
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((64, 48)).astype(np.float32),
            "b": [np.arange(7, dtype=np.int64), np.float32(3.5)],
            "c": np.asfortranarray(rng.standard_normal((5, 3)))}
    ckpt = Checkpoint.from_torch(tree)
    got = ckpt.to_torch()
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])
    assert float(got["b"][1]) == 3.5 and got["b"][1].dim() == 0
    np.testing.assert_array_equal(got["c"].numpy(), tree["c"])
    with np.load(f"{ckpt.path}/_pytree.npz") as data:
        assert sorted(data.files) == [f"leaf_{i}" for i in range(4)]
    raw = bytearray(open(f"{ckpt.path}/_pytree.npz", "rb").read())
    at = raw.index(tree["a"].tobytes()[:64]) + 100
    raw[at] ^= 1
    open(f"{ckpt.path}/_pytree.npz", "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        ckpt.to_torch()


def test_to_torch_refuses_a_member_np_savez_does_not_write(tmp_path):
    """A compressed member (``np.savez_compressed``) is refused with
    ``BadZipFile``: ``from_torch`` and the JAX package's ``from_jax``
    write stored members only."""
    import zipfile

    import numpy as np
    ckpt = Checkpoint.from_torch({"a": np.arange(12, dtype=np.float32)})
    np.savez_compressed(f"{ckpt.path}/_pytree.npz",
                        leaf_0=np.arange(12, dtype=np.float32))
    with pytest.raises(zipfile.BadZipFile, match="compressed"):
        ckpt.to_torch()
