"""The port stands alone: no file of ``ray_tpu_torch/``, nor
``chip_smoke.py``, ``store_probe.py`` or ``checkpoint_probe.py``,
imports JAX, the JAX package
or ``ml_dtypes``, and the port imports, serves (speculative decode, a
bf16 KV hand-off, tracing included), takes a train step, serves an
``LLMServer`` through ``serve.run``, trains rllib, runs trainers and
tuners (PBT among them), streams a ``ray_tpu_torch.data`` pipeline
into a trainer, compiles and runs a two-stage DAG, submits a job through
the dashboard, drives a task through a ``ray://`` client, runs the slice
arbiter's preempt-fold-return-regrow loop, resumes a workflow and brings
a cluster up and down from the command line with all of them made
unimportable."""

import ast
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "optax", "flax", "ray_tpu", "ml_dtypes")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "store_probe.py",
              ROOT / "checkpoint_probe.py"]
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert path.exists(), path
    bad = sorted({m for m in _imported_roots(path) if m in BANNED})
    assert not bad, f"{path.name} imports {bad}"


def test_port_serves_with_jax_and_ray_tpu_unimportable():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
        import torch
        torch.set_num_threads(1)
        from ray_tpu_torch.models import TransformerConfig
        from ray_tpu_torch.serve import EngineConfig, LLMEngine
        cfg = TransformerConfig(vocab_size=64, d_model=16, n_layers=2,
                                n_heads=2, head_dim=8, d_ff=32,
                                max_seq_len=64, rotary_dim=8,
                                dtype=torch.float32)
        eng = LLMEngine(cfg, EngineConfig(decode_slots=2, kv_block_size=4,
                                          max_seq_len=32, prefill_chunk=8),
                        seed=0, device="cpu")
        spec = LLMEngine(cfg, EngineConfig(
            decode_slots=2, kv_block_size=4, max_seq_len=32,
            prefill_chunk=8, spec_tokens=3, enable_trace=True),
            seed=0, device="cpu")
        try:
            toks = list(eng.generate_sync([1, 2, 3, 4, 5], 6))
            assert len(toks) == 6, toks
            assert eng.pool_audit() == []
            assert list(spec.generate_sync([1, 2, 3, 4, 5], 6,
                        trace_ctx={"request_id": "r", "sampled": True})) \
                == toks
            assert spec._tracer.shipped_local[-1]["status"] == "DONE"
            payload = spec.prefill_export([1, 2, 3, 4, 5])
            assert payload["kv"]["k"].dtype.name == "float32"
            from ray_tpu_torch.serve import pack_kv_blocks, unpack_kv_blocks
            k = torch.randn(2, 3, 4, 2, 8).to(torch.bfloat16)
            kv = pack_kv_blocks(k, k, "bf16")
            assert str(kv["k"].dtype) == "int16", kv["k"].dtype
            assert torch.equal(unpack_kv_blocks(kv)[0], k)
            got = list(eng._items(eng.submit_adopt(payload, 6), "adopt", 60))
            assert got == toks, (got, toks)
        finally:
            eng.shutdown()
            spec.shutdown()
        from ray_tpu_torch.models import make_train_step
        bundle = make_train_step(cfg, learning_rate=1e-3, device="cpu")
        state = bundle.init(seed=0)
        state, m = bundle.step(state, {"input_ids": torch.randint(
            0, 64, (2, 16), generator=torch.Generator().manual_seed(0))})
        assert torch.isfinite(m["loss"]) and int(state["step"]) == 1, m
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def _run(script: str, timeout: int = 240, **env_extra) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               RAY_TPU_JAX_PLATFORM="cpu", RAY_TPU_TORCH_PLATFORM="cpu")
    env.update(env_extra)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout
    return proc.stdout


def test_runtime_runs_with_jax_and_ray_tpu_unimportable():
    """init, a task, an actor, put/get of tensors and shutdown with the
    JAX packages unimportable in the driver; the worker imported none of
    them either."""
    _run("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
        import torch
        import ray_tpu_torch
        ray_tpu_torch.init(num_cpus=2, _num_initial_workers=1)
        try:
            @ray_tpu_torch.remote
            def scale(t, k):
                import sys
                seen = sorted({m.split(".")[0] for m in sys.modules}
                              & {"jax", "jaxlib", "ray_tpu", "ml_dtypes"})
                return t * k, seen

            @ray_tpu_torch.remote
            class Acc:
                def __init__(self):
                    self.total = torch.zeros(4, dtype=torch.bfloat16)

                def add(self, t):
                    self.total += t
                    return self.total

            t = torch.arange(4096, dtype=torch.float32).to(torch.bfloat16)
            out, seen = ray_tpu_torch.get(scale.remote(t, 2), timeout=120)
            assert torch.equal(out, t * 2) and seen == [], seen
            ref = ray_tpu_torch.put(t)
            assert torch.equal(ray_tpu_torch.get(ref, timeout=60), t)
            acc = Acc.remote()
            one = torch.ones(4, dtype=torch.bfloat16)
            ray_tpu_torch.get(acc.add.remote(one), timeout=120)
            assert ray_tpu_torch.get(acc.add.remote(one),
                                     timeout=60).tolist() == [2.0] * 4
        finally:
            ray_tpu_torch.shutdown()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)


def test_a_jax_session_and_a_port_session_share_nothing():
    """A JAX session, then a port session, in one process: distinct
    session dirs and shm prefixes, each package's own global worker, and
    nothing of either left in /dev/shm."""
    _run("""
        import json, os
        import ray_tpu, ray_tpu_torch
        from ray_tpu.core.global_state import try_global_worker as jax_w
        from ray_tpu_torch.core.global_state import (
            try_global_worker as port_w)
        seen = {}
        for name, pkg in (("jax", ray_tpu), ("port", ray_tpu_torch)):
            info = pkg.init(num_cpus=1, _num_initial_workers=1)
            with open(os.path.join(info["session_dir"], "session.json")) as f:
                shm = json.load(f)["shm_session"]
            @pkg.remote
            def one():
                return 1
            assert pkg.get(one.remote(), timeout=120) == 1
            assert (jax_w() is not None) == (name == "jax")
            assert (port_w() is not None) == (name == "port")
            pkg.shutdown()
            seen[name] = (info["session_dir"], shm)
        (jdir, jshm), (pdir, pshm) = seen["jax"], seen["port"]
        assert os.path.dirname(jdir) != os.path.dirname(pdir), seen
        assert jshm.startswith("raytpu-") and pshm.startswith("raytorch-")
        left = [f for f in os.listdir("/dev/shm")
                if os.path.basename(jdir) in f or os.path.basename(pdir) in f]
        assert not left, left
        print("OK")
    """)


def test_the_jax_address_variable_does_not_reach_the_port():
    """With ``RAY_TPU_ADDRESS`` (the JAX package's) naming a live JAX
    session, ``ray_tpu_torch.init()`` starts a session of its own; the
    port reads ``RAY_TPU_TORCH_ADDRESS``."""
    _run("""
        import os
        import ray_tpu, ray_tpu_torch
        jax_dir = ray_tpu.init(num_cpus=1, _num_initial_workers=0)[
            "session_dir"]
        try:
            os.environ["RAY_TPU_ADDRESS"] = jax_dir
            info = ray_tpu_torch.init(num_cpus=1, _num_initial_workers=1)
            try:
                port_dir = info["session_dir"]
                assert port_dir != jax_dir, port_dir
                assert os.path.dirname(port_dir) == \\
                    ray_tpu_torch.api.session_root(), port_dir
                @ray_tpu_torch.remote
                def session():
                    import os
                    return os.environ["RAY_TPU_TORCH_SESSION_DIR"]
                assert ray_tpu_torch.get(session.remote(),
                                         timeout=120) == port_dir
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
        print("OK")
    """)


def test_a_long_temp_dir_keeps_the_session_inside_it(tmp_path):
    """A temp dir too long for a unix socket path still holds the whole
    session: its sockets (the controller's, the direct channels', the
    zygote's) take abstract names, a zygote-forked actor and a task run,
    nothing of the session appears in the default temp dir, and shutdown
    leaves nothing in /dev/shm."""
    long_tmp = tmp_path / ("t" * 60) / ("u" * 40)
    long_tmp.mkdir(parents=True)
    out = _run("""
        import json, os, sys, tempfile
        sys.path.insert(0, os.getcwd())
        import chip_smoke
        import ray_tpu_torch
        from ray_tpu_torch import api
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.config import get_config
        info = ray_tpu_torch.init(num_cpus=2, _num_initial_workers=0,
                                  _system_config={"prestart_workers": 0})
        sdir = info["session_dir"]
        try:
            with open(os.path.join(sdir, "session.json")) as f:
                shm = json.load(f)["shm_session"]
            names = {"controller": P.socket_path(sdir),
                     "zygote": api._head.node._zygote_sock}
            holders, _ = chip_smoke.start_zygote()
            pid = ray_tpu_torch.get(holders[0].pid.remote(), timeout=60)
            actor = chip_smoke._Holder
            forked = ray_tpu_torch.remote(num_cpus=0)(actor).remote()
            assert chip_smoke.forked(ray_tpu_torch.get(
                forked.pid.remote(), timeout=120))
            @ray_tpu_torch.remote
            def session():
                import os
                return os.environ["RAY_TPU_TORCH_SESSION_DIR"]
            assert ray_tpu_torch.get(session.remote(), timeout=120) == sdir
            spill = get_config().spill_dir
        finally:
            ray_tpu_torch.shutdown()
        print(json.dumps({"session_dir": sdir, "shm": shm, "names": names,
                          "tmp": tempfile.gettempdir(), "spill": spill}))
        print("OK")
    """, TMPDIR=str(long_tmp))
    rec = json.loads(out.strip().splitlines()[-2])
    assert rec["tmp"] == str(long_tmp)
    sdir = rec["session_dir"]
    assert sdir.startswith(str(long_tmp) + os.sep), sdir
    assert rec["spill"].startswith(str(long_tmp) + os.sep), rec["spill"]
    assert rec["names"]["controller"].startswith("ipc://@raytorch-")
    assert rec["names"]["zygote"].startswith("@raytorch-")
    # no socket file and no session anywhere but under the long temp dir
    name = os.path.basename(sdir)
    for root in {tempfile.gettempdir(), "/tmp"}:
        assert not os.path.exists(os.path.join(root, "ray_tpu_torch", name))
    assert not [p for p in Path(sdir).rglob("*") if p.is_socket()]
    left = [f for f in os.listdir("/dev/shm") if rec["shm"] in f]
    assert not left, left


def test_serve_run_with_jax_and_ray_tpu_unimportable(tmp_path):
    """``serve.run`` of a CPU ``LLMServer`` (its device from the worker's
    CPU platform) answers a handle's stream and an HTTP request with the
    JAX packages unimportable in the driver and in every worker: a
    ``sitecustomize`` on the path bans them in each interpreter the
    runtime starts."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
    """))
    _run("""
        import json, sys, urllib.request
        assert sys.modules["jax"] is None and sys.modules["ray_tpu"] is None
        import ray_tpu_torch
        from ray_tpu_torch import serve

        class Server(serve.LLMServer):
            def modules(self):
                import sys
                banned = ("jax", "jaxlib", "ray_tpu", "ml_dtypes")
                return {"banned": all(sys.modules.get(n, 0) is None
                                      for n in banned),
                        "loaded": sorted(m for m, v in sys.modules.items()
                                         if m.split(".")[0] in banned
                                         and v is not None),
                        "device": str(self.engine.device)}

        ray_tpu_torch.init(num_cpus=4, _num_initial_workers=1)
        try:
            model = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                         head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                         dtype="float32")
            engine = dict(decode_slots=2, kv_block_size=4, max_seq_len=32,
                          prefill_chunk=8, max_new_tokens=6)
            h = serve.run(serve.deployment(Server).bind(
                model=model, engine=engine), route_prefix="/llm")
            toks = list(h.options(stream=True).generate.remote(
                [1, 2, 3, 4, 5]))
            assert len(toks) == 6, toks
            serve.start(http_options={"port": 0})
            req = urllib.request.Request(
                serve.proxy_address() + "/llm",
                data=json.dumps([1, 2, 3, 4, 5]).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = [json.loads(x) for x in r.read().decode().split()]
            assert got == toks, (got, toks)
            seen = h.modules.remote().result(timeout_s=60)
            assert seen == {"banned": True, "loaded": [],
                            "device": "cpu"}, seen
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))


def test_rllib_trains_with_jax_and_ray_tpu_unimportable():
    """PPO's learner update on the CPU, an env runner's samples over
    ``RandomEnv``, a checkpoint's round trip, a DQN update on a DQN
    runner's transitions and a continuous SAC update, with the JAX
    packages unimportable."""
    _run("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
        import math
        from ray_tpu_torch.rllib import (EnvRunner, Learner, PPOConfig,
                                         RandomEnv, RLModuleSpec)
        from ray_tpu_torch.rllib.ppo import ppo_loss
        from ray_tpu_torch.train import Checkpoint
        spec = RLModuleSpec(observation_dim=4, num_actions=2, hiddens=(8,))
        learner = Learner(spec, ppo_loss, device="cpu")
        runner = EnvRunner(lambda: RandomEnv(4, 2, 5), spec, num_envs=2)
        runner.set_weights(learner.get_weights())
        m = learner.update_from_batch(runner.sample(8))
        assert all(math.isfinite(v) for v in m.values()), m
        back = Checkpoint(Checkpoint.from_torch(
            learner._state["params"]).path).to_torch()
        assert back["pi"][0]["w"].shape == (4, 8)
        assert PPOConfig().lr > 0
        from ray_tpu_torch.rllib.dqn import DQNEnvRunner, DQNLearner
        from ray_tpu_torch.rllib.sac import ContinuousSACLearner
        import numpy as np
        dqn = DQNLearner(spec, learning_rate=1e-3, gamma=0.99,
                         grad_clip=10.0, target_update_freq=2,
                         double_q=True, seed=0, device="cpu")
        dqn_runner = DQNEnvRunner(lambda: RandomEnv(4, 2, 5), spec)
        dqn_runner.set_weights(dqn.get_weights())
        m = dqn.update(dqn_runner.sample(16, 0.5))
        assert all(math.isfinite(v) for v in m.values()), m
        box = RLModuleSpec(observation_dim=3, dist="squashed_gaussian",
                           action_dim=1, action_low=(-2.0,),
                           action_high=(2.0,), hiddens=(8,))
        sac = ContinuousSACLearner(box, actor_lr=1e-3, critic_lr=1e-3,
                                   alpha_lr=1e-3, gamma=0.99, tau=0.01,
                                   target_entropy=None, grad_clip=None,
                                   seed=0, device="cpu")
        rng = np.random.default_rng(0)
        m = sac.update({"obs": rng.normal(size=(8, 3)).astype("f4"),
                        "next_obs": rng.normal(size=(8, 3)).astype("f4"),
                        "actions": rng.uniform(-1, 1, (8, 1)).astype("f4"),
                        "rewards": rng.normal(size=8).astype("f4"),
                        "dones": np.zeros(8, "f4")})
        assert all(math.isfinite(v) for v in m.values()), m
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)


def test_train_and_tune_run_with_jax_and_ray_tpu_unimportable(tmp_path):
    """A two-worker ``TorchTrainer.fit`` (a gloo group, a checkpoint) and
    a ``Tuner.fit`` over a function trainable and a ``TorchTrainer``,
    with the JAX packages unimportable in the driver and the workers."""
    _run(f"""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
        import ray_tpu_torch
        from ray_tpu_torch import tune
        from ray_tpu_torch.train import (Checkpoint, RunConfig,
                                         ScalingConfig, TorchTrainer)
        from ray_tpu_torch.tune import TuneConfig, Tuner

        def train_func(config):
            import sys
            import torch
            import torch.distributed as dist
            import ray_tpu_torch.train as train
            x = torch.ones(()) * config.get("k", 1.0)
            if dist.is_initialized():
                dist.all_reduce(x)
            seen = sorted({{m.split(".")[0] for m in sys.modules}}
                          & {{"jax", "jaxlib", "ray_tpu", "ml_dtypes"}})
            rank = train.get_context().get_world_rank()
            train.report({{"x": float(x), "seen": seen}},
                         checkpoint=(Checkpoint.from_torch({{"x": x}})
                                     if rank == 0 else None))

        ray_tpu_torch.init(num_cpus=6, _num_initial_workers=0)
        try:
            result = TorchTrainer(
                train_func, scaling_config=ScalingConfig(num_workers=2),
                run_config=RunConfig(name="iso",
                                     storage_path={str(tmp_path)!r})).fit()
            assert result.error is None, result.error
            assert result.metrics == {{"x": 2.0, "seen": []}}, result.metrics
            assert float(result.checkpoint.to_torch()["x"]) == 2.0
            grid = Tuner(
                TorchTrainer(train_func,
                             scaling_config=ScalingConfig(num_workers=1)),
                param_space={{"train_loop_config": {{
                    "k": tune.grid_search([1.0, 3.0])}}}},
                tune_config=TuneConfig(metric="x", mode="max"),
                run_config=RunConfig(name="iso-tune",
                                     storage_path={str(tmp_path)!r})).fit()
            assert grid.num_errors == 0, grid.errors
            assert grid.get_best_result().metrics["x"] == 3.0
            assert all(r.metrics["seen"] == [] for r in grid)
        finally:
            ray_tpu_torch.shutdown()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)


def test_data_and_pbt_run_with_jax_and_ray_tpu_unimportable(tmp_path):
    """A ``Dataset`` (range -> map_batches -> random_shuffle) streamed
    into a two-worker ``DataParallelTrainer``, and a PBT ``Tuner`` over a
    class trainable that exploits once, with the JAX packages
    unimportable in the driver and the workers."""
    _run(f"""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
        import ray_tpu_torch
        from ray_tpu_torch import data, tune
        from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                         ScalingConfig)
        from ray_tpu_torch.tune import TuneConfig, Tuner
        from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

        def train_func():
            import sys
            import ray_tpu_torch.train as train
            ids = [int(i) for b in train.get_dataset_shard("train")
                   .iter_batches(batch_size=2) for i in b["id"]]
            seen = sorted({{m.split(".")[0] for m in sys.modules}}
                          & {{"jax", "jaxlib", "ray_tpu", "ml_dtypes"}})
            train.report({{"ids": ids, "seen": seen}})

        class Walker(tune.Trainable):
            def setup(self, config):
                self.value = 0.0

            def step(self):
                import sys
                self.value += self.config["rate"]
                bad = sorted({{m.split(".")[0] for m in sys.modules}}
                             & {{"jax", "ray_tpu", "ml_dtypes"}})
                return {{"score": self.value, "seen": bad}}

            def save_checkpoint(self, d):
                with open(d + "/v.txt", "w") as f:
                    f.write(str(self.value))
                return d

            def load_checkpoint(self, d):
                with open(d + "/v.txt") as f:
                    self.value = float(f.read())

            def reset_config(self, new_config):
                return True

        ray_tpu_torch.init(num_cpus=6, _num_initial_workers=0)
        try:
            ds = (data.range(12, parallelism=3)
                  .map_batches(lambda b: {{"id": b["id"] * 2}})
                  .random_shuffle(seed=0))
            result = DataParallelTrainer(
                train_func, scaling_config=ScalingConfig(num_workers=2),
                run_config=RunConfig(name="iso-data",
                                     storage_path={str(tmp_path)!r}),
                datasets={{"train": ds}}).fit()
            assert result.error is None, result.error
            assert result.metrics["seen"] == [], result.metrics
            assert 0 < len(result.metrics["ids"]) < 12
            assert all(i % 2 == 0 for i in result.metrics["ids"])
            pbt = PopulationBasedTraining(
                metric="score", mode="max", perturbation_interval=2,
                hyperparam_mutations={{"rate": [0.1, 1.0]}},
                quantile_fraction=0.5, resample_probability=0.0,
                synch=True, seed=0)
            grid = Tuner(
                Walker, param_space={{"rate": tune.grid_search([0.1, 1.0])}},
                tune_config=TuneConfig(metric="score", mode="max",
                                       scheduler=pbt),
                run_config=RunConfig(name="iso-pbt",
                                     storage_path={str(tmp_path)!r},
                                     stop={{"training_iteration": 4}})).fit()
            assert grid.num_errors == 0, grid.errors
            assert pbt.perturbation_count >= 1
            assert all(r.metrics["seen"] == [] for r in grid)
        finally:
            ray_tpu_torch.shutdown()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)


def test_dag_job_and_client_run_with_jax_and_ray_tpu_unimportable():
    """A compiled two-stage DAG over its channel pipeline, a job
    submitted through the dashboard (its log read back) and a task
    through a ``ray://`` client in another process, with the JAX
    packages unimportable in the driver, the job and the client."""
    _run("""
        import json, os, shlex, subprocess, sys
        BLOCK = ("jax", "jaxlib", "optax", "flax", "ray_tpu", "ml_dtypes")
        for name in BLOCK:
            sys.modules[name] = None      # any import of them now fails
        import torch
        import ray_tpu_torch
        from ray_tpu_torch.dag import InputNode
        from ray_tpu_torch.job_submission import JobSubmissionClient
        from ray_tpu_torch.util.client import ClientServer
        guard = "import sys\\nfor n in %r: sys.modules[n] = None\\n" % (
            BLOCK,)
        info = ray_tpu_torch.init(num_cpus=4, _num_initial_workers=2)
        try:
            @ray_tpu_torch.remote
            class Stage:
                def __init__(self, k):
                    self.k = k

                def run(self, t):
                    return t * self.k

            with InputNode() as inp:
                dag = Stage.bind(3).run.bind(Stage.bind(2).run.bind(inp))
            compiled = dag.experimental_compile()
            try:
                t = torch.arange(8, dtype=torch.bfloat16)
                assert torch.equal(ray_tpu_torch.get(
                    compiled.execute(t), timeout=120), t * 6)
                assert compiled._pipeline is not None
            finally:
                compiled.teardown()

            with open(os.path.join(info["session_dir"],
                                   "dashboard.json")) as f:
                client = JobSubmissionClient(json.load(f)["address"])
            body = (guard + "import ray_tpu_torch\\nray_tpu_torch.init()\\n"
                    "f = ray_tpu_torch.remote(lambda: 6 * 7)\\n"
                    "print('answer:', ray_tpu_torch.get(f.remote(), "
                    "timeout=120))\\nray_tpu_torch.shutdown()\\n")
            jid = client.submit_job(
                entrypoint=f"{sys.executable} -c {shlex.quote(body)}")
            status = client.wait_until_status(jid, timeout_s=180)
            logs = client.get_job_logs(jid)
            assert status == "SUCCEEDED" and "answer: 42" in logs, logs

            srv = ClientServer(port=0).start()
            try:
                code = (guard + "import ray_tpu_torch\\n"
                        f"ray_tpu_torch.init('ray://127.0.0.1:{srv.port}')\\n"
                        "f = ray_tpu_torch.remote(lambda x: x + 1)\\n"
                        "print('client:', ray_tpu_torch.get(f.remote(41), "
                        "timeout=120))\\nray_tpu_torch.shutdown()\\n")
                proc = subprocess.run([sys.executable, "-c", code],
                                      capture_output=True, text=True,
                                      timeout=180)
                assert "client: 42" in proc.stdout, proc.stdout + proc.stderr
            finally:
                srv.stop()
        finally:
            ray_tpu_torch.shutdown()
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)


def test_arbiter_workflow_and_cli_run_with_jax_and_ray_tpu_unimportable(
        tmp_path):
    """The slice arbiter preempts an ``ElasticTrainer(ParallelPlan(dp=2))``
    slice under sustained pressure, the trainer folds to dp=1, the ebb
    returns a slice and the trainer regrows, at a tiny size; a workflow
    whose last task fails once is resumed; ``cli up``/``down`` bring a
    local cluster up and down: with the JAX packages unimportable in
    every interpreter (a ``sitecustomize`` on the path)."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "optax", "flax", "ray_tpu",
                     "ml_dtypes"):
            sys.modules[name] = None      # any import of them now fails
    """))
    _run(f"""
        import json, os, subprocess, sys
        assert sys.modules["jax"] is None and sys.modules["ray_tpu"] is None
        import numpy as np
        import torch
        import ray_tpu_torch
        from ray_tpu_torch import workflow
        from ray_tpu_torch.autoscaler import (
            ArbiterPolicy, FakeSliceProvider, SliceArbiter, SliceManager,
            SliceTypeConfig)
        from ray_tpu_torch.core.events import FlightRecorder
        from ray_tpu_torch.models.transformer import TransformerConfig
        from ray_tpu_torch.parallel.elastic import ElasticTrainer
        from ray_tpu_torch.parallel.plan import ParallelPlan

        class Ctl:
            def __init__(self):
                self.scheduler = self
                self.recorder = FlightRecorder("iso", capacity=1024)

            def set_draining(self, node_id, flag):
                pass

            def call_on_loop(self, fn, timeout=None):
                return fn()

            def _reschedule_pgs_on_nodes(self, node_bs):
                return 0

            def _maybe_schedule(self, force=False):
                pass

        class Clock:
            t = 1000.0

            def __call__(self):
                return self.t

        ray_tpu_torch.init(num_cpus=8, _num_initial_workers=0)
        try:
            ctl, clock, gauges = Ctl(), Clock(), {{"queue_depth": 0.0}}
            prov = FakeSliceProvider(provider_config={{"max_slices": 2}})
            mgr = SliceManager(ctl, prov, [SliceTypeConfig(
                "pod", "1x1", {{"CPU": 1}})], idle_timeout_s=3600.0,
                drain_deadline_s=0.0)
            arb = SliceArbiter(mgr, policy=ArbiterPolicy(
                queue_high=4.0, queue_low=1.0, sustain_s=2.0, ebb_s=4.0),
                gauges_fn=lambda: dict(gauges), now_fn=clock)
            train = mgr.acquire_slice("pod")
            arb.claim(train, owner="train", kind="train", priority=0)
            serve_sid = mgr.acquire_slice("pod")
            arb.claim(serve_sid, owner="serve", kind="serve", priority=10)
            owned = {{train}}
            arb.register_on_return(lambda i: owned.add(i["slice_id"]))

            def pump(busy=True):
                alive = {{h for s in prov.non_terminated_nodes()
                         for h in prov.internal_ids(s)}}
                mgr.update({{"demand": [], "slice_demand": [],
                            "busy_nodes": alive if busy else set(),
                            "alive_nodes": alive}})
            pump()
            cfg = TransformerConfig(
                vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                head_dim=16, d_ff=64, max_seq_len=32, rotary_dim=8,
                block_style="gptj", dtype=torch.float32, remat=False,
                ce_chunk_size=8)
            rng = np.random.default_rng(1)
            batch = {{"input_ids": rng.integers(0, 128, (4, 16))}}
            trainer = ElasticTrainer(
                ParallelPlan(dp=2), cfg, learning_rate=1e-3,
                telemetry_interval_s=0, slice_manager=mgr,
                slice_filter=lambda s: s in owned, device="cpu")
            ref = ParallelPlan().build(cfg, learning_rate=1e-3,
                                       telemetry_interval_s=0,
                                       device="cpu")
            try:
                def step():
                    a, b = trainer.step(batch).loss, ref.step(batch).loss
                    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
                step()
                gauges["queue_depth"] = 9.0
                arb.update()
                clock.t += 2.5
                assert arb.update()["actions"] == ["preempt:" + train]
                step()
                assert trainer.plan.dp == 1
                pump(busy=False)
                gauges["queue_depth"] = 0.0
                arb.update()
                clock.t += 4.5
                assert arb.update()["actions"] == ["return"]
                pump()
                step()
                assert trainer.plan.dp == 2
                assert [r.trigger for r in trainer.recoveries] == [
                    "notice", "regrow"]
            finally:
                trainer.shutdown()
                ref.shutdown()
                mgr.shutdown()
                prov.shutdown()

            root = {str(tmp_path / "wf")!r}
            workflow.init_storage(root)
            marker = os.path.join(root, "marker")

            @ray_tpu_torch.remote
            def double(x):
                return 2 * x

            @ray_tpu_torch.remote
            def last(x, marker):
                if not os.path.exists(marker):
                    open(marker, "w").close()
                    raise RuntimeError("first attempt")
                return x + 1

            try:
                workflow.run(last.bind(double.bind(20), marker),
                             workflow_id="iso")
                raise AssertionError("the first attempt did not fail")
            except Exception as e:  # noqa: BLE001
                assert "first attempt" in str(e), e
            assert workflow.get_status("iso") == "FAILED"
            assert workflow.resume("iso") == 41
            assert workflow.get_status("iso") == "SUCCESSFUL"
        finally:
            ray_tpu_torch.shutdown()

        cfg_path = {str(tmp_path / "cluster.yaml")!r}
        with open(cfg_path, "w") as f:
            json.dump({{"cluster_name": "iso",
                       "provider": {{"type": "fake_slice", "session_dir":
                                    {str(tmp_path / "cluster")!r}}},
                       "head_node_type": "head",
                       "available_node_types": {{"head": {{"resources":
                                                           {{"CPU": 1}}}}}},
                       "slices": {{"pod": {{"topology": "1x1",
                                           "count": 1}}}}}}, f)
        cli = [sys.executable, "-m", "ray_tpu_torch.scripts.cli"]
        up = subprocess.run(cli + ["up", "-y", cfg_path], capture_output=True,
                            text=True, timeout=180)
        assert up.returncode == 0, up.stdout + up.stderr
        out = json.loads(up.stdout.strip().splitlines()[-1])
        assert len(out["slices"]) == 1 and out["created"], out
        down = subprocess.run(cli + ["down", "-y", cfg_path],
                              capture_output=True, text=True, timeout=180)
        assert down.returncode == 0, down.stdout + down.stderr
        gone = json.loads(down.stdout.strip().splitlines()[-1])
        assert gone["terminated"] == out["slices"], gone
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """, timeout=300, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
