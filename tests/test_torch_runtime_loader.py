"""Run the JAX package's ``tests/core``, ``tests/serve``, ``tests/rlhf``
and ``tests/rllib`` bodies on the port's runtime.

Each ``tests/test_torch_runtime_<name>.py`` file loads
``tests/core/test_<name>.py`` with :func:`load_core_tests`, and each
``tests/test_torch_serve_<name>.py`` loads ``tests/serve/test_<name>.py``
(named ``"serve/test_<name>.py"``), and each
``tests/test_torch_rlhf_<name>.py`` that loads bodies
``tests/rlhf/test_<name>.py`` (``"rlhf/test_<name>.py"``), and each
``tests/test_torch_rllib_<name>.py`` that loads bodies
``tests/rllib/test_<name>.py`` (``"rllib/test_<name>.py"``), as
``tests/test_torch_autoscaler_slices.py`` and ``tests/test_torch_elastic.py``
load ``"autoscaler/test_slices.py"`` and ``"parallel/test_elastic.py"``,
and ``tests/test_torch_train_trainer.py`` and ``tests/test_torch_tune.py``
load ``"train/test_trainer.py"``, ``"tune/test_tune.py"``,
``"tune/test_callbacks.py"`` and ``"tune/test_new_schedulers.py"``, and
each ``tests/test_torch_data_<name>.py`` that loads bodies
``tests/data/test_<name>.py`` (``"data/test_<name>.py"``), as
``tests/test_torch_dag.py``, ``tests/test_torch_dashboard.py``,
``tests/test_torch_ray_client.py`` and ``tests/test_torch_experimental.py``
load ``"dag/test_dag_workflow.py"``, ``"dashboard/test_*.py"``,
``"util/test_ray_client.py"`` and ``"util/test_iter_misc.py"``, and
``tests/test_torch_workflow.py``, ``tests/test_torch_util_*.py`` and
``tests/test_torch_autoscaler_*.py`` load ``"dag/test_workflow_events.py"``,
``"util/test_state_metrics_mp.py"``, ``"util/test_joblib_logmon_env.py"``
and the ``"autoscaler/test_*.py"`` files but the slow slice e2e one:
the source is
read, ``ray_tpu`` is rewritten to ``ray_tpu_torch`` on word boundaries
and ``RAY_TPU_<NAME>`` environment variables to ``RAY_TPU_TORCH_<NAME>``,
every ``ray_tpu_torch.get``/``ray_tpu_torch.wait`` call without a timeout
gets one of ``DEFAULT_TIMEOUT_S``, and the result is compiled as a new
module registered with ``cloudpickle.register_pickle_by_value``, so
workers receive its functions by value and never import the JAX test
module or ``ray_tpu``. The file then takes the module's tests, fixtures
and helpers into its own namespace, less the bodies it leaves out (each
named with its reason), beside this module's fixtures: the
``tests/conftest.py`` fixtures ``ray_start_regular``/``ray_start_shared``,
the ``tests/serve/conftest.py`` fixture ``serve_session``, the
``tests/rlhf/conftest.py`` fixture ``rlhf_cluster`` and the
``tests/rllib/conftest.py`` fixture ``ray_session`` on the port's
runtime, and a metrics-registry reset for the port's registry. The RLHF
files also take ``RLHF_ON_THE_CPU``: the JAX bodies build trainers and
rollout engines in the test process with no device named (the JAX
package's run on the CPU platform there), so the fixture names the CPU
for them, as a test passes ``device="cpu"``. The rllib files take
``RLLIB_ON_THE_CPU`` for the same reason: it names the CPU for the
``Learner``s a body builds with no device (an algorithm's local learner
among them); remote learners and env runners are workers on the CPU
platform.

The tests of this file check the loader itself.
"""

import ast
import os
import re
import sys
import types
from pathlib import Path

import cloudpickle
import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_TESTS = ROOT / "tests"
JAX_CORE = JAX_TESTS / "core"
JAX_SERVE = JAX_TESTS / "serve"
JAX_RLHF = JAX_TESTS / "rlhf"
JAX_RLLIB = JAX_TESTS / "rllib"
#: a get or wait in a loaded body that names no timeout gets this one
DEFAULT_TIMEOUT_S = 120.0

# Port workers stay off the card, as tests/conftest.py keeps the JAX
# package's workers on the CPU platform (RAY_TPU_JAX_PLATFORM).
os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")


class _TimeoutDefaults(ast.NodeTransformer):
    """``ray_tpu_torch.get(...)``/``.wait(...)`` without ``timeout=``
    gain ``timeout=DEFAULT_TIMEOUT_S``."""

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("get", "wait") \
                and isinstance(f.value, ast.Name) \
                and f.value.id == "ray_tpu_torch" \
                and not any(k.arg in ("timeout", None) for k in node.keywords):
            node.keywords.append(ast.keyword(
                arg="timeout", value=ast.Constant(DEFAULT_TIMEOUT_S)))
        return node


def jax_test_path(filename: str) -> Path:
    """``tests/core/<filename>``, or ``tests/<filename>`` for a name
    with a directory (``"serve/test_serve.py"``)."""
    return JAX_TESTS / filename if "/" in filename else JAX_CORE / filename


def port_source(filename: str) -> str:
    """The JAX test file's source with ``ray_tpu`` renamed, and its
    environment variables: the port reads ``RAY_TPU_TORCH_<NAME>`` where
    the JAX package reads ``RAY_TPU_<NAME>``, and its worker platform
    switch is ``RAY_TPU_TORCH_PLATFORM``."""
    src = jax_test_path(filename).read_text()
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
    src = src.replace("RAY_TPU_JAX_PLATFORM", "RAY_TPU_TORCH_PLATFORM")
    return re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", src)


def load_core_tests(filename: str, leave_out=None, replace=None,
                    edits=()) -> dict:
    """Compile ``tests/core/<filename>`` (or ``tests/serve/...`` for
    ``"serve/<file>"``) against the port and return the names a test
    file takes into its namespace: everything the module defines or
    imports, less the tests in ``leave_out`` (name -> why). ``replace``
    (name -> value) swaps a module-level helper that builds a JAX-side
    object for the port's counterpart, in the namespace the loaded
    bodies run in. ``edits`` are ``(old, new)`` source replacements made
    after the rename, where a body names a JAX dtype (each ``old`` must
    occur)."""
    path = jax_test_path(filename)
    src = port_source(filename)
    for old, new in edits:
        assert old in src, f"{filename} has no {old!r}"
        src = src.replace(old, new)
    tree = ast.parse(src, filename=str(path))
    tree = ast.fix_missing_locations(_TimeoutDefaults().visit(tree))
    prefix = "" if path.parent == JAX_CORE else path.parent.name + "_"
    name = "ray_tpu_torch_port_" + prefix + path.stem
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    cloudpickle.register_pickle_by_value(mod)
    leave_out = dict(leave_out or {})
    missing = (set(leave_out) | set(replace or {})) - set(vars(mod))
    assert not missing, f"{filename} has no {sorted(missing)}"
    vars(mod).update(replace or {})
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and k not in leave_out}


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    info = ray_tpu_torch.init(num_cpus=4, _num_initial_workers=2,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ray_start_shared():
    import ray_tpu_torch
    info = ray_tpu_torch.init(num_cpus=4, _num_initial_workers=2,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_session():
    import ray_tpu_torch
    from ray_tpu_torch import serve
    info = ray_tpu_torch.init(num_cpus=8, _num_initial_workers=3,
                              ignore_reinit_error=True)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture
def rlhf_cluster():
    import ray_tpu_torch
    info = ray_tpu_torch.init(num_cpus=8, _num_initial_workers=4,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ray_session():
    import ray_tpu_torch
    info = ray_tpu_torch.init(num_cpus=8, _num_initial_workers=3,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _port_metrics_registry_isolation():
    """The port's twin of tests/conftest.py's registry reset: metrics a
    test registers are dropped afterwards; the runtime catalog is pinned
    first so it is never dropped."""
    from ray_tpu_torch.core.metric_defs import runtime_metrics
    from ray_tpu_torch.util import metrics as mx
    runtime_metrics()
    mark = mx.registry_snapshot()
    yield
    mx.restore_registry(mark)


@pytest.fixture(autouse=True)
def _rlhf_devices_on_the_cpu(monkeypatch):
    """The RLHF learners and rollout engines that a loaded body builds
    with no device run on the CPU (their ``device=None`` is the card)."""
    import torch

    from ray_tpu_torch.serve import llm_engine
    monkeypatch.setattr(
        llm_engine, "_server_device",
        lambda device: torch.device("cpu" if device is None else device))


RLHF_ON_THE_CPU = {"_rlhf_devices_on_the_cpu": _rlhf_devices_on_the_cpu}


@pytest.fixture(autouse=True)
def _rllib_learners_on_the_cpu(monkeypatch):
    """The rllib learners that a loaded body builds in the test process
    with no device run on the CPU (their ``device=None`` is the card)."""
    import torch

    from ray_tpu_torch.rllib import learner
    inner = learner.learner_device
    monkeypatch.setattr(
        learner, "learner_device",
        lambda device=None: torch.device("cpu") if device is None
        else inner(device))


RLLIB_ON_THE_CPU = {"_rllib_learners_on_the_cpu": _rllib_learners_on_the_cpu,
                    "ray_session": ray_session}

FIXTURES = {"ray_start_regular": ray_start_regular,
            "ray_start_shared": ray_start_shared,
            "serve_session": serve_session,
            "rlhf_cluster": rlhf_cluster,
            "_port_metrics_registry_isolation":
                _port_metrics_registry_isolation}


@pytest.mark.parametrize("filename", sorted(
    p.name for p in JAX_CORE.glob("test_*.py")) + sorted(
    f"serve/{p.name}" for p in JAX_SERVE.glob("test_*.py")) + sorted(
    f"rlhf/{p.name}" for p in JAX_RLHF.glob("test_*.py")) + sorted(
    f"rllib/{p.name}" for p in JAX_RLLIB.glob("test_*.py")) + [
    "autoscaler/test_slices.py", "parallel/test_elastic.py",
    "train/test_trainer.py", "tune/test_tune.py", "tune/test_callbacks.py",
    "tune/test_new_schedulers.py", "dag/test_dag_workflow.py",
    "util/test_ray_client.py", "util/test_iter_misc.py",
    "dag/test_workflow_events.py", "util/test_state_metrics_mp.py",
    "util/test_joblib_logmon_env.py", "autoscaler/test_arbiter.py",
    "autoscaler/test_autoscaler_v2.py", "autoscaler/test_gce_launcher.py",
    "autoscaler/test_gce_transport.py", "autoscaler/test_gke_provider.py",
    "autoscaler/test_launcher_config.py",
    "autoscaler/test_colocation_e2e.py"] + sorted(
    f"data/{p.name}" for p in (JAX_TESTS / "data").glob("test_*.py")) + sorted(
    f"dashboard/{p.name}" for p in (JAX_TESTS / "dashboard").glob("test_*.py")))
def test_rewrite_leaves_no_jax_package_import(filename):
    """After the rewrite no import names the JAX package."""
    tree = ast.parse(port_source(filename))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert "ray_tpu" not in roots


def test_gets_and_waits_gain_a_timeout():
    src = ("ray_tpu_torch.get(r)\nray_tpu_torch.wait(rs, num_returns=1)\n"
           "ray_tpu_torch.get(r, timeout=5)\nray_tpu_torch.get(**kw)\n")
    out = ast.unparse(_TimeoutDefaults().visit(ast.parse(src)))
    assert out.splitlines() == [
        f"ray_tpu_torch.get(r, timeout={DEFAULT_TIMEOUT_S})",
        f"ray_tpu_torch.wait(rs, num_returns=1, timeout={DEFAULT_TIMEOUT_S})",
        "ray_tpu_torch.get(r, timeout=5)", "ray_tpu_torch.get(**kw)"]
