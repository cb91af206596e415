"""The JAX package's ``tests/autoscaler/test_slices.py`` bodies on the
port's slice manager (``ray_tpu_torch.autoscaler``), loaded by
``tests/test_torch_runtime_loader.py``: the topology math, the slice gang
bundle planner of the port's scheduler, the pure scaling planner, the
in-memory ``FakeSliceProvider`` and the ``SliceManager`` lifecycle against
a stub controller. ``tests/autoscaler/test_slice_e2e.py`` (slow in the
JAX package) is not loaded: its non-slow twins are in
``tests/test_torch_scripts_cli.py``. Also: the fake providers start the
port's node manager with a host's ``GPU`` count."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("autoscaler/test_slices.py"))


def test_fake_hosts_start_the_ports_node_with_their_gpus(monkeypatch,
                                                         tmp_path):
    """``_launch_local_node`` runs ``python -m ray_tpu_torch.core.node``,
    a host's ``GPU`` count as ``--num-gpus``, a ``TPU`` entry as a plain
    custom resource."""
    import json
    import subprocess

    from ray_tpu_torch.autoscaler import node_provider
    seen = {}

    def fake_popen(cmd, **kw):
        seen["cmd"] = cmd
        return None
    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    node_provider._launch_local_node(
        str(tmp_path), {"CPU": 2, "GPU": 0.5, "TPU": 4}, {"k": "v"},
        "ab" * 28, "host0")
    cmd = seen["cmd"]
    assert cmd[1:3] == ["-m", "ray_tpu_torch.core.node"]
    assert cmd[cmd.index("--num-cpus") + 1] == "2"
    assert cmd[cmd.index("--num-gpus") + 1] == "0.5"
    assert json.loads(cmd[cmd.index("--resources") + 1]) == {"TPU": 4}
    assert "--num-tpus" not in cmd
