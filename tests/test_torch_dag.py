"""``ray_tpu_torch.dag`` on the CPU: the JAX package's DAG and workflow
bodies of ``tests/dag/test_dag_workflow.py`` on the port, every one
(loaded by ``tests/test_torch_runtime_loader.py``;
``tests/dag/test_workflow_events.py`` is loaded by
``tests/test_torch_workflow.py``), the DAG's results against
``ray_tpu.dag``'s on the same inputs, tensors through a channel against
``put``/``get``, and a compiled two-stage chain over the port's
``stage_forward``/``stage_loss`` at ``gptj-tiny`` in f32 against the JAX
package's stage functions at 1e-5.
"""

import dataclasses
import glob
import threading

import numpy as np
import pytest
import torch

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("dag/test_dag_workflow.py"))
globals()["ray_session"] = ray_session

#: a DAG run on a runtime must finish within this
RUN_TIMEOUT_S = 180.0


def _run_on(pkg, fn):
    """``fn(pkg)`` on ``pkg``'s running runtime (this file's shared one),
    else on a fresh one shut down after it, failing if it has not
    returned within RUN_TIMEOUT_S."""
    own = not pkg.is_initialized()
    if own:
        pkg.init(num_cpus=4, _num_initial_workers=2)
    box = {}

    def run():
        try:
            box["out"] = fn(pkg)
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            box["err"] = e
    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(RUN_TIMEOUT_S)
        assert not t.is_alive(), \
            f"{fn.__name__} on {pkg.__name__} ran past {RUN_TIMEOUT_S} s"
        if "err" in box:
            raise box["err"]
        return box["out"]
    finally:
        if own:
            pkg.shutdown()


def _dags(pkg):
    """Functions, actors, input attributes and multiple outputs, each
    executed uncompiled and compiled, on ``pkg``'s runtime."""
    from importlib import import_module
    dag = import_module(pkg.__name__ + ".dag")
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(3, 4))

    @pkg.remote
    def scale(a, k):
        return a * k

    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    class Acc:
        def __init__(self, start):
            self.v = np.asarray(start, dtype=np.float64)

        def push(self, x):
            self.v = self.v + x
            return self.v.copy()

        def norm(self, x):
            return float(np.linalg.norm(x))

    out = {}
    with dag.InputNode() as inp:
        fn_dag = add.bind(scale.bind(inp, 3.0), inp)
    out["function"] = [pkg.get(fn_dag.execute(x), timeout=60) for x in xs]
    with dag.InputNode() as inp:
        attr_dag = add.bind(scale.bind(inp["a"], 2.0), inp.b)
    out["attributes"] = pkg.get(
        attr_dag.execute(a=xs[0], b=xs[1]), timeout=60)
    with dag.InputNode() as inp:
        acc = Acc.bind(xs[2])
        multi = dag.MultiOutputNode([acc.push.bind(inp),
                                     acc.push.bind(scale.bind(inp, -1.0))])
    out["multi"] = [pkg.get(r, timeout=60) for r in multi.execute(xs[0])]
    with dag.InputNode() as inp:
        chain = Acc.bind(0.0).norm.bind(Acc.bind(xs[1]).push.bind(inp))
    compiled = chain.experimental_compile()
    try:
        out["compiled"] = [pkg.get(compiled.execute(x), timeout=60)
                           for x in xs]
        out["pipeline"] = compiled._pipeline is not None
    finally:
        compiled.teardown()
    return out


def test_dag_results_equal_the_jax_package_s(ray_session):
    import ray_tpu
    import ray_tpu_torch
    want = _run_on(ray_tpu, _dags)
    got = _run_on(ray_tpu_torch, _dags)
    assert got["pipeline"] and want["pipeline"]
    np.testing.assert_array_equal(got["function"], want["function"])
    np.testing.assert_array_equal(got["attributes"], want["attributes"])
    np.testing.assert_array_equal(got["multi"], want["multi"])
    assert got["compiled"] == want["compiled"]


def _same(a, b):
    """Type, dtype, shape, device and bytes equal."""
    assert type(a) is type(b), (type(a), type(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    if isinstance(a, torch.Tensor):
        assert a.device == b.device == torch.device("cpu")
        assert torch.equal(a.detach().reshape(-1).view(torch.uint8),
                           b.detach().reshape(-1).view(torch.uint8))
        assert a.requires_grad == b.requires_grad
    else:
        assert a.tobytes() == b.tobytes()


def test_tensors_through_a_channel_arrive_as_get_gives_them(
        ray_session):
    """A dict of a bf16 tensor, an f32 ``nn.Parameter`` and a numpy
    array written through a channel reads back as the same object put
    through ``put``/``get``: type, dtype, shape, device and bytes."""
    import ray_tpu_torch
    from ray_tpu_torch.experimental.channel import Channel
    rng = np.random.default_rng(0)
    value = {"bf16": torch.tensor(rng.normal(size=(4, 6)),
                                  dtype=torch.bfloat16),
             "param": torch.nn.Parameter(torch.tensor(
                 rng.normal(size=(3,)), dtype=torch.float32)),
             "np": rng.normal(size=(2, 5)).astype(np.float32)}
    ch = Channel(capacity=1 << 16)
    r = ch.reader(0)
    try:
        ch.write(value, timeout=5)
        via_channel = r.read(timeout=5)
    finally:
        r.close()
        ch.destroy()
    via_store = ray_tpu_torch.get(ray_tpu_torch.put(value), timeout=60)
    assert set(via_channel) == set(via_store) == set(value)
    for k in value:
        _same(via_channel[k], via_store[k])


def _tiny_cfgs():
    from ray_tpu.models import get_config as jax_get_config
    from ray_tpu_torch.models import get_config
    import jax.numpy as jnp
    return (dataclasses.replace(jax_get_config("gptj-tiny"),
                                dtype=jnp.float32),
            dataclasses.replace(get_config("gptj-tiny"),
                                dtype=torch.float32))


def test_compiled_two_stage_chain_equals_jax_stage_functions(
        ray_session):
    """InputNode -> stage 0's forward -> stage 1's loss as a compiled
    DAG of two stage actors at gptj-tiny (2 layers, one a stage) in f32,
    the weights carried from a JAX init by ``params_from_jax``: the
    channel pipeline is built, each row's loss is within 1e-5 of JAX's
    ``stage_forward``/``stage_loss`` and its count equal, and no channel
    file is left after the teardown."""
    import jax
    import jax.numpy as jnp
    import ray_tpu_torch
    from ray_tpu.models import transformer as jt
    from ray_tpu_torch.dag import InputNode
    jcfg, tcfg = _tiny_cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)

    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, cfg, tree, s):
            from ray_tpu_torch._bridge import params_from_jax
            from ray_tpu_torch.models import transformer as tt
            self.cfg, self.s = cfg, s
            self.p = tt.stage_slice_params(
                cfg, params_from_jax(tree, cfg, "cpu"), s, 2)

        def forward(self, ids):
            from ray_tpu_torch.models import transformer as tt
            ids = torch.as_tensor(ids)
            with torch.inference_mode():
                return tt.stage_forward(self.cfg, 0, 2, self.p, ids), ids

        def loss(self, hop):
            from ray_tpu_torch.models import transformer as tt
            h, ids = hop
            with torch.inference_mode():
                h = tt.stage_forward(self.cfg, 1, 2, self.p, h)
                return tt.stage_loss(self.cfg, self.p, h, ids)

    with InputNode() as inp:
        dag = Stage.bind(tcfg, tree, 1).loss.bind(
            Stage.bind(tcfg, tree, 0).forward.bind(inp))
    compiled = dag.experimental_compile()
    rows = [np.random.default_rng(r).integers(
        0, jcfg.vocab_size, (1, 64)).astype(np.int32) for r in range(3)]
    try:
        refs = [compiled.execute(ids) for ids in rows]
        got = [ray_tpu_torch.get(r, timeout=120) for r in refs]
        assert compiled._pipeline is not None, "the RPC path was taken"
        chans = [ch.path for ch in compiled._pipeline.chans]
    finally:
        compiled.teardown()
    assert not [p for p in chans if glob.glob(p)]
    for ids, (loss, n) in zip(rows, got):
        hs = jnp.asarray(ids)
        for s in range(2):
            hs = jt.stage_forward(jcfg, s, 2,
                                  jt.stage_slice_params(jcfg, jp, s, 2), hs)
        jl, jn = jt.stage_loss(jcfg, jt.stage_slice_params(jcfg, jp, 1, 2),
                               hs, jnp.asarray(ids))
        assert loss.device.type == "cpu" and loss.dtype == torch.float32
        assert float(n) == float(jn)
        assert float(loss) == pytest.approx(float(jl), rel=1e-5, abs=1e-5)

