"""Tensors through the port's object store, against the JAX package's
serializer.

The same seeded numpy values go through ``ray_tpu``'s serializer as
``jax.Array`` and through ``ray_tpu_torch``'s as tensors, nested in a
tuple (the pickler's device-array hook) at sizes in band and out of
band: dtype, shape and bytes of what comes back are equal, and a tensor
comes back as a CPU tensor. Then the tensor kinds the port adds
(``nn.Parameter``, ``requires_grad``, non-contiguous, zero-size, 0-d,
inside a value that falls back to cloudpickle), the runtime's copy
semantics (a write into a ``get`` result reaches neither the store nor a
second ``get``), and a process that never imported torch.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core.serialization import SerializationContext as JaxContext
from ray_tpu_torch.core.serialization import (SerializationContext,
                                              holds_tensors)
from test_torch_runtime_loader import FIXTURES

globals().update(FIXTURES)

ROOT = Path(__file__).resolve().parent.parent
DTYPES = ("bfloat16", "float16", "float32", "float64", "int8", "int16",
          "int32", "int64", "uint8", "bool")
#: (name, shape): out of band (over the 4096-byte threshold even at one
#: byte an element), in band, zero-size
SHAPES = (("oob", (80, 64)), ("inband", (3, 5)), ("empty", (0, 7)))


def _numpy_value(dtype: str, shape, seed: int = 0):
    """A seeded numpy array; bf16 values are f32 the two packages round
    to bf16 each on their own."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype=dtype,
                            endpoint=True)
    src = "float32" if dtype == "bfloat16" else dtype
    return (rng.standard_normal(shape) * 100).astype(src)


def _round_trip(ctx, value):
    ser = ctx.serialize(value)
    out, _ = ctx.deserialize_from_view(memoryview(ser.to_bytes()))
    return out, ser


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


@pytest.mark.parametrize("shape_name,shape", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_round_trip_matches_the_jax_serializer(dtype, shape_name,
                                                      shape):
    value = _numpy_value(dtype, shape)
    with jax.enable_x64(True):
        ja = jnp.asarray(value).astype(dtype)
        jax_out, jax_ser = _round_trip(JaxContext(), (ja,))
    t = torch.from_numpy(value).to(getattr(torch, dtype))
    port_out, port_ser = _round_trip(SerializationContext(), (t,))
    got, want = port_out[0], jax_out[0]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert str(got.dtype) == f"torch.{want.dtype.name}"
    assert tuple(got.shape) == want.shape == shape
    assert _bytes(got) == _bytes(want) == _bytes(t)
    if shape_name == "oob":             # both ship the bytes out of band
        assert len(port_ser.buffers) == len(jax_ser.buffers) == 1
    else:
        assert len(port_ser.buffers) == 0
    assert port_ser.holds_tensors
    assert holds_tensors(memoryview(port_ser.to_bytes()))


def test_tensor_kinds_round_trip():
    """nn.Parameter stays a Parameter; requires_grad survives on a leaf;
    non-contiguous, zero-size and 0-d tensors keep shape and values; a
    value cloudpickle must carry (a lambda) still ships its tensor out of
    band."""
    ctx = SerializationContext()
    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, 96, generator=g)
    param = torch.nn.Parameter(base.clone())
    frozen = torch.nn.Parameter(base[:2].clone(), requires_grad=False)
    leaf = base.clone().requires_grad_(True)
    strided = base.t()[::2]
    value = {"param": param, "frozen": frozen, "leaf": leaf,
             "strided": strided, "empty": torch.zeros(0, 3),
             "scalar": torch.tensor(3.5, dtype=torch.float64),
             "nested": [(base[:1, :5].to(torch.bfloat16),)]}
    out, ser = _round_trip(ctx, value)
    assert type(out["param"]) is torch.nn.Parameter
    assert out["param"].requires_grad and torch.equal(out["param"], param)
    assert type(out["frozen"]) is torch.nn.Parameter
    assert not out["frozen"].requires_grad
    assert out["leaf"].requires_grad and out["leaf"].is_leaf
    assert torch.equal(out["leaf"], leaf)
    assert out["strided"].shape == strided.shape
    assert torch.equal(out["strided"], strided)
    assert out["empty"].shape == (0, 3)
    assert out["scalar"].shape == () and out["scalar"].item() == 3.5
    assert torch.equal(out["nested"][0][0], base[:1, :5].to(torch.bfloat16))
    assert len(ser.buffers) == 3     # param, leaf, strided: over 4096 bytes
    fn = (lambda: 1, base)
    out, ser = _round_trip(ctx, fn)
    assert out[0]() == 1 and torch.equal(out[1], base)
    assert len(ser.buffers) == 1
    # another layout goes through torch's reduce of a host copy, whose
    # index and value tensors come back through the tensor hook
    sparse = base.to_sparse()
    out, _ = _round_trip(ctx, {"s": sparse})
    assert out["s"].layout == torch.sparse_coo
    assert torch.equal(out["s"].to_dense(), base)


def test_a_restored_tensor_owns_its_bytes():
    """The restore copies out of the buffer it was given (the store's
    shared pages on a get): a write into the tensor leaves the buffer as
    it was."""
    ctx = SerializationContext()
    t = torch.arange(4096, dtype=torch.float32)
    wire = bytearray(ctx.serialize(t).to_bytes())
    before = bytes(wire)
    out, _ = ctx.deserialize_from_view(memoryview(wire))
    out += 1
    assert bytes(wire) == before
    again, _ = ctx.deserialize_from_view(memoryview(wire))
    assert torch.equal(again, t)


def test_a_write_into_a_get_result_reaches_no_second_get(ray_start_shared):
    """Small (inline) and large (shm) tensors, from ``put`` and as a task
    return: a second ``get`` of the same ref is unchanged after the first
    result was written to, and ``put`` copies its value."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def ones(n):
        return {"t": torch.ones(n), "n": n}

    for n in (16, 1 << 20):
        mine = torch.ones(n)
        refs = [ray_tpu_torch.put(mine), ones.remote(n)]
        mine += 5                       # after the put: not in the object
        for ref in refs:
            first = ray_tpu_torch.get(ref, timeout=60)
            t = first if isinstance(first, torch.Tensor) else first["t"]
            t += 1
            second = ray_tpu_torch.get(ref, timeout=60)
            s = second if isinstance(second, torch.Tensor) else second["t"]
            assert s.sum().item() == n, (n, ref)


def test_tensors_through_tasks_and_actors(ray_start_shared):
    """A tensor argument reaches a task as a CPU tensor of the same bits
    and comes back the same way, also through an actor."""
    import ray_tpu_torch

    def bits(t):
        return int(t.contiguous().view(torch.int16).sum(dtype=torch.int64))

    @ray_tpu_torch.remote
    def checksum(t):
        return t.dtype, tuple(t.shape), t.device.type, bits(t)

    @ray_tpu_torch.remote
    class Keeper:
        def __init__(self, t):
            self.t = t

        def double(self):
            return self.t * 2

    g = torch.Generator().manual_seed(1)
    t = torch.randn(300, 200, generator=g).to(torch.bfloat16)
    dtype, shape, dev, total = ray_tpu_torch.get(checksum.remote(t),
                                                 timeout=60)
    assert (dtype, shape, dev) == (torch.bfloat16, (300, 200), "cpu")
    assert total == bits(t)
    k = Keeper.remote(t)
    assert torch.equal(ray_tpu_torch.get(k.double.remote(), timeout=60),
                       t * 2)


def test_a_process_that_never_imported_torch_does_not_import_it():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from ray_tpu_torch.core.serialization import SerializationContext
        ctx = SerializationContext()
        value = {"a": np.arange(5000.0), "b": [1, "x", b"y" * 5000]}
        ser = ctx.serialize(value)
        out, _ = ctx.deserialize_from_view(memoryview(ser.to_bytes()))
        assert np.array_equal(out["a"], value["a"]) and not ser.holds_tensors
        assert "torch" not in sys.modules, "torch was imported"
        print("OK")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"
