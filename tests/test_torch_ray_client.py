"""The JAX package's ``tests/util/test_ray_client.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): a process that
is not part of the cluster drives it through ``ray_tpu_torch.init(
"ray://...")``, with put/get/wait, tasks with client refs as arguments,
``num_returns``, actors, decorators made before ``init``, introspection,
gets outliving the connection's timeout (``slow``) and the leases a
disconnect releases.

The JAX fixture ``client_server`` binds port 10055 whatever it asks
for (``port=0 or 10055``), which a run can find taken and which the JAX
file itself holds while this one runs beside it: this file's own fixture
binds port 0 and yields the address the server bound.

Tensors cross the client's wire through the object store's tensor hook:
``test_tensors_cross_the_client_wire_as_get_gives_them``.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("util/test_ray_client.py"))


@pytest.fixture
def client_server(ray_start_shared):
    from ray_tpu_torch.util.client import ClientServer
    srv = ClientServer(host="127.0.0.1", port=0).start()
    yield f"ray://127.0.0.1:{srv.port}"
    srv.stop()


TENSOR_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import ray_tpu_torch
    ray_tpu_torch.init({addr!r})
    rng = np.random.default_rng(0)
    sent = {{"bf16": torch.tensor(rng.normal(size=(3, 5)),
                                  dtype=torch.bfloat16),
             "p": torch.nn.Parameter(torch.tensor(
                 rng.normal(size=4), dtype=torch.float32)),
             "i": torch.arange(7, dtype=torch.int64)}}

    def same(a, b):
        return (type(a) is type(b) and a.dtype == b.dtype
                and a.shape == b.shape and a.device.type == "cpu"
                and a.reshape(-1).view(torch.uint8).tolist()
                == b.detach().reshape(-1).view(torch.uint8).tolist())

    got = ray_tpu_torch.get(ray_tpu_torch.put(sent), timeout=60)
    assert all(same(got[k], sent[k]) for k in sent), got

    @ray_tpu_torch.remote
    def echo(tree):
        return {{k: (str(v.device), v) for k, v in tree.items()}}

    back = ray_tpu_torch.get(echo.remote(sent), timeout=60)
    assert all(back[k][0] == "cpu" and same(back[k][1], sent[k])
               for k in sent), back
    ray_tpu_torch.shutdown()
    print("TENSORS-OK")
""")


def test_tensors_cross_the_client_wire_as_get_gives_them(client_server):
    """A bf16 tensor, an f32 ``nn.Parameter`` and an int64 tensor put
    through the client and got back, and passed as a task's argument,
    arrive each with its type, dtype, shape and bits, on the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", TENSOR_SCRIPT.format(repo=repo,
                                                    addr=client_server)],
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "TENSORS-OK" in proc.stdout
