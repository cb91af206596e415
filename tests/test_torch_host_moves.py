"""Moves of state through the host, on the CPU.

The native store's populate where ``madvise`` cannot populate (kernels
before 5.14 and gVisor's answer EINVAL): the extent's whole pages are
mapped again in place with ``MAP_POPULATE``, and what a writer puts
there a reader in another process gets back bit for bit, the
neighbouring extents untouched. The int8 weight wire: a payload
unpacked on a device gives the tensors the host's unpack gives.
"""

import ctypes
import errno
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ray_tpu_torch import _native
from ray_tpu_torch._bridge import params_from_jax, to_numpy
from ray_tpu_torch.core import native_store
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.models import get_config, init_params
from ray_tpu_torch.rlhf.weight_sync import pack_weights, unpack_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoPopulate:
    """A libc whose madvise cannot populate: EINVAL, as under gVisor."""

    def __init__(self, libc):
        self.mmap = libc.mmap

    def madvise(self, *args):
        ctypes.set_errno(errno.EINVAL)
        return -1


@pytest.fixture
def no_madvise(monkeypatch):
    monkeypatch.setattr(native_store, "_libc",
                        _NoPopulate(native_store._libc))
    monkeypatch.setattr(native_store, "_madvise_populates", None)


def _pattern(i: int, n: int) -> np.ndarray:
    return ((np.arange(n, dtype=np.uint64) * (2 * i + 3) + i) % 251
            ).astype(np.uint8)


# sizes over the 1 MiB populate threshold, none a multiple of a page, so
# that extents share their edge pages with their neighbours
SIZES = [(1 << 20) + 4099, (3 << 20) + 17, (2 << 20) + 8191]

_READER = textwrap.dedent("""
    import ctypes, errno, sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from ray_tpu_torch.core import native_store
    from ray_tpu_torch.core.ids import ObjectID
    class NoPopulate:
        def __init__(self, libc):
            self.mmap = libc.mmap
        def madvise(self, *a):
            ctypes.set_errno(errno.EINVAL)
            return -1
    if {stub}:
        native_store._libc = NoPopulate(native_store._libc)
    client = native_store.NativeShmClient({name!r})
    for i, (hexid, n) in enumerate({objects!r}):
        view = client.get_view(ObjectID.from_hex(hexid), timeout=5.0)
        want = ((np.arange(n, dtype=np.uint64) * (2 * i + 3) + i) % 251
                ).astype(np.uint8)
        assert bytes(view) == want.tobytes(), i
        del view
        client.release(ObjectID.from_hex(hexid))
    assert native_store._madvise_populates is not {stub}
    client.close()
    print("READ OK")
""")


@pytest.mark.skipif(_native.load() is None, reason="no native store build")
def test_the_store_populates_in_place_where_madvise_cannot(no_madvise):
    name = f"raytorch-populate-{os.getpid()}"
    store = native_store.NativeShmStore(name, 64 << 20)
    client = native_store.NativeShmClient(name)
    try:
        objects = []
        for i, n in enumerate(SIZES):
            oid = ObjectID.from_random()
            view = client.create(oid, n)
            view[:] = _pattern(i, n).tobytes()
            del view
            client.seal(oid)
            store.on_sealed(oid, n)
            objects.append((oid.hex(), n))
        assert native_store._madvise_populates is False
        # the writer's own views, read after every neighbour's populate
        for i, (hexid, n) in enumerate(objects):
            view = client.get_view(ObjectID.from_hex(hexid), timeout=5.0)
            assert bytes(view) == _pattern(i, n).tobytes(), i
            del view
            client.release(ObjectID.from_hex(hexid))
        # a reader that populates in place too, and one whose madvise
        # populates (where it can: else its pages fault lazily), which
        # sees the file itself
        for stub in (True, False):
            out = subprocess.run(
                [sys.executable, "-c", _READER.format(
                    repo=REPO, name=name, objects=objects, stub=stub)],
                capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr
            assert "READ OK" in out.stdout
    finally:
        client.close()
        store.destroy()


def test_a_payload_unpacked_on_a_device_gives_the_hosts_tensors():
    cfg = get_config("gptj-tiny")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    packed = pack_weights(to_numpy(params), 2, 64)
    host = params_from_jax(unpack_weights(packed)[0], cfg, "cpu")
    tree, version = unpack_weights(packed, torch.device("cpu"))
    dev = params_from_jax(tree, cfg, "cpu")
    assert version == 2

    def flat(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + "/")
            else:
                yield pre + k, v
    want, got = dict(flat(host)), dict(flat(dev))
    assert list(want) == list(got) and len(want) > 5
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
