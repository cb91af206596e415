"""The port's native store: the write rate of one object and the read
rate of it from another process, with the pages left to fault lazily
and with ``core/native_store.py::_populate``, twice each; the bits are
checked. Prints the kernel's release and whether madvise populates.

Run from the repository root: ``python3 store_probe.py [MiB]`` (1024 by
default); ``FORCE_REMAP=1`` stubs madvise to fail as it does under
gVisor, so that the in-place ``MAP_POPULATE`` path runs on any kernel.
"""
import os, subprocess, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ray_tpu_torch.core import native_store as ns
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.shm_store import make_client, make_store

class _NoPopulate:
    """libc whose madvise cannot populate (EINVAL), as under gVisor."""
    def __init__(self, libc):
        self.mmap = libc.mmap
    def madvise(self, *a):
        import ctypes, errno
        ctypes.set_errno(errno.EINVAL)
        return -1

def read_side(name, oid_hex, mode, n, force):
    if mode == "lazy":
        ns._populate = lambda *a, **k: None
    if force:
        ns._libc = _NoPopulate(ns._libc)
    c = make_client(name)
    t0 = time.perf_counter()
    v = c.get_view(ObjectID.from_hex(oid_hex), timeout=5.0)
    t1 = time.perf_counter()
    out = np.frombuffer(v, np.uint8).copy()
    t2 = time.perf_counter()
    ok = int(out[::4093].sum())
    del v
    c.release(ObjectID.from_hex(oid_hex)); c.close()
    print(f"READ {mode} view {t1-t0:.3f}s copy-out {n/(t2-t0)/1e9:.2f}GB/s check {ok}", flush=True)

if len(sys.argv) > 2 and sys.argv[1] == "read":
    read_side(sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]), sys.argv[6] == "1")
    sys.exit(0)
mib = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
force = os.environ.get("FORCE_REMAP") == "1"
n = mib << 20
if force:
    ns._libc = _NoPopulate(ns._libc)
src = (np.arange(n, dtype=np.uint64) % 251).astype(np.uint8)
want = int(src[::4093].sum())
name = f"storeprobe-{os.getpid()}"
store = make_store(name, 6 * n + (256 << 20))
client = make_client(name)
print("kernel", os.uname().release, flush=True)
print("store", type(store).__name__, type(client).__name__, "want", want, "force", force, flush=True)
real = ns._populate
try:
    for mode in ("lazy", "populate", "lazy", "populate"):
        ns._populate = (lambda *a, **k: None) if mode == "lazy" else real
        client._populated.clear()
        oid = ObjectID.from_random()
        t0 = time.perf_counter()
        view = client.create(oid, n)
        t1 = time.perf_counter()
        view[:] = memoryview(src)
        t2 = time.perf_counter()
        del view
        client.seal(oid); store.on_sealed(oid, n)
        print(f"WRITE {mode} create {t1-t0:.3f}s total {n/(t2-t0)/1e9:.2f}GB/s "
              f"madvise_populates={ns._madvise_populates}", flush=True)
        r = subprocess.run([sys.executable, __file__, "read", name, oid.hex(), mode, str(n), "1" if force else "0"],
                           capture_output=True, text=True)
        print(r.stdout.strip(), r.stderr.strip()[-2000:], flush=True)
        assert str(want) in r.stdout, "bits differ"
finally:
    ns._populate = real
    client.close(); store.destroy()
