"""A TR1-sized checkpoint read back on this host three ways: the port's
``Checkpoint.to_torch`` reader (each stored member with one ``fromfile``,
its CRC-32 checked, 8 members at once), the same members through
``zipfile`` and ``numpy.lib.format.read_array`` in 8 threads, and
``np.load``; two rounds, alternating, the page cache warm after the
write. The file is GPT-J-6B's params at 2 layers, three times (params
and Adam moments, f32), written by ``np.savez`` as ``from_torch``
writes it; the arrays read are checked against what was written.

Run from the repository root: ``python3 checkpoint_probe.py [layers]``
(2 by default).
"""
import os, shutil, subprocess, sys, tempfile, time, zipfile
from concurrent.futures import ThreadPoolExecutor
import numpy as np
from numpy.lib import format as npf
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ray_tpu_torch.models import get_config
from ray_tpu_torch.models.transformer import param_shapes
from ray_tpu_torch.train._checkpoint import _read_npz


def zipfile_threads(path):
    def read(name):
        with zipfile.ZipFile(path) as z, z.open(name) as f:
            return npf.read_array(f, allow_pickle=False)
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    with ThreadPoolExecutor(max_workers=8) as ex:
        return dict(zip([n[:-4] for n in names], ex.map(read, names)))


def np_load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def leaves(tree, out):
    for v in tree.values():
        leaves(v, out) if isinstance(v, dict) else out.append(v)
    return out


def main():
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    except FileNotFoundError:
        print("no nvidia-smi", flush=True)
    shapes = leaves(param_shapes(get_config("gptj-6b", n_layers=layers)), [])
    arrays = {f"leaf_{k * len(shapes) + i}":
              np.full(s, k + i * 1e-3, np.float32)
              for k in range(3) for i, s in enumerate(shapes)}
    d = tempfile.mkdtemp(prefix="checkpoint_probe_")
    try:
        path = os.path.join(d, "_pytree.npz")
        t0 = time.perf_counter()
        np.savez(path, **arrays)
        gb = os.path.getsize(path) / 1e9
        print(f"members {len(arrays)} gb {gb:.3f} "
              f"write_s {time.perf_counter() - t0:.3f}", flush=True)
        for rnd in range(2):
            for name, read in (("to_torch_fromfile", _read_npz),
                               ("zipfile_threads", zipfile_threads),
                               ("np_load", np_load)):
                t0 = time.perf_counter()
                got = read(path)
                s = time.perf_counter() - t0
                ok = sorted(got) == sorted(arrays) and all(
                    got[k].shape == a.shape and got[k].flat[-1] == a.flat[-1]
                    for k, a in arrays.items())
                print(f"round {rnd} {name} s {s:.3f} gb_per_s {gb / s:.3f} "
                      f"ok {ok}", flush=True)
                if not ok:
                    sys.exit(1)
                del got
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
