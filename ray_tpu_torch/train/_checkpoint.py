"""Checkpoint: a directory snapshot addressed by path, the port of
``ray_tpu/train/_checkpoint.py``.

Reference: ``python/ray/train/_checkpoint.py:56``. ``from_torch`` /
``to_torch`` are the port's counterparts of the JAX package's
``from_jax`` / ``to_jax`` and write the same files: the tree's leaves as
``leaf_<i>`` arrays of ``_pytree.npz`` in JAX's flatten order (dict keys
sorted, lists in order), and its structure as a pickled JAX ``PyTreeDef``
in ``_treedef.pkl``. The port writes and reads that pickle without JAX
(:func:`_dump_treedef`, :func:`_load_treedef`), so a checkpoint written
by either package reads in the other. Trees are nested dicts, lists,
tuples and ``None``; leaves come back as CPU tensors.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import shutil
import struct
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

_METADATA_FILE = ".metadata.json"
_PYTREE_FILE = "_pytree.npz"
_TREEDEF_FILE = "_treedef.pkl"

# JAX's pytree node kinds, and where its pickled treedef names its class
# and registry (jaxlib 0.9)
_LEAF, _NONE, _TUPLE, _LIST, _DICT = 0, 1, 2, 4, 5
_TREEDEF_CLASS = ("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY = ("jax._src.tree_util", "default_registry")


def _flatten(tree) -> Tuple[List[Any], List[tuple]]:
    """JAX's flatten: the leaves, and the post-order node records
    ``(kind, arity, node_data, None, num_leaves, num_nodes)`` its
    ``PyTreeDef`` pickles."""
    leaves: List[Any] = []
    nodes: List[tuple] = []

    def walk(t) -> Tuple[int, int]:
        if t is None:
            nodes.append((_NONE, 0, None, None, 0, 1))
            return 0, 1
        if isinstance(t, dict):
            keys = sorted(t)
            kind, data, kids = _DICT, keys, [t[k] for k in keys]
        elif isinstance(t, list):
            kind, data, kids = _LIST, None, t
        elif isinstance(t, tuple):
            kind, data, kids = _TUPLE, None, list(t)
        else:
            leaves.append(t)
            nodes.append((_LEAF, 0, None, None, 1, 1))
            return 1, 1
        n_leaves, n_nodes = 0, 1
        for kid in kids:
            a, b = walk(kid)
            n_leaves, n_nodes = n_leaves + a, n_nodes + b
        nodes.append((kind, len(kids), data, None, n_leaves, n_nodes))
        return n_leaves, n_nodes

    walk(tree)
    return leaves, nodes


def _unflatten(nodes: List[tuple], leaves: List[Any]):
    """The tree of post-order ``nodes`` over ``leaves``."""
    it = iter(leaves)
    stack: List[Any] = []
    for kind, arity, data, _custom, _nl, _nn in nodes:
        if kind == _LEAF:
            stack.append(next(it))
            continue
        kids = stack[len(stack) - arity:]
        del stack[len(stack) - arity:]
        if kind == _NONE:
            stack.append(None)
        elif kind == _DICT:
            stack.append(dict(zip(data, kids)))
        elif kind == _LIST:
            stack.append(list(kids))
        elif kind == _TUPLE:
            stack.append(tuple(kids))
        else:
            raise ValueError(f"unsupported pytree node kind {kind}")
    return stack[0]


def _dump_treedef(nodes: List[tuple]) -> bytes:
    """The pickle JAX writes for a ``PyTreeDef`` of these nodes:
    ``PyTreeDef.__new__`` then ``__setstate__((default_registry,
    nodes))``, written opcode by opcode so that JAX is not imported."""
    out = io.BytesIO()

    def obj(x):
        if x is None:
            out.write(b"N")
        elif isinstance(x, int):
            out.write(b"J" + struct.pack("<i", x))
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            out.write(b"X" + struct.pack("<I", len(raw)) + raw)
        elif isinstance(x, list):
            out.write(b"](")
            for v in x:
                obj(v)
            out.write(b"e")
        elif isinstance(x, tuple):
            out.write(b"(")
            for v in x:
                obj(v)
            out.write(b"t")
        else:
            raise TypeError(f"cannot write a treedef holding {x!r}")

    def global_(module: str, name: str):
        out.write(b"c" + module.encode() + b"\n" + name.encode() + b"\n")

    out.write(b"\x80\x04")
    global_(*_TREEDEF_CLASS)
    out.write(b")\x81")
    global_(*_REGISTRY)
    obj(list(nodes))
    out.write(b"\x86b.")
    return out.getvalue()


class _TreeDefState:
    def __setstate__(self, state):
        self.nodes = list(state[1])


class _TreeDefUnpickler(pickle.Unpickler):
    """Reads JAX's pickled ``PyTreeDef`` without importing JAX: its class
    and registry resolve to stand-ins that keep the node records, and no
    other global is loaded."""

    def find_class(self, module, name):
        if name == _TREEDEF_CLASS[1] and module.endswith("pytree"):
            return _TreeDefState
        if (module, name) == _REGISTRY:
            return None
        raise pickle.UnpicklingError(
            f"a treedef names {module}.{name}, not a JAX PyTreeDef")


def _load_treedef(raw: bytes) -> List[tuple]:
    return _TreeDefUnpickler(io.BytesIO(raw)).load().nodes


def _read_member(path: str, info):
    """One stored member of an ``np.savez`` file: its ``.npy`` header
    parsed in place, its data read with one ``fromfile``, the whole
    member checked against the archive's CRC-32 (as ``zipfile`` checks
    it). ``np.savez`` writes nothing else: a compressed member, an
    object array or a header of another version is refused."""
    import zipfile
    import zlib

    import numpy as np
    from numpy.lib import format as npf
    readers = {(1, 0): npf.read_array_header_1_0,
               (2, 0): npf.read_array_header_2_0}
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"{info.filename}: no local header")
        start = info.header_offset + 30 + int.from_bytes(
            local[26:28], "little") + int.from_bytes(local[28:30], "little")
        if info.compress_type != zipfile.ZIP_STORED:
            raise zipfile.BadZipFile(f"{info.filename}: compressed")
        f.seek(start)
        version = npf.read_magic(f)
        if version not in readers:
            raise zipfile.BadZipFile(f"{info.filename}: .npy {version}")
        shape, fortran, dtype = readers[version](f)
        if dtype.hasobject:
            raise zipfile.BadZipFile(f"{info.filename}: an object array")
        head = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(head))
        count = int(np.prod(shape))
        arr = np.fromfile(f, dtype=dtype, count=count)
    if arr.size != count:
        raise zipfile.BadZipFile(f"{info.filename}: truncated")
    if zlib.crc32(memoryview(arr).cast("B"), crc) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)


def _read_npz(path: str) -> Dict[str, Any]:
    """Every array of an ``np.savez`` file by name, several members read
    at once (``np.load`` reads a member 256 KiB at a time through
    ``zipfile``; the reads and the CRC sums here release the GIL)."""
    import zipfile
    from concurrent.futures import ThreadPoolExecutor
    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
    with ThreadPoolExecutor(max_workers=min(8, max(1, len(infos)))) as ex:
        arrays = list(ex.map(lambda i: _read_member(path, i), infos))
    return {i.filename[:-len(".npy")]: a for i, a in zip(infos, arrays)}


class Checkpoint:
    """A directory snapshot. ``path`` is the canonical location."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.path.expanduser(path))

    # -- construction -------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        with open(os.path.join(d, "dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    @classmethod
    def from_torch(cls, tree: Any, **extra: Any) -> "Checkpoint":
        """Save a tree of tensors (or numpy arrays) as npz + treedef, in
        the files the JAX package's ``from_jax`` writes."""
        import numpy as np
        import torch
        d = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        leaves, nodes = _flatten(tree)
        arrays = {f"leaf_{i}": (leaf.detach().cpu().numpy()
                                if isinstance(leaf, torch.Tensor)
                                else np.asarray(leaf))
                  for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(d, _PYTREE_FILE), **arrays)
        with open(os.path.join(d, _TREEDEF_FILE), "wb") as f:
            f.write(_dump_treedef(nodes))
        if extra:
            with open(os.path.join(d, "dict_checkpoint.pkl"), "wb") as f:
                pickle.dump(extra, f)
        return cls(d)

    # -- materialization ----------------------------------------------
    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        # Local checkpoints are served in place, zero-copy.
        yield self.path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def to_torch(self) -> Any:
        """The saved tree (by ``from_torch`` or the JAX package's
        ``from_jax``) with CPU tensor leaves."""
        import torch
        data = _read_npz(os.path.join(self.path, _PYTREE_FILE))
        leaves = [torch.from_numpy(data[f"leaf_{i}"])
                  for i in range(len(data))]
        with open(os.path.join(self.path, _TREEDEF_FILE), "rb") as f:
            nodes = _load_treedef(f.read())
        return _unflatten(nodes, leaves)

    # -- metadata -----------------------------------------------------
    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        m = self.get_metadata()
        m.update(metadata)
        self.set_metadata(m)

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))
