"""ctypes loader for the native store (builds on first use).

The C++ extension is optional: if g++ is unavailable the Python mmap
store is used. Set ``RAY_TPU_TORCH_NATIVE_STORE=0`` to force the fallback.
The library is built from this directory's ``store.cpp`` into
``build/ray_tpu_torch/`` at the repository root (ignored by git), never
beside the source, and the port never loads the JAX package's library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "store.cpp")
#: where the port's libraries are built (the CUDA ones too, _build.py)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "ray_tpu_torch")


def _lib_path() -> str:
    """Build artifact keyed by a source hash: editing store.cpp naturally
    invalidates the old binary (mtime comparison breaks under git checkout,
    which restores old mtimes), and no binary is ever committed."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libnativestore-{digest}.so")


_LIB_PATH = _lib_path()

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # Sanitizer-instrumented builds live in tests/core/test_store_sanitize.py
    # (a standalone stress binary over the same TU) — the loader builds
    # the production library only.
    # pid-unique temp output: concurrent builders (several node
    # managers starting at once) must not clobber each other mid-write.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC_PATH, "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if out.returncode != 0:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        return False
    os.replace(tmp, _LIB_PATH)
    # reap binaries for older source revisions (processes that still have
    # one mapped keep it alive via the inode; the name can go)
    cur = os.path.basename(_LIB_PATH)
    for name in os.listdir(BUILD_DIR):
        if name.startswith("libnativestore") and name.endswith(".so") \
                and name != cur:
            try:
                os.unlink(os.path.join(BUILD_DIR, name))
            except OSError:
                pass
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RAY_TPU_TORCH_NATIVE_STORE", "1") == "0":
            return None
        if not os.path.exists(_LIB_PATH):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.ns_create.restype = ctypes.c_void_p
        lib.ns_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint32]
        lib.ns_open.restype = ctypes.c_void_p
        lib.ns_open.argtypes = [ctypes.c_char_p]
        lib.ns_alloc.restype = ctypes.c_uint64
        lib.ns_alloc.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64]
        lib.ns_seal.restype = ctypes.c_uint64
        lib.ns_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ns_lookup.restype = ctypes.c_uint32
        lib.ns_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.ns_delete.restype = ctypes.c_uint64
        lib.ns_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ns_evict.restype = ctypes.c_uint64
        lib.ns_evict.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ns_acquire.restype = ctypes.c_uint32
        lib.ns_acquire.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.ns_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int32]
        lib.ns_release_all.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ns_reap.restype = ctypes.c_uint32
        lib.ns_reap.argtypes = [ctypes.c_void_p]
        lib.ns_recover.argtypes = [ctypes.c_void_p]
        lib.ns_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.ns_list.restype = ctypes.c_uint32
        lib.ns_list.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32]
        lib.ns_base.restype = ctypes.c_void_p
        lib.ns_largest_free.restype = ctypes.c_uint64
        lib.ns_largest_free.argtypes = [ctypes.c_void_p]
        lib.ns_compact.restype = ctypes.c_uint64
        lib.ns_compact.argtypes = [ctypes.c_void_p]
        lib.ns_base.argtypes = [ctypes.c_void_p]
        lib.ns_total_size.restype = ctypes.c_uint64
        lib.ns_total_size.argtypes = [ctypes.c_void_p]
        lib.ns_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
