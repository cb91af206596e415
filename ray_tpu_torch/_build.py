"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` exposes a plain C interface. It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/ray_tpu_torch/`` at the repository root, at first use, and
loaded with :mod:`ctypes`. The library's file name carries a hash of
the source and the flags, so an edited source builds anew and an
unchanged one is built once and then reused. Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (the ``-Xptxas -v`` register and shared-memory report)
#: and the build seconds of each library built by this process
build_logs: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``. Raises if there is none."""
    candidates: List[str] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once (keyed by a hash of its text and
    the flags) and return the loaded library."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
        src = CSRC / source
        text = src.read_bytes()
        digest = hashlib.sha256(
            text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
        if not lib_path.exists():
            nvcc = find_nvcc()
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)   # atomic: a concurrent build wins
            build_logs[source] = {"seconds": seconds,
                                  "log": proc.stdout + proc.stderr}
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = lib
        return lib
