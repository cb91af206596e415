"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` exposes a plain C interface. It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/ray_tpu_torch/`` at the repository root, at first use, and
loaded with :mod:`ctypes`. The library's file name carries a hash of
the source, of the ``csrc/*.cuh`` headers it includes and of the flags,
so an edited source or header builds anew and an unchanged one is built
once and then reused. Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources_of(src: Path) -> List[Path]:
    """``src`` and every file it includes with ``#include "..."`` from
    its own directory, recursively (the shared ``csrc/*.cuh`` headers)."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / name.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def _paths(source: str):
    """The source's path and its library's: the name carries a hash of
    the source, of every header it includes, and of the flags."""
    src = CSRC / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _compile(src: Path, lib_path: Path) -> Dict[str, object]:
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: a concurrent build wins
    return {"seconds": seconds, "log": proc.stdout + proc.stderr}


def build(sources) -> None:
    """Compile every source of ``csrc/`` named in ``sources`` that has no
    library yet, one ``nvcc`` process per source, all started together.
    Raises with nvcc's output if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {}
        for source in sources:
            src, lib_path = _paths(source)
            if source not in _loaded and not lib_path.exists():
                todo[source] = (src, lib_path)
        if not todo:
            return
        with ThreadPoolExecutor(len(todo)) as pool:
            futures = {s: pool.submit(_compile, *paths)
                       for s, paths in todo.items()}
        for source, fut in futures.items():
            build_logs[source] = fut.result()


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once (keyed by a hash of its text, its
    headers and the flags) and return the loaded library."""
    if source not in _loaded:
        build([source])
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(_paths(source)[1]))
        return _loaded[source]
