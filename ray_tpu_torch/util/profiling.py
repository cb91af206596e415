"""Profiling hooks: CPU stack sampling + memory profiling.

Reference: ``dashboard/modules/reporter/profile_manager.py`` —
``CpuProfilingManager`` shells out to py-spy (:79) and
``MemoryProfilingManager`` to memray (:188) against a worker PID.
Here the same surface: py-spy/memray are used when present (not baked
into the hermetic image); for the common "what is this process
doing" case a built-in pure-Python sampler profiles any process that
hosts a ray_tpu_torch runtime (sampling ``sys._current_frames`` — no
external tooling, works on the idle-host CI)."""

from __future__ import annotations

import collections
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple


def pyspy_available() -> bool:
    return shutil.which("py-spy") is not None


def memray_available() -> bool:
    try:
        import memray  # noqa: F401
        return True
    except ImportError:
        return False


def cpu_profile(pid: int, duration_s: float = 5.0,
                output_format: str = "flamegraph") -> bytes:
    """py-spy profile of an arbitrary PID (reference:
    ``profile_manager.py:79``). Gated: raises if py-spy is absent."""
    if not pyspy_available():
        raise RuntimeError(
            "py-spy is not installed in the hermetic image; add it "
            "to the image, or use sample_self() for in-process sampling")
    fmt = {"flamegraph": "flamegraph", "speedscope": "speedscope",
           "raw": "raw"}[output_format]
    out = subprocess.run(
        ["py-spy", "record", "-p", str(pid), "-d", str(int(duration_s)),
         "-f", fmt, "-o", "/dev/stdout"],
        capture_output=True, timeout=duration_s + 30)
    if out.returncode != 0:
        raise RuntimeError(f"py-spy failed: {out.stderr.decode()[-500:]}")
    return out.stdout


def memory_profile(pid: int, duration_s: float = 5.0) -> bytes:
    """memray attach (reference: ``profile_manager.py:188``)."""
    if not memray_available():
        raise RuntimeError(
            "memray is not installed in the hermetic image; add it "
            "to the image to enable memory profiling")
    out = subprocess.run(
        [sys.executable, "-m", "memray", "attach", str(pid),
         "--duration", str(int(duration_s))],
        capture_output=True, timeout=duration_s + 30)
    if out.returncode != 0:
        raise RuntimeError(f"memray failed: {out.stderr.decode()[-500:]}")
    return out.stdout


class StackSampler:
    """In-process sampling profiler over ``sys._current_frames()``:
    the zero-dependency fallback for "where is the time going" on any
    thread of this process. Produces collapsed-stack lines (the
    flamegraph.pl / speedscope-importable format)."""

    def __init__(self, interval_s: float = 0.01):
        self.interval_s = interval_s
        self._counts: Dict[Tuple[str, ...], int] = collections.Counter()
        self._nsamples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StackSampler":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="stack-sampler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval_s):
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack: List[str] = []
                f = frame
                while f is not None and len(stack) < 64:
                    code = f.f_code
                    stack.append(
                        f"{code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{code.co_name}")
                    f = f.f_back
                self._counts[tuple(reversed(stack))] += 1
            self._nsamples += 1

    def stop(self) -> "StackSampler":
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        return self

    @property
    def num_samples(self) -> int:
        return self._nsamples

    def collapsed(self) -> str:
        """One 'frame;frame;frame count' line per unique stack."""
        return "\n".join(
            ";".join(stack) + f" {n}"
            for stack, n in sorted(self._counts.items(),
                                   key=lambda kv: -kv[1]))

    def top(self, k: int = 10) -> List[Tuple[str, int]]:
        """Hottest leaf frames."""
        leaves: Dict[str, int] = collections.Counter()
        for stack, n in self._counts.items():
            if stack:
                leaves[stack[-1]] += n
        return sorted(leaves.items(), key=lambda kv: -kv[1])[:k]


def sample_self(duration_s: float = 1.0,
                interval_s: float = 0.01) -> StackSampler:
    """Convenience: sample this process for ``duration_s``."""
    s = StackSampler(interval_s).start()
    time.sleep(duration_s)
    return s.stop()
