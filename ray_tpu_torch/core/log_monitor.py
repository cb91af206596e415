"""Log monitor: stream worker/job output to the driver terminal.

Reference: ``python/ray/_private/log_monitor.py:103`` — the LogMonitor
daemon tails per-worker log files and publishes lines; drivers print
them prefixed with the producing worker. Here the driver tails the
session's log directory directly (one host owns a session's logs; no
pubsub hop needed) with the same visible behavior:
``(worker-ab12cd pid=N)`` prefixes, new files picked up as workers
start, rotation-safe via inode checks.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from typing import Dict, Optional, TextIO

_WORKER_RE = re.compile(r"(worker|job)-([0-9a-f-]+)\.(out|log)$")


class LogMonitor:
    def __init__(self, session_dir: str, out: Optional[TextIO] = None,
                 poll_s: float = 0.5):
        self.log_dir = os.path.join(session_dir, "logs")
        self.out = out or sys.stderr
        self.poll_s = poll_s
        self._offsets: Dict[str, int] = {}   # path -> bytes consumed
        self._inodes: Dict[str, int] = {}
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # existing content predates this driver: start at EOF, stream
        # only what happens from now on (reference behavior)
        self._scan(seed_only=True)
        self._thread = threading.Thread(
            target=self._loop, name="log-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._scan()  # final drain so short-lived workers aren't lost

    def _loop(self) -> None:
        while not self._stopped.wait(self.poll_s):
            try:
                self._scan()
            except Exception:
                pass

    def _scan(self, seed_only: bool = False) -> None:
        try:
            names = os.listdir(self.log_dir)
        except FileNotFoundError:
            return
        for name in names:
            m = _WORKER_RE.search(name)
            if not m:
                continue
            path = os.path.join(self.log_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if self._inodes.get(path) != st.st_ino:
                # new or rotated file
                self._inodes[path] = st.st_ino
                self._offsets[path] = st.st_size if seed_only else 0
            if seed_only:
                continue
            off = self._offsets.get(path, 0)
            if st.st_size <= off:
                continue
            prefix = f"({m.group(1)}-{m.group(2)[:8]})"
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(1 << 20)
            except OSError:
                continue
            # consume whole lines only; a partial tail waits for more —
            # unless the window is full with no newline at all (a giant
            # single line), which must be flushed as-is or the file's
            # tail would stall at this offset forever
            cut = chunk.rfind(b"\n")
            if cut < 0:
                if len(chunk) < (1 << 20):
                    continue
                consumed = len(chunk)
                text = chunk.decode(errors="replace")
            else:
                consumed = cut + 1
                text = chunk[:cut].decode(errors="replace")
            self._offsets[path] = off + consumed
            for line in text.splitlines():
                if "__ray_tpu_torch_tqdm__:" in line:
                    from ray_tpu_torch.experimental.tqdm_ray import render_record
                    if render_record(line, self.out):
                        continue
                print(f"{prefix} {line}", file=self.out)
