"""Distributed progress bars (reference: ``python/ray/experimental/
tqdm_ray.py`` — workers emit structured progress records; the driver
renders them without interleaving worker stdout).

Worker side: ``tqdm_ray.tqdm(iterable, total=...)`` prints magic-token
JSON lines; they ride the normal worker-log stream. Driver side: the
log monitor recognizes the token and re-renders in place instead of
echoing raw lines.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Iterable, Iterator, Optional

MAGIC = "__ray_tpu_torch_tqdm__:"


class tqdm:
    """Minimal tqdm-compatible facade that emits progress records."""

    def __init__(self, iterable: Optional[Iterable] = None, *,
                 desc: str = "", total: Optional[int] = None,
                 position: int = 0, flush_interval_s: float = 0.2,
                 **_ignored: Any):
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.position = position
        self.n = 0
        self._flush_interval = flush_interval_s
        self._last_flush = 0.0
        self._emit()

    def __iter__(self) -> Iterator:
        assert self._iterable is not None
        for item in self._iterable:
            yield item
            self.update(1)
        self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last_flush >= self._flush_interval:
            self._emit()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._emit()

    def close(self) -> None:
        self._emit(final=True)

    def _emit(self, final: bool = False) -> None:
        self._last_flush = time.monotonic()
        rec = {"desc": self.desc, "n": self.n, "total": self.total,
               "pos": self.position, "final": final}
        print(MAGIC + json.dumps(rec), flush=True)


def render_record(line: str, out=None) -> bool:
    """Driver-side: if ``line`` is a tqdm record, render it and return
    True (the log monitor then suppresses the raw line)."""
    if MAGIC not in line:
        return False
    out = out or sys.stderr
    try:
        rec = json.loads(line.split(MAGIC, 1)[1])
    except (ValueError, IndexError):
        return False
    total = rec.get("total")
    n = rec.get("n", 0)
    desc = rec.get("desc") or "progress"
    if total:
        pct = 100.0 * n / max(total, 1)
        bar = ("#" * int(pct // 5)).ljust(20)
        print(f"\r{desc}: [{bar}] {n}/{total} ({pct:.0f}%)",
              end="\n" if rec.get("final") else "",
              file=out, flush=True)
    else:
        print(f"\r{desc}: {n} it", end="\n" if rec.get("final") else "",
              file=out, flush=True)
    return True
