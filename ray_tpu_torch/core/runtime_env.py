"""Runtime environments: per-task/actor execution context.

Reference: ``python/ray/_private/runtime_env/agent/runtime_env_agent.py``
:161 — the agent materializes ``working_dir``/``py_modules`` packages
into a content-addressed URI cache with reference-counted GC, plus
``pip``/``conda`` env builds. TPU-native subset: the image is hermetic
(pip/conda installs at task time would desync a pod's hosts), so those
raise up front; ``working_dir`` and ``py_modules`` are packaged into a
content-hashed cache under the session dir shared by every node on the
host, and workers mount them onto ``sys.path``. ``env_vars`` pass
through.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import sys
from typing import Any, Dict, Optional

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
#: staging dirs end with ".tmp-<pid>-<hex8>" (see _package_dir); a
#: substring test would misclassify cache entries whose SOURCE dir
#: happened to contain ".tmp-" in its name
_STAGING_RE = re.compile(r"\.tmp-\d+-[0-9a-f]{8}$")
_MAX_PACKAGE_BYTES = 512 << 20

#: options the reference supports that a hermetic image must reject
#: loudly rather than silently ignore
_UNSUPPORTED = ("pip", "conda", "container", "uv")


def _hash_dir(path: str) -> str:
    """Digest of the tree's CONTENTS (a size+mtime digest would serve
    stale cache hits for same-length rewrites within one clock second)."""
    h = hashlib.sha256()
    total = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for name in sorted(files):
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            h.update(rel.encode())
            try:
                with open(fp, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        total += len(chunk)
                        if total > _MAX_PACKAGE_BYTES:
                            raise ValueError(
                                f"runtime_env package {path!r} exceeds "
                                f"{_MAX_PACKAGE_BYTES >> 20} MiB")
                        h.update(chunk)
            except OSError:
                continue
    return h.hexdigest()[:16]


def _cache_root(session_dir: str) -> str:
    return os.path.join(session_dir, "runtime_resources")


def _touch(path: str) -> None:
    """Refresh a cache entry's LRU stamp (gc_cache orders by mtime)."""
    try:
        os.utime(path, None)
    except OSError:
        pass


def _package_dir(session_dir: str, src: str, wrap: bool = False) -> str:
    """Copy ``src`` into the content-addressed cache (no-op when the
    same content is already cached — reference: URI cache hits).

    ``wrap=True`` (py_modules) nests the copy one level deep under its
    own basename so putting the RETURNED path on ``sys.path`` makes
    ``import <basename>`` work, matching Ray's documented semantics."""
    import uuid
    src = os.path.abspath(src)
    if not os.path.isdir(src):
        raise ValueError(f"runtime_env path {src!r} is not a directory")
    digest = _hash_dir(src)
    name = os.path.basename(src.rstrip("/"))
    # wrapped (py_modules) and unwrapped (working_dir) layouts of the
    # same tree are distinct cache entries — keying on content alone
    # would serve whichever layout was cached first to both consumers
    layout = "mod" if wrap else "dir"
    dest = os.path.join(
        _cache_root(session_dir), f"{name}-{digest}-{layout}")
    if os.path.isdir(dest):
        # bump the entry's LRU stamp: copytree preserved the SOURCE
        # tree's mtime, and gc_cache orders by mtime, so without an
        # explicit touch a live entry can be evicted as "oldest"
        _touch(dest)
    else:
        # unique staging dir: concurrent preparers of the same env must
        # not rmtree/copytree over each other's half-written trees
        tmp = f"{dest}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        target = os.path.join(tmp, name) if wrap else tmp
        shutil.copytree(
            src, target,
            ignore=shutil.ignore_patterns(*_EXCLUDE_DIRS, "*.pyc"))
        # copystat gave the staging root the SOURCE's mtime — restamp it
        # so a concurrent gc_cache can't mistake it for an orphan
        _touch(tmp)
        try:
            os.replace(tmp, dest)
        except OSError:
            # either a concurrent preparer won the race with identical
            # content (fine), or the staging tree was lost (not fine —
            # returning a path that doesn't exist would make workers
            # silently skip the mount)
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):
                raise RuntimeError(
                    f"runtime_env packaging of {src!r} failed: staging "
                    f"dir vanished before publish (cache: {dest})")
        _touch(dest)
    return dest


#: (session_dir, canonical env) -> (monotonic ts, resolved env). Bounds
#: driver-side cost: a hot .remote() loop must not re-walk/re-hash the
#: tree per submission; a short TTL still picks up on-disk edits.
_prepare_memo: Dict[Any, Any] = {}
_PREPARE_TTL_S = 10.0


def prepare_runtime_env(env: Optional[Dict[str, Any]],
                        session_dir: str) -> Optional[Dict[str, Any]]:
    """Driver-side: validate + package. Returns the resolved env whose
    paths all live in the session cache (workers just mount them)."""
    if not env:
        return env
    for key in _UNSUPPORTED:
        if env.get(key):
            raise ValueError(
                f"runtime_env[{key!r}] is not supported on the hermetic "
                f"TPU image (bake dependencies into the image instead)")
    import json
    import time
    memo_key = (session_dir, json.dumps(env, sort_keys=True, default=str))
    hit = _prepare_memo.get(memo_key)
    now = time.monotonic()
    if hit is not None and now - hit[0] < _PREPARE_TTL_S:
        return hit[1]
    out = dict(env)
    if env.get("working_dir"):
        out["working_dir"] = _package_dir(session_dir, env["working_dir"])
    if env.get("py_modules"):
        out["py_modules"] = [_package_dir(session_dir, p, wrap=True)
                             for p in env["py_modules"]]
    gc_cache(session_dir)
    if len(_prepare_memo) > 256:
        _prepare_memo.clear()
    _prepare_memo[memo_key] = (now, out)
    return out


def apply_runtime_env(env: Dict[str, Any]):
    """Worker-side: mount a prepared env into this process (reference:
    the worker half of the runtime-env agent handshake). Returns a
    restore callable: pool workers are SHARED, so a normal task's env
    must not leak into unrelated later tasks (actors keep theirs for
    life and never call it). Imported modules stay in sys.modules —
    unloading live modules is not safe — matching the caveat the
    reference solves with env-keyed worker pools."""
    saved_env = {k: os.environ.get(k)
                 for k in (env.get("env_vars") or {})}
    saved_cwd = os.getcwd()
    saved_path = list(sys.path)
    for k, v in (env.get("env_vars") or {}).items():
        os.environ[k] = str(v)
    for mod_dir in env.get("py_modules") or []:
        if os.path.isdir(mod_dir):
            _touch(mod_dir)
            if mod_dir not in sys.path:
                sys.path.insert(0, mod_dir)
    wd = env.get("working_dir")
    if wd and os.path.isdir(wd):
        _touch(wd)
        os.chdir(wd)
        if wd not in sys.path:
            sys.path.insert(0, wd)

    def restore():
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        try:
            os.chdir(saved_cwd)
        except OSError:
            pass
        sys.path[:] = saved_path

    return restore


def gc_cache(session_dir: str, keep: int = 16) -> int:
    """Drop least-recently-used cache entries beyond ``keep`` (reference:
    URI reference counting + cache GC; sessions are short-lived here so
    LRU-by-mtime is sufficient). Returns number of entries removed."""
    import time
    root = _cache_root(session_dir)
    now = time.time()
    removed = 0
    try:
        entries = []
        for e in os.listdir(root):
            p = os.path.join(root, e)
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if _STAGING_RE.search(e):
                # staging dir: in use by a live preparer if fresh,
                # orphaned by a crashed one if stale
                if now - mtime >= 60.0:
                    shutil.rmtree(p, ignore_errors=True)
                    removed += 1
                continue
            entries.append((mtime, p))
    except FileNotFoundError:
        return 0
    entries.sort(reverse=True)
    for mtime, path in entries[keep:]:
        # grace window: entries are utime-stamped on every access (see
        # _package_dir/apply_runtime_env), so anything touched recently
        # may be in use by an in-flight task
        if now - mtime < 60.0:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed += 1
    return removed
