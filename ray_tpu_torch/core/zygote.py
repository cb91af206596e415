"""Warm worker factory: a fork-server ("zygote") that pre-imports the
worker stack once and forks ready-to-run worker processes in
milliseconds.

Reference: ``src/ray/raylet/worker_pool.h:104`` — the raylet prestarts
and reuses workers precisely because a cold Python worker boot
(interpreter + imports) costs seconds. Prestart hides that latency for
the steady state; this zygote removes it from the SPAWN path itself,
which is what an actor burst hits: every actor needs a fresh dedicated
worker, so 120 actors at ~2.5s of import CPU each serialize into
minutes on a small host. Forking from a warmed template costs ~5ms and
shares the imported pages copy-on-write.

Fork-safety: the zygote imports modules but starts NO threads and
creates NO zmq contexts — the forked child builds its Runtime (threads,
sockets) from scratch after the fork. The child double-forks so the
zygote never accumulates zombies (init reaps the grandchild); the
grandchild reports its own pid over the spawn connection before
entering the worker main loop.

Protocol (unix stream socket, one spawn per connection):
  request  = JSON line {"env": {...}, "log_path": str}
  response = JSON line {"pid": int}
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys


def _become_worker(req: dict, conn: socket.socket) -> None:
    """Grandchild: finish detaching, report our pid, run the worker."""
    os.setsid()
    fd = os.open(req["log_path"],
                 os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    if fd > 2:
        os.close(fd)
    env = req.get("env") or {}
    os.environ.update(env)
    for p in reversed(env.get("PYTHONPATH", "").split(os.pathsep)):
        if p and p not in sys.path:
            sys.path.insert(0, p)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        conn.sendall((json.dumps({"pid": os.getpid()}) + "\n").encode())
    finally:
        conn.close()
    try:
        from ray_tpu_torch.core import worker
        worker.main()
    except BaseException:  # noqa: BLE001
        import traceback
        traceback.print_exc()
    finally:
        os._exit(0)


def serve(sock_path: str, parent_pid: int = 0) -> None:
    # Pre-import the whole worker stack (the expensive part a cold
    # worker pays: interpreter is already up here, so this is the only
    # boot cost left) BEFORE accepting spawns. Must not start threads.
    import ray_tpu_torch.core.worker  # noqa: F401
    # ... and torch with torch._dynamo, which the first call of any torch
    # custom op (the flash kernels' wrappers) imports: about 3 s of CPU a
    # worker otherwise. Neither starts a thread or touches CUDA (a child
    # initializes CUDA itself, after the fork).
    import torch  # noqa: F401
    import torch._dynamo  # noqa: F401

    # Fork-server GC hygiene: freeze the warmed heap into the permanent
    # generation. Without this every child's first gen-2 collection
    # walks the ~200k inherited objects — burning ~250ms CPU per worker
    # AND unsharing the copy-on-write pages the zygote exists to share
    # (the measured actor-burst ceiling). Children collect only their
    # own allocations.
    import gc
    gc.collect()
    gc.freeze()

    from ray_tpu_torch.core import protocol as P
    abstract = P.is_abstract(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if not abstract:
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass
    srv.bind(P.unix_address(sock_path))
    srv.listen(128)
    # parent-death watch: poll the node manager's pid between accepts —
    # without it every unclean node death (SIGKILL, crash) leaks a full
    # pre-imported interpreter plus its socket
    srv.settimeout(5.0)
    while True:
        if parent_pid:
            try:
                os.kill(parent_pid, 0)
            except ProcessLookupError:
                if not abstract:
                    try:
                        os.unlink(sock_path)
                    except OSError:
                        pass
                return
            except PermissionError:
                pass
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            continue
        except OSError:
            return
        try:
            data = b""
            while not data.endswith(b"\n"):
                chunk = conn.recv(65536)
                if not chunk:
                    break
                data += chunk
            if not data.strip():
                continue
            req = json.loads(data)
            if req.get("op") == "shutdown":
                conn.close()
                return
            pid = os.fork()
            if pid == 0:
                # intermediate child: fork again and exit so the worker
                # is reparented to init (no zombies in the zygote)
                srv.close()
                if os.fork() != 0:
                    os._exit(0)
                _become_worker(req, conn)
            os.waitpid(pid, 0)  # reap the intermediate
        except Exception:  # noqa: BLE001
            import traceback
            traceback.print_exc()
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main() -> None:
    serve(sys.argv[1],
          int(sys.argv[2]) if len(sys.argv) > 2 else 0)


if __name__ == "__main__":
    main()
