"""Direct peer-to-peer channels between processes.

The reference pushes actor tasks and task results directly between core
workers over gRPC (``transport/direct_actor_task_submitter.h``,
``direct_actor_transport.h:51``) and moves object chunks directly between
object managers (``object_manager.h:206``) — only control metadata transits
the GCS. This module provides the equivalent substrate here: every process
(driver, worker, node manager) binds one ROUTER socket at a deterministic
address derived from its identity; peers that want to talk to it connect a
DEALER (identity = their own id) and push typed messages. Replies travel
over the *recipient's* outgoing DEALER to the original sender's ROUTER, so
each socket has exactly one owning thread (ROUTER: the pump/recv thread;
DEALERs: the flusher/send thread) — no cross-thread zmq use.

Addressing: ipc sockets under ``<session_dir>/direct/`` keyed by identity
hex (abstract names where the session dir's path is too long,
:func:`protocol.unix_socket_name`). All processes of one cluster share
the session directory (multi-node tests run node managers on one host,
like ``ray.cluster_utils.Cluster``);
a TCP registry can replace the derivation for true multi-host without
changing callers (they only use :func:`direct_addr`).
"""

from __future__ import annotations

import os

from ray_tpu_torch.core import protocol as P


def direct_dir(session_dir: str) -> str:
    return os.path.join(session_dir, "direct")


def direct_addr(session_dir: str, ident: bytes) -> str:
    """Deterministic channel address for a peer identity (WorkerID / node
    identity bytes). Only an 8-byte prefix goes into the filename: unix
    socket paths cap at 107 chars and 64 random bits are ample within one
    session."""
    return "ipc://" + P.unix_socket_name(
        session_dir, f"direct/{ident[:8].hex()}.sock")


def ensure_dir(session_dir: str) -> None:
    os.makedirs(direct_dir(session_dir), exist_ok=True)
