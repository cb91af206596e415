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
import threading

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


class SharedSocket:
    """A zmq socket that several threads send on and one loop thread
    receives from (a runtime's or node manager's DEALER to the
    controller), with the loop's wake channel.

    A zmq socket is not thread-safe: a send, a receive and a poll each
    run the socket's command processing, and two threads doing so at once
    corrupt its command mailbox (libzmq then aborts in ``object.cpp``).
    So every use holds ``lock``, and the loop polls the socket's file
    descriptor rather than the socket (:meth:`register`). That descriptor
    is edge-triggered and a send can consume its signal, so a send that
    leaves input waiting wakes the loop (:meth:`wake`, callable from any
    thread), and the loop drains the socket on every turn
    (:meth:`drain`)."""

    def __init__(self, ctx, sock):
        import zmq
        self._zmq = zmq
        self.sock = sock
        self.lock = threading.Lock()
        self._closed = False
        addr = f"inproc://shared-socket-wake-{id(self)}"
        self._wake_recv = ctx.socket(zmq.PULL)     # the loop's alone
        self._wake_recv.bind(addr)
        self._wake_send = ctx.socket(zmq.PUSH)
        self._wake_send.connect(addr)
        self._wake_lock = threading.Lock()
        self._wake_closed = False
        with self.lock:
            self._fd = sock.getsockopt(zmq.FD)

    def register(self, poller) -> None:
        """Poll the socket's descriptor and the wake channel."""
        poller.register(self._fd, self._zmq.POLLIN)
        poller.register(self._wake_recv, self._zmq.POLLIN)

    def wake(self) -> None:
        """Wake the loop's poll (from any thread; a no-op once closed)."""
        with self._wake_lock:
            if self._wake_closed:
                return
            try:
                self._wake_send.send(b"", self._zmq.NOBLOCK)
            except self._zmq.ZMQError:
                pass

    def send_multipart(self, frames, flags: int = 0) -> None:
        zmq = self._zmq
        with self.lock:
            if self._closed:
                return
            self.sock.send_multipart(frames, flags)
            waiting = self.sock.getsockopt(zmq.EVENTS) & zmq.POLLIN
        if waiting:
            self.wake()

    def drain(self) -> list:
        """The loop's turn: clear the wake channel, then take every
        message waiting, as lists of frames."""
        zmq = self._zmq
        try:
            while True:
                self._wake_recv.recv(zmq.NOBLOCK)
        except zmq.ZMQError:
            pass
        out = []
        with self.lock:
            while not self._closed:
                try:
                    out.append(self.sock.recv_multipart(zmq.NOBLOCK))
                except zmq.Again:
                    break
        return out

    def close(self) -> None:
        """Close the socket and the wake channel's sending end (the
        receiving end is the loop's: :meth:`close_loop_end`)."""
        with self.lock:
            if not self._closed:
                self._closed = True
                self.sock.close(0)
        with self._wake_lock:
            if not self._wake_closed:
                self._wake_closed = True
                self._wake_send.close(0)

    def close_loop_end(self) -> None:
        """Close the wake channel's receiving end, once the loop that
        polls it has ended."""
        self._wake_recv.close(0)
