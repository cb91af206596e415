"""``core.direct.SharedSocket``: the runtime's and the node manager's
DEALER to the controller, sent on by several threads and received from by
one loop, every use under its lock, the loop polling the socket's
edge-triggered file descriptor. A stress: more sending threads than
cores, the interpreter's switch interval shortened, each message echoed
by a ROUTER; every echo must reach the loop before the deadline with no
poll timeout (a send that swallowed the descriptor's signal wakes the
loop), none twice."""

import os
import sys
import threading
import time

import zmq

from ray_tpu_torch.core.direct import SharedSocket


def test_every_echo_reaches_the_loop_under_concurrent_sends(tmp_path):
    ctx = zmq.Context.instance()
    addr = f"ipc://{tmp_path}/echo"
    router = ctx.socket(zmq.ROUTER)
    router.setsockopt(zmq.LINGER, 0)
    router.bind(addr)
    dealer = ctx.socket(zmq.DEALER)
    dealer.setsockopt(zmq.LINGER, 0)
    dealer.connect(addr)
    shared = SharedSocket(ctx, dealer)
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 300
    want = n_threads * per_thread
    stop = threading.Event()
    got = []

    def echo():
        poller = zmq.Poller()
        poller.register(router, zmq.POLLIN)
        while not stop.is_set():
            if poller.poll(50):
                while True:
                    try:
                        router.send_multipart(router.recv_multipart(
                            zmq.NOBLOCK))
                    except zmq.Again:
                        break

    def loop():
        poller = zmq.Poller()
        shared.register(poller)
        while not stop.is_set() and len(got) < want:
            poller.poll()     # no timeout: a lost wake-up stalls the loop
            got.extend(frames[0] for frames in shared.drain())

    def send(t):
        for i in range(per_thread):
            shared.send_multipart([f"{t}:{i}".encode()])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=echo), threading.Thread(target=loop)]
    senders = [threading.Thread(target=send, args=(t,))
               for t in range(n_threads)]
    try:
        for th in threads + senders:
            th.start()
        for th in senders:
            th.join(timeout=60)
        deadline = time.monotonic() + 30
        while len(got) < want and time.monotonic() < deadline:
            time.sleep(0.01)
        reached = len(got)
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        shared.wake()
        for th in threads:
            th.join(timeout=10)
        shared.close()
        shared.close_loop_end()
        router.close(0)
    assert not any(th.is_alive() for th in threads + senders)
    assert reached == want, f"{reached} of {want} echoes before the deadline"
    assert len(got) == len(set(got)) == want
