"""A retransmit queued twice before one flush runs its call once.

The reliable layer re-enqueues the same stamped payload object each
time a message's ack is late. A flush that is slow (an actor call
carrying a large argument is pickled and sent whole) can find two such
copies in one batch; pickled together they become one shared dict on
the receiving side, whose stamp the receiver's dedup pops at the first
copy, so the second copy used to pass as new and execute the call a
second time (on the card, a learner's ``apply_gradients`` with 3.26 GB
of gradients ran 4 and 6 times). The port's flush ships each stamped
object once (``core/runtime.py::_flush_box``)."""

import threading

import numpy as np

from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core import reliable as RD
from ray_tpu_torch.core.runtime import Runtime


def _fake(sent, rel):
    class FakeRuntime:
        kind = "test"
        _stopped = threading.Event()
        _reliable = rel
        _sock_send = staticmethod(lambda mt, blob: sent.append((mt, blob)))

        def _peer_sock(self, target):  # pragma: no cover
            raise AssertionError("no peers in this test")
    return FakeRuntime()


def _handled(blobs):
    """Payloads a receiver's reliable layer lets through, batches
    unpacked in order, as ``Runtime._on_message`` does."""
    rx = RD.ReliableTransport(lambda *a: None, lambda *a: None,
                              start_thread=False, name="rx")
    out = []

    def on_message(mtype, m):
        if rx.on_receive(None, m):
            return
        if mtype == P.MSG_BATCH:
            for sub_type, sub in m["msgs"]:
                on_message(sub_type, sub)
            return
        out.append(m)
    for mtype, blob in blobs:
        on_message(mtype, P.loads(blob))
    return out


def test_a_retransmit_queued_twice_runs_its_call_once():
    tx = RD.ReliableTransport(lambda *a: None, lambda *a: None,
                              start_thread=False, name="tx")
    call = tx.stamp(None, P.ACTOR_CALL,
                    {"spec": "apply_gradients",
                     "args": np.zeros(16, np.float32)})
    other = tx.stamp(None, P.ACTOR_CALL, {"spec": "get_weights"})
    sent = []
    # the original, then one flush that found the retransmit queued twice
    Runtime._flush_box(_fake(sent, tx), None, [(P.ACTOR_CALL, call)])
    Runtime._flush_box(_fake(sent, tx), None,
                       [(P.ACTOR_CALL, call), (P.ACTOR_CALL, call),
                        (P.ACTOR_CALL, other)])
    got = _handled(sent)
    assert [m["spec"] for m in got] == ["apply_gradients", "get_weights"]


def test_distinct_unstamped_payloads_all_ship():
    sent = []
    same = {"op": "put", "key": b"a"}
    Runtime._flush_box(_fake(sent, None), None,
                       [(P.KV_OP, same), (P.KV_OP, same)])
    assert len(P.loads(sent[0][1])["msgs"]) == 2
