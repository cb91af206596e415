"""Shared wire bits for the client protocol.

One request/one reply, both a pickled dict. Requests carry ``op`` plus
op-specific fields; replies carry ``ok`` and either a result payload or
``error`` (a pickled exception re-raised client-side). ObjectRefs and
actor handles never cross the wire as live objects — they travel as
opaque ids minted by the server and are wrapped client-side.
"""

from __future__ import annotations

import pickle
from typing import Any

from ray_tpu_torch.core.serialization import pickle_inband

DEFAULT_PORT = 10001

#: Max time one server-side get/wait handler may block before replying
#: "pending"; the client re-polls in the same slice. Shared here because
#: the two sides must stay in lockstep: the client's per-RPC deadline
#: must comfortably exceed this server-side clamp.
BLOCK_SLICE_S = 2.0


def dumps(obj: Any) -> bytes:
    # tensors through the object store's hook: whichever side reads
    # them gets a CPU tensor of the same bits, as ``get`` gives it (a
    # CUDA tensor the client passes is never rebuilt on a card inside
    # the server's process)
    return pickle_inband(obj, cloud=True)


def loads(blob: bytes) -> Any:
    return pickle.loads(blob)


class ClientObjectRef:
    """Client-side stand-in for a server-held ObjectRef."""

    __slots__ = ("_id", "_worker", "__weakref__")

    def __init__(self, ref_id: bytes, worker=None):
        self._id = ref_id
        self._worker = worker

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ClientObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ClientObjectRef({self._id.hex()[:16]})"

    def __del__(self):
        w = self._worker
        if w is not None:
            try:
                w._release(self._id)
            except Exception:
                pass

    def __reduce__(self):
        # travels to the server (inside args) as a marker
        return (_RefMarker, (self._id,))


class _RefMarker:
    """What a ClientObjectRef pickles into: the server swaps it for the
    real ObjectRef it holds for this connection."""

    __slots__ = ("ref_id",)

    def __init__(self, ref_id: bytes):
        self.ref_id = ref_id


class ClientActorHandle:
    """Client-side actor handle: method calls become CALL_METHOD RPCs."""

    def __init__(self, actor_ref_id: bytes, worker, methods):
        self._id = actor_ref_id
        self._worker = worker
        self._methods = set(methods)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._methods:
            raise AttributeError(
                f"actor has no method {name!r} (methods: "
                f"{sorted(self._methods)})")
        return _ClientMethod(self, name)

    def __repr__(self):
        return f"ClientActorHandle({self._id.hex()[:12]})"

    def __del__(self):
        w = getattr(self, "_worker", None)
        if w is not None:
            try:
                w._release_actor(self._id)
            except Exception:
                pass


class _ClientMethod:
    __slots__ = ("_handle", "_name", "_opts")

    def __init__(self, handle, name, opts=None):
        self._handle = handle
        self._name = name
        self._opts = opts or {}

    def options(self, **opts):
        return _ClientMethod(self._handle, self._name, opts)

    def remote(self, *args, **kwargs):
        w = self._handle._worker
        return w._call_method(self._handle._id, self._name, args, kwargs,
                              self._opts)
