"""Serialization: cloudpickle + pickle-5 out-of-band zero-copy buffers.

Equivalent of the reference's ``python/ray/_private/serialization.py``
(SerializationContext :110, serialize :482, deserialize_objects :393):

- cloudpickle for arbitrary Python (functions, classes, closures);
- pickle protocol 5 with out-of-band ``PickleBuffer``s so large numpy
  arrays and torch tensors (CUDA ones after a copy to host) are written
  to the shared-memory store without a further copy; numpy arrays map
  back as zero-copy read-only views on read, tensors as host copies;
- custom reducers for ObjectRef (borrowing) and ActorHandle.

Wire format of a serialized object:
    [u32 n_buffers][u64 len_meta][meta pickle bytes][buffer 0][buffer 1]...
buffers 8-byte aligned, each prefixed by u64 length.
"""

from __future__ import annotations

import io
import pickle
import struct
import threading
from typing import List, Optional, Tuple

import cloudpickle

_ALIGN = 64  # align buffers for vectorized readers / dlpack import


class SerializedObject:
    """A serialized value: metadata bytes + zero-copy buffer views."""

    __slots__ = ("meta", "buffers", "contained_refs")

    def __init__(self, meta: bytes, buffers: List[memoryview],
                 contained_refs: list):
        self.meta = meta
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def holds_tensors(self) -> bool:
        """A tensor went in (see :func:`holds_tensors`)."""
        return _RESTORE_TENSOR in self.meta

    def total_bytes(self) -> int:
        n = 12 + len(self.meta)
        for b in self.buffers:
            n = _aligned(n + 8) + b.nbytes
        return n

    def write_to(self, target: memoryview) -> int:
        """Write the wire format into ``target``; returns bytes written."""
        struct.pack_into("<IQ", target, 0, len(self.buffers), len(self.meta))
        off = 12
        target[off:off + len(self.meta)] = self.meta
        off += len(self.meta)
        for b in self.buffers:
            off = _aligned(off + 8) - 8
            struct.pack_into("<Q", target, off, b.nbytes)
            off += 8
            flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
            target[off:off + b.nbytes] = flat
            off += b.nbytes
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes())
        n = self.write_to(memoryview(out))
        return bytes(out[:n])


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


_thread_local = threading.local()


def get_active_context() -> Optional["SerializationContext"]:
    return getattr(_thread_local, "active_ctx", None)


#: the name every tensor's reduce puts into the metadata
_RESTORE_TENSOR = b"_restore_tensor"


def holds_tensors(view: memoryview) -> bool:
    """Whether a serialized value (its wire format, as
    :meth:`SerializedObject.write_to` lays it out) restores a tensor. Each
    comes back as a writable COPY (:func:`_restore_tensor`), so a runtime
    that caches the value for a later get would hand the same tensor, and
    the writes made into it, to both."""
    _, len_meta = struct.unpack_from("<IQ", view, 0)
    return _RESTORE_TENSOR in bytes(view[12:12 + len_meta])


class SerializationContext:
    """Per-worker serializer. Tracks refs contained in serialized values
    (for the borrowing protocol) and refs found while deserializing."""

    def __init__(self, worker=None):
        self.worker = worker
        self._custom_serializers = {}

    # -- hooks called from ObjectRef.__reduce__ --
    # ref lists live in thread-local state so concurrent (de)serialize calls
    # (threaded actors) don't clobber each other's tracking
    def record_contained_ref(self, ref) -> None:
        getattr(_thread_local, "contained", []).append(ref)

    def record_deserialized_ref(self, ref) -> None:
        getattr(_thread_local, "deserialized", []).append(ref)

    def register_custom_serializer(self, cls, serializer, deserializer):
        self._custom_serializers[cls] = (serializer, deserializer)

    # -- main entry points --
    def serialize(self, value) -> SerializedObject:
        buffers: List[pickle.PickleBuffer] = []
        _thread_local.active_ctx = self
        _thread_local.contained = contained = []
        try:
            value = _pre_serialize(value)
            try:
                # C-pickle fast path: ~5x cheaper than building a
                # CloudPickler per call, and every __reduce__ hook
                # (ObjectRef borrowing, custom serializers applied in
                # _pre_serialize) fires identically. Task results are
                # overwhelmingly plain data; closures/local classes
                # raise and fall back. __main__ globals DON'T raise —
                # C-pickle happily encodes them by reference, which a
                # worker (whose __main__ is worker.py) can't resolve —
                # so any STACK_GLOBAL against __main__ (its module name
                # appears literally in the stream) also falls back to
                # cloudpickle's by-value treatment.
                # The pickler carries a scoped tensor hook: any
                # torch.Tensor ANYWHERE in the value (streamed pipeline
                # activations, (loss, aux) tuples, a state dict) ships
                # as a raw out-of-band buffer instead of riding the
                # pickle stream in-band.
                sink = io.BytesIO()
                _tensor_pickler(sink, buffers).dump(value)
                meta = sink.getvalue()
                if b"__main__" in meta:
                    raise pickle.PicklingError("__main__ global")
            except (pickle.PicklingError, pickle.PickleError, TypeError,
                    AttributeError):
                buffers.clear()
                contained.clear()
                meta = _cloudpickle_dumps(value, buffers)
        finally:
            _thread_local.active_ctx = None
            _thread_local.contained = []
        views = []
        for pb in buffers:
            v = pb.raw()
            views.append(v)
        return SerializedObject(meta, views, contained)

    def deserialize(self, meta: bytes, buffers: List[memoryview]) -> Tuple[object, list]:
        """Returns (value, deserialized_refs)."""
        _thread_local.active_ctx = self
        _thread_local.deserialized = deserialized = []
        try:
            value = pickle.loads(meta, buffers=buffers)
        finally:
            _thread_local.active_ctx = None
            _thread_local.deserialized = []
        return value, list(deserialized)

    def deserialize_from_view(self, view: memoryview) -> Tuple[object, list]:
        value, refs, _ = self.deserialize_from_view_tracked(view)
        return value, refs

    def deserialize_from_view_tracked(
            self, view: memoryview) -> Tuple[object, list, list]:
        """Like deserialize_from_view, but also returns the out-of-band
        buffer views handed to pickle. Zero-copy consumers (arrow
        buffers, numpy bases) hold references to EXACTLY these
        memoryview objects for as long as any alias of the data lives —
        they are the correct anchors for reader-lease lifetime (a
        finalizer on the VALUE fires too early: a table can die while
        its sliced/united buffers live on in other arrow objects)."""
        n_buffers, len_meta = struct.unpack_from("<IQ", view, 0)
        off = 12
        meta = bytes(view[off:off + len_meta])
        off += len_meta
        buffers = []
        for _ in range(n_buffers):
            off = _aligned(off + 8) - 8
            (blen,) = struct.unpack_from("<Q", view, off)
            off += 8
            buffers.append(view[off:off + blen])
            off += blen
        value, refs = self.deserialize(meta, buffers)
        return value, refs, buffers


_OOB_BYTES_THRESHOLD = 4096


class _OOBBytes:
    """Ships a large bytes/bytearray payload out-of-band: the pickle stream
    carries only a reconstructor; the payload rides as a zero-copy
    PickleBuffer (one memcpy into shm at write, one back out at get —
    instead of an extra full copy through the pickle stream)."""

    __slots__ = ("ctor", "value")

    def __init__(self, ctor, value):
        self.ctor = ctor
        self.value = value

    def __reduce_ex__(self, protocol):
        return self.ctor, (pickle.PickleBuffer(self.value),)


def _pre_serialize(value):
    """Large raw bytes go out-of-band (see _OOBBytes). Tensors, at the
    top level or nested anywhere, leave through the pickler's tensor
    hook (``_reduce_tensor``), which copies a CUDA tensor to host."""
    if type(value) is bytes and len(value) > _OOB_BYTES_THRESHOLD:
        return _OOBBytes(bytes, value)
    if type(value) is bytearray and len(value) > _OOB_BYTES_THRESHOLD:
        return _OOBBytes(bytearray, value)
    return value


# ---- tensor serialization fast path -----------------------------------
# A torch.Tensor nested anywhere inside a value (a streamed pipeline
# activation tuple, an actor-call argument tree, a state dict) would
# otherwise ride torch's own __reduce_ex__ THROUGH the pickle stream: a
# full in-band copy of the payload, and for a CUDA tensor a storage that
# the reader rebuilds on ITS device (a CPU-only worker cannot load it; a
# GPU worker would allocate on the card as a side effect of a get). The
# pickler hook below turns every tensor, whatever its device, subclass
# (nn.Parameter) or autograd state, into (dtype, shape, raw bytes): a CUDA
# tensor is copied to host (a pageable device-to-host copy), and the
# bytes go out-of-band (one memcpy into shm at write). bf16 and the other
# dtypes numpy lacks travel as their bit patterns, so no ml_dtypes is
# needed. Scoped to the object-store picklers (NOT copyreg-global) so
# user pickling semantics elsewhere are untouched.


def _torch():
    """The torch module if this process imported it, else None: a process
    that never imported torch holds no tensor and does not import it."""
    import sys
    return sys.modules.get("torch")


def _tensor_pickler(file, buffers):
    """The fast-path pickler; it carries the tensor hook once torch is in
    the process."""
    torch = _torch()
    if torch is None:
        return pickle.Pickler(file, protocol=5,
                              buffer_callback=buffers.append)
    return _TensorPickler(file, protocol=5, buffer_callback=buffers.append)


class _TensorPickler(pickle.Pickler):
    def reducer_override(self, obj):
        torch = _torch()
        if isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return NotImplemented


class _TensorCloudPickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        torch = _torch()
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _cloudpickle_dumps(value, buffers) -> bytes:
    sink = io.BytesIO()
    _TensorCloudPickler(sink, protocol=5,
                        buffer_callback=buffers.append).dump(value)
    return sink.getvalue()


def pickle_inband(value, cloud: bool = False) -> bytes:
    """``value`` as one self-contained pickle stream (plain pickle, or
    cloudpickle with ``cloud=True``) whose tensors go through the store's
    hook: a reader gets each as ``get`` gives it, a CPU tensor of the
    sender's dtype, shape and bits. For the channels and the client wire,
    which carry one flat blob and no out-of-band buffers."""
    sink = io.BytesIO()
    if cloud:
        _TensorCloudPickler(sink, protocol=5).dump(value)
    elif _torch() is None:
        pickle.Pickler(sink, protocol=5).dump(value)
    else:
        _TensorPickler(sink, protocol=5).dump(value)
    return sink.getvalue()


def _reduce_tensor(t):
    import numpy as np
    torch = _torch()
    kind = "param" if isinstance(t, torch.nn.Parameter) else "tensor"
    requires_grad = bool(t.requires_grad)
    t = t.detach()
    if t.layout != torch.strided:
        # sparse and other layouts: torch's own reduce of a host copy
        # (its index and value tensors come back through this hook)
        return t.cpu().__reduce_ex__(5)
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.resolve_conj().resolve_neg().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy()
    dtype_name = str(t.dtype).rpartition(".")[2]
    shape = tuple(t.shape)
    if raw.nbytes < _OOB_BYTES_THRESHOLD:
        payload = raw.tobytes()
    else:
        payload = pickle.PickleBuffer(raw)
    return (_restore_tensor, (payload, dtype_name, shape, kind,
                              requires_grad))


def _restore_tensor(buf, dtype_name: str, shape, kind: str = "tensor",
                    requires_grad: bool = False):
    """A CPU tensor of the sender's dtype, shape and bits. The bytes are
    COPIED out of ``buf``: it may be the store's shared pages, and a write
    into the returned tensor must not reach them (a numpy array restored
    zero-copy is read-only; a tensor cannot be)."""
    import numpy as np
    import torch
    out = torch.empty(shape, dtype=getattr(torch, dtype_name))
    out.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
        buf, dtype=np.uint8)
    if kind == "param":
        return torch.nn.Parameter(out, requires_grad=requires_grad)
    if requires_grad:
        out.requires_grad_(True)
    return out


def to_host(value):
    """Eagerly copy a top-level CUDA tensor to a host tensor (no-op for
    anything else). The streaming worker calls this at yield time so
    the device fetch happens outside the store/report critical path."""
    torch = _torch()
    if torch is not None and isinstance(value, torch.Tensor) \
            and value.device.type != "cpu":
        return value.detach().cpu()
    return value


_default_ctx: Optional[SerializationContext] = None


def default_context() -> SerializationContext:
    global _default_ctx
    if _default_ctx is None:
        _default_ctx = SerializationContext()
    return _default_ctx
