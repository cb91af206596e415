"""The KV wire codec of disaggregated prefill/decode: the port's copy of
the codec part of ``ray_tpu/serve/disagg.py``.

A prefill engine packs a request's finished KV blocks (``LLMEngine.
prefill_export``) and a decode engine adopts them into its own block
pool (``LLMEngine.submit_adopt``). Slabs are ``[n_layers, n_blocks,
block_size, kv_heads, head_dim]`` and the payload keeps the JAX
package's keys (``wire``, ``shape``, ``dtype``, ``k``, ``v``, and
``k_scales`` / ``v_scales`` on the int8 wire, ``wire_bytes``), so a
payload made by either package is adopted by the other.

Wire formats (``EngineConfig.kv_wire``):

- ``"bf16"``: the cache's own dtype shipped raw, bit-exact (an f32 cache
  ships f32). numpy has no bfloat16 of its own: a bf16 slab travels as
  its 16-bit pattern, in numpy's ``bfloat16`` dtype when an extension has
  registered one in this process (``ml_dtypes`` does, with JAX loaded, so
  the JAX package reads it unchanged), else as ``int16``; unpacking reads
  either through the bit pattern. The port imports no ``ml_dtypes``.
- ``"int8"``: blockwise symmetric int8 over 256-element blocks with one
  f32 scale each (:mod:`ray_tpu_torch.parallel.quantization`), quantized
  where the slab lives (on the card for a CUDA slab) before its one copy
  to the host, and dequantized on the adopting device.

:class:`DisaggRouter` scores the (prefill, decode) pair jointly off the
per-replica engine gauges (decode side: free KV blocks and slots through
``handle.gauge_score``; prefill side: a shallow queue and chunk
backlog), with decode-side session affinity, and streams a request
through the pair. The prefill call's ObjectRef rides as a top-level
argument of the decode replica's call, so the decode worker pulls the
payload from the prefill worker: its slabs leave that worker as bytes
through the serializer (a CUDA slab after one copy to the host) and come
back as CPU tensors, which ``submit_adopt`` moves to its own device.
:func:`deploy_disaggregated` deploys the two ``LLMServer`` fleets and
returns the router; :func:`migrate_warm_prefixes` moves a replica's warm
radix-trie chains to another over the same export/adopt machinery.
"""

from __future__ import annotations

import random
import threading
import time
import warnings
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.parallel.quantization import (dequantize_int8,
                                                 quantize_int8, wire_bytes)

WIRES = ("bf16", "int8")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class DisaggHandoffError(RayTpuError):
    """The prefill->decode KV hand-off failed terminally, so callers can
    tell a hand-off failure from an in-decode failure."""


def _numpy_bf16() -> Optional[np.dtype]:
    """numpy's ``bfloat16`` dtype if an extension registered one in this
    process, else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as its bit pattern (see the module
    docstring)."""
    t = t.detach().contiguous().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    bf16 = _numpy_bf16()
    return bits.view(bf16) if bf16 is not None else bits


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory. A slab that arrived out of band
    is a read-only view of the received buffer; it is only read (copied
    to the device or scattered into the cache), so torch's warning about
    non-writable arrays does not apply."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a)


def _to_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy slab of the payload -> a CPU tensor of ``dtype`` with the
    same bits (bf16) or the same values."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind != "f":
        # the 16-bit pattern: int16/uint16, or an extension's bfloat16
        return _host_tensor(a.view(np.int16)).view(torch.bfloat16)
    return _host_tensor(a)


def pack_kv_blocks(k: torch.Tensor, v: torch.Tensor,
                   wire: str = "bf16") -> Dict[str, Any]:
    """Pack gathered KV slabs ``[n_layers, n_blocks, block_size,
    kv_heads, head_dim]`` (tensors on any device) for the wire.
    ``"bf16"`` ships them in their own dtype, bit-exact; ``"int8"``
    quantizes each slab blockwise where it lives. Each array is copied to
    the host once. ``wire_bytes`` is the bytes of the arrays shipped."""
    if wire not in WIRES:
        raise ValueError(f"unknown kv wire format {wire!r}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if k.dtype != v.dtype:
        raise ValueError(f"k/v dtype mismatch: {k.dtype} vs {v.dtype}")
    dtype = str(k.dtype).split(".")[-1]
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"no kv wire for dtype {k.dtype}")
    out: Dict[str, Any] = {"wire": wire, "shape": list(k.shape),
                           "dtype": dtype}
    if wire == "bf16":
        out["k"], out["v"] = _to_numpy(k), _to_numpy(v)
        arrays = [out["k"], out["v"]]
    else:
        kq, ks = quantize_int8(k)
        vq, vs = quantize_int8(v)
        out["k"], out["k_scales"] = _to_numpy(kq), _to_numpy(ks)
        out["v"], out["v_scales"] = _to_numpy(vq), _to_numpy(vs)
        arrays = [out["k"], out["k_scales"], out["v"], out["v_scales"]]
    out["wire_bytes"] = int(sum(a.nbytes for a in arrays))
    return out


def unpack_kv_blocks(kv: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`pack_kv_blocks`: ``(k, v)`` tensors ``[n_layers,
    n_blocks, block_size, kv_heads, head_dim]`` on ``device`` (default
    the CPU) in ``dtype`` (default: the dtype they were packed from).
    Each array goes to the device once; int8 is dequantized there."""
    shape = tuple(int(s) for s in kv["shape"])
    src = _TORCH_DTYPES.get(str(kv.get("dtype")))
    if src is None:
        raise ValueError(f"no kv wire for dtype {kv.get('dtype')!r}")
    tgt = dtype if dtype is not None else src
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if kv["wire"] == "bf16":
        k, v = (_to_tensor(kv[n], src).to(dev).to(tgt) for n in ("k", "v"))
    elif kv["wire"] == "int8":
        k, v = (dequantize_int8(_host_tensor(np.asarray(kv[n])).to(dev),
                                _host_tensor(
                                    np.asarray(kv[n + "_scales"])).to(dev),
                                shape=shape, dtype=tgt)
                for n in ("k", "v"))
    else:
        raise ValueError(f"unknown kv wire format {kv['wire']!r}")
    if tuple(k.shape) != shape:
        raise ValueError(
            f"unpacked shape {tuple(k.shape)} != packed shape {shape}")
    return k, v


def kv_ship_bytes(n_blocks: int, block_size: int, kv_heads: int,
                  head_dim: int, n_layers: int, wire: str = "bf16",
                  dtype_bytes: int = 2) -> int:
    """Wire footprint of one hand-off: ``2 (k+v) * n_layers * n_blocks *
    block_size * kv_heads * head_dim`` elements at ``dtype_bytes`` each
    for ``"bf16"``, or one byte an element plus one f32 scale a
    256-element block, k and v quantized apart, for ``"int8"``. Equal to
    the ``wire_bytes`` a packed payload reports."""
    numel = 2 * n_layers * n_blocks * block_size * kv_heads * head_dim
    if wire == "bf16":
        return numel * dtype_bytes
    return 2 * wire_bytes(numel // 2, transport="int8")


# ------------------------------------------------------- joint routing
def prefill_score(g: Dict[str, Any]) -> float:
    """Desirability of a prefill replica (higher is better): shallow
    admission queue and little chunk backlog. Free decode slots are
    meaningless on a prefill-only fleet — every request holds a slot for
    exactly one chunk train — so the queue IS the signal."""
    queue = g.get("queue_depth") or 0
    prefilling = g.get("prefilling") or 0
    return -(float(queue) + 0.5 * float(prefilling))


class _DisaggMethod:
    def __init__(self, router: "DisaggRouter", opts: Dict[str, Any]):
        self._router = router
        self._opts = opts

    def remote(self, prompt_ids, max_new_tokens=None, eos_token_id=None):
        return self._router.generate(
            prompt_ids, max_new_tokens, eos_token_id=eos_token_id,
            **self._opts)


class _DisaggOptions:
    """``handle.options(...)`` shim so the bench harness's ``run_load``
    drives a :class:`DisaggRouter` exactly like a DeploymentHandle:
    ``router.options(stream=True).generate.remote(prompt, n)``."""

    def __init__(self, router: "DisaggRouter", opts: Dict[str, Any]):
        self._router = router
        self._opts = opts

    @property
    def generate(self) -> _DisaggMethod:
        return _DisaggMethod(self._router, self._opts)


class DisaggRouter:
    """Client-side router for a disaggregated pair of fleets.

    Holds one ``_Router`` per fleet (same membership/gauge machinery as
    a DeploymentHandle) and scores the (prefill, decode) pair jointly:
    the additive joint score decomposes into a per-side argmax, so each
    side picks its best candidate off the freshest gauges — decode by
    ``gauge_score`` (+ session affinity, which wins outright, + the
    prefix-fingerprint bonus), prefill by :func:`prefill_score`. Both
    sides fall back to power-of-two-choices on stale gauges.

    ``generate`` is a synchronous token generator: a pair death before
    the first token is retried on a fresh pair (membership resynced,
    dead pair excluded); exhaustion raises :class:`DisaggHandoffError`.
    """

    #: pair re-picks after an actor death before the first token
    max_retries = 2

    def __init__(self, prefill_deployment: str, decode_deployment: str,
                 controller=None):
        from ray_tpu_torch.serve.handle import _Router
        if controller is None:
            from ray_tpu_torch.serve import api as serve_api
            controller = serve_api._controller_or_none()
            if controller is None:
                raise RuntimeError("Serve is not running")
        self.prefill = _Router(prefill_deployment, controller)
        self.decode = _Router(decode_deployment, controller)
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "requests": 0, "retries": 0, "handoff_errors": 0}

    # -- pair scoring -------------------------------------------------
    def _pick_decode(self, session_id, prefix_fp, exclude):
        from ray_tpu_torch.serve.handle import gauge_score
        r = self.decode
        by_key = {r._key(rep): rep for rep in r.replicas}
        if session_id is not None:
            k = r.session_affinity.get(session_id)
            if k is not None and k in by_key and k not in exclude:
                return by_key[k], k
        cands = [rep for rep in r.replicas
                 if r._key(rep) not in exclude] or list(r.replicas)
        r._poll_gauges()
        fresh = r._fresh_gauges()

        def score(g):
            s = gauge_score(g)
            if prefix_fp is not None and prefix_fp in \
                    (g.get("prefix_fingerprints") or ()):
                s += r.prefix_match_bonus
            return s

        scored = [(score(fresh[r._key(rep)]), i, rep)
                  for i, rep in enumerate(cands)
                  if r._key(rep) in fresh]
        if scored:
            best = max(scored, key=lambda t: (
                t[0] - 0.25 * r.load(t[2]), -t[1]))
            rep = best[2]
        else:
            rep = self._pow2(r, cands)
        k = r._key(rep)
        if session_id is not None:
            r.session_affinity[session_id] = k
        return rep, k

    def _pick_prefill(self, exclude):
        r = self.prefill
        cands = [rep for rep in r.replicas
                 if r._key(rep) not in exclude] or list(r.replicas)
        r._poll_gauges()
        fresh = r._fresh_gauges()
        scored = [(prefill_score(fresh[r._key(rep)]), i, rep)
                  for i, rep in enumerate(cands)
                  if r._key(rep) in fresh]
        if scored:
            best = max(scored, key=lambda t: (
                t[0] - 0.25 * r.load(t[2]), -t[1]))
            rep = best[2]
        else:
            rep = self._pow2(r, cands)
        return rep, r._key(rep)

    @staticmethod
    def _pow2(router, cands):
        if len(cands) == 1:
            return cands[0]
        a, b = random.sample(cands, 2)
        return a if router.load(a) <= router.load(b) else b

    def pick_pair(self, session_id: Optional[str] = None,
                  prefix_fp: Optional[int] = None,
                  exclude_prefill: Sequence[bytes] = (),
                  exclude_decode: Sequence[bytes] = ()):
        """Returns ``(prefill_replica, pkey, decode_replica, dkey)``."""
        with self._lock:
            self.prefill.refresh()
            self.decode.refresh()
            if not self.prefill.replicas or not self.decode.replicas:
                raise RuntimeError(
                    f"disagg fleets incomplete: "
                    f"{len(self.prefill.replicas)} prefill / "
                    f"{len(self.decode.replicas)} decode replicas")
            dc, dkey = self._pick_decode(
                session_id, prefix_fp, set(exclude_decode))
            pf, pkey = self._pick_prefill(set(exclude_prefill))
        return pf, pkey, dc, dkey

    # -- request path -------------------------------------------------
    def options(self, *, stream: bool = True,
                session_id: Optional[str] = None,
                prefix_fingerprint: Optional[int] = None,
                request_id: Optional[str] = None,
                routing_policy: Optional[str] = None,
                **kwargs) -> _DisaggOptions:
        """Handle-compatible surface for the bench harness. Disagg
        requests are always streamed and always gauge-routed;
        ``routing_policy`` is accepted (and ignored beyond validation)
        so ``run_load``'s handle_opts pass through unchanged."""
        if kwargs:
            raise TypeError(
                f"unsupported disagg options: {sorted(kwargs)}")
        if routing_policy not in (None, "gauge", "pow2", "round_robin"):
            raise ValueError(f"unknown routing_policy {routing_policy!r}")
        return _DisaggOptions(self, {
            "session_id": session_id,
            "prefix_fp": prefix_fingerprint,
            "request_id": request_id,
        })

    def _mint_ctx(self, request_id: Optional[str]):
        """One request identity spans both fleets: the prefill and
        decode engines trace under the same request id with distinct
        parts (``trace_part``), so the waterfall stitches PREFILL +
        KV_SHIP from one replica with KV_ADOPT + DECODE from the
        other."""
        tracer = self.decode._get_tracer()
        trace = tracer.begin(request_id=request_id) \
            if tracer is not None else None
        rid = trace.request_id if trace is not None else request_id
        ctx: Dict[str, Any] = {"multiplexed_model_id": ""}
        if trace is not None:
            ctx["request_id"] = rid
            ctx["trace"] = {
                "sampled": trace.sampled,
                "enqueue_ts": time.time(),
                "policy": "disagg",
                "score": None,
                "admission": "bypass",
            }
        return rid, ctx

    def generate(self, prompt_ids: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None, *,
                 session_id: Optional[str] = None,
                 prefix_fp: Optional[int] = None,
                 request_id: Optional[str] = None) -> Iterator[Any]:
        """Disaggregated generate: prefill on one fleet, decode on the
        other, KV shipped between them. Yields exactly what a colocated
        ``LLMServer.generate`` stream would (first token included)."""
        prompt = list(prompt_ids)
        exclude_p: set = set()
        exclude_d: set = set()
        last_err: Optional[BaseException] = None
        with self._lock:
            self.stats["requests"] += 1
        for attempt in range(self.max_retries + 1):
            pf, pkey, dc, dkey = self.pick_pair(
                session_id=session_id, prefix_fp=prefix_fp,
                exclude_prefill=exclude_p, exclude_decode=exclude_d)
            _, ctx = self._mint_ctx(request_id)
            first = True
            try:
                # the ObjectRef rides as a top-level arg: the decode
                # worker pulls the payload from the prefill worker
                # directly (P2P over the reliable layer) — the slab
                # never transits this process
                ref = pf.handle_request_ctx.remote(
                    ctx, "prefill_export", prompt)
                gen = dc.handle_request_stream.options(
                    num_returns="streaming").remote(
                        ctx, "adopt_generate", ref, max_new_tokens,
                        eos_token_id)
                self.decode.stream_started(dkey)
                try:
                    for item_ref in gen:
                        item = ray_tpu_torch.get(item_ref)
                        first = False
                        yield item
                finally:
                    self.decode.stream_finished(dkey)
                return
            except Exception as e:  # noqa: BLE001
                if first and attempt < self.max_retries \
                        and self._retryable(e):
                    last_err = e
                    exclude_p.add(pkey)
                    exclude_d.add(dkey)
                    with self._lock:
                        self.stats["retries"] += 1
                        if session_id is not None:
                            self.decode.session_affinity.pop(
                                session_id, None)
                        self.prefill.refresh(force=True)
                        self.decode.refresh(force=True)
                    continue
                if first:
                    with self._lock:
                        self.stats["handoff_errors"] += 1
                    raise DisaggHandoffError(
                        f"prefill/decode hand-off failed after "
                        f"{attempt + 1} attempt(s): "
                        f"{type(e).__name__}: {e}") from e
                raise   # in-decode failure after first token: not ours
        with self._lock:
            self.stats["handoff_errors"] += 1
        raise DisaggHandoffError(
            f"prefill/decode hand-off failed after "
            f"{self.max_retries + 1} attempt(s): "
            f"{type(last_err).__name__}: {last_err}") from last_err

    @staticmethod
    def _retryable(e: BaseException) -> bool:
        """A death anywhere along the hand-off pair is retryable: the
        prefill actor dying mid-ship surfaces through the decode-side
        stream — as a TaskError wrapping the decode worker's failed
        argument pull — so unwrap task errors before classifying."""
        from ray_tpu_torch.serve.handle import _is_actor_death
        from ray_tpu_torch.exceptions import (ObjectLostError, RpcTimeoutError,
                                        TaskError)
        if _is_actor_death(e) or \
                isinstance(e, (ObjectLostError, RpcTimeoutError)):
            return True
        if isinstance(e, TaskError):
            if e.cause is not None and DisaggRouter._retryable(e.cause):
                return True
            # cross-process TaskErrors carry only the traceback text
            return any(name in (e.traceback_str or "") for name in
                       ("ActorDiedError", "ActorError",
                        "ObjectLostError"))
        return False


# --------------------------------------------------- migration helper
def migrate_warm_prefixes(src_replica, dst_replica, min_hits: int = 1,
                          max_blocks: int = 0,
                          timeout_s: float = 30.0) -> int:
    """Ship ``src``'s warm ref-0 radix-trie chains to ``dst`` (both
    Replica actors): the export ref is passed straight into the import
    call, so the KV slab moves worker-to-worker and never transits the
    caller. Returns the number of blocks the survivor adopted (0 when
    the victim had nothing warm or the survivor had no free blocks)."""
    ref = src_replica.prepare_drain.remote(min_hits, max_blocks)
    n = ray_tpu_torch.get(
        dst_replica.handle_request.remote("import_warm_prefixes", ref),
        timeout=timeout_s)
    return int(n or 0)


# ----------------------------------------------------- fleet assembly
def deploy_disaggregated(model: Dict[str, Any], engine: Dict[str, Any],
                         *, name: str = "llm", num_prefill: int = 1,
                         num_decode: int = 1,
                         decode_slots: Optional[int] = None,
                         kv_wire: Optional[str] = None,
                         migrate_prefixes: bool = False,
                         max_ongoing_requests: int = 100,
                         route_prefix: Optional[str] = None
                         ) -> DisaggRouter:
    """Deploy ``{name}-prefill`` + ``{name}-decode`` LLMServer fleets
    sharing one model/engine config (same seed => identical params =>
    bit-exact hand-off) and return the :class:`DisaggRouter` over them.
    This is the ``disaggregate=`` surface: the decode fleet can run
    more ``decode_slots`` than a colocated replica since it never
    interleaves prefill chunks; ``kv_wire`` picks the hand-off format;
    ``migrate_prefixes`` arms the controller's drain-time warm-prefix
    migration on the decode fleet."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    eng = dict(engine)
    if kv_wire is not None:
        eng["kv_wire"] = kv_wire
    # the prefill fleet's engine traces under its own part so the
    # shared request id doesn't dedup its spans against decode's
    pre_eng = dict(eng, trace_part="prefill")
    dec_eng = dict(eng)
    if decode_slots is not None:
        dec_eng["decode_slots"] = decode_slots
    for suffix, ecfg, n, migrate in (
            ("prefill", pre_eng, num_prefill, False),
            ("decode", dec_eng, num_decode, migrate_prefixes)):
        dep = serve.deployment(
            name=f"{name}-{suffix}", num_replicas=n,
            max_ongoing_requests=max_ongoing_requests,
            migrate_prefixes=migrate)(serve.LLMServer)
        serve.run(dep.bind(model=model, engine=ecfg),
                  name=f"{name}-{suffix}", route_prefix=None)
    controller = serve_api._get_or_create_controller()
    if route_prefix is not None:
        # HTTP ingress: the proxy drives this pair via a DisaggRouter
        ray_tpu_torch.get(controller.register_disagg_route.remote(
            route_prefix, f"{name}-prefill", f"{name}-decode"))
    return DisaggRouter(f"{name}-prefill", f"{name}-decode", controller)
