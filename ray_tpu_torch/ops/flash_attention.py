"""Flash attention on the card: a forward kernel and its three backward
kernels, with the autograd op the model calls.

Replaces the Pallas TPU kernels of ``ray_tpu/ops/flash_attention.py``
(``_fwd_kernel``, ``_delta_kernel``, ``_dkdv_kernel``, ``_dq_kernel``)
with hand-written CUDA kernels, built for Hopper (``sm_90a``) at first
use and bound with :mod:`ctypes`. bf16 goes to the warp-specialised
``wgmma`` kernels (a TMA producer warp feeding a shared-memory ring,
consumer warpgroups on the tensor cores): the forward in
``csrc/flash_fwd_sm90.cu``, dK/dV and dQ in ``csrc/flash_bwd_sm90.cu``.
f32 goes to the ``mma.sync`` kernels of ``csrc/flash_attention.cu``
(an exact f32 emulation), and delta runs there for both dtypes. Each
dtype has exactly one kernel of each kind.

What bounds them on the H100: operations. The forward and the dK/dV and
dQ passes do 4, 8 and 6 x head_dim flops per (row, key) pair against a
few bytes per pair, far above the ~295 flop/B at which the bf16 tensor
cores become the limit, so their products run on the tensor cores from
tiles staged in shared memory, and causal tiles above the diagonal are
skipped. ``delta = rowsum(dO * O)`` is bound by the bytes of O and dO.
See the sources for the tiles.

Layout: the kernels read ``(batch, seq, heads, head_dim)`` as the model's
projections produce it, and write LSE and delta as ``[B, H, Sq]`` f32.
Causality is end-aligned (query i sees keys ``<= i + sk - sq``); a causal
call with ``sq > sk`` would leave rows with no visible key and is
rejected. Each wrapper (:func:`flash_fwd`, :func:`flash_delta`,
:func:`flash_dkdv`, :func:`flash_dq`) launches its kernel for a CUDA
tensor and raises if it cannot (a bf16 call on a card other than sm_90
included), runs its plain PyTorch version (``*_plain``) for a CPU
tensor, and counts launches in ``<wrapper>.kernel_launches``.

The forward is registered as the custom op
``ray_tpu_torch::flash_attention_fwd`` with its backward (delta, dK/dV,
dQ kernels) attached, so selective activation checkpointing can save
its (O, LSE) outputs by name: under the ``"dots"`` remat policy the
forward kernel runs once per layer per step.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_SM90_SOURCE = "flash_fwd_sm90.cu"
_SM90_BWD_SOURCE = "flash_bwd_sm90.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
#: the forward kernel's tile: query rows x keys per step, per warp group
#: of the bf16 kernel (a block holds two of them, 128 rows) and per block
#: of the f32 kernel (the backward kernels use their own fixed tiles, see
#: the sources)
BLOCK_Q = 64
BLOCK_K = 64


def default_flash_blocks(seq_q: int, seq_k: int,
                         head_dim: int) -> Tuple[int, int]:
    """(block_q, block_k) of the forward kernel on the H100: 64 x 64 at
    every shape. The kernel masks a ragged last tile, so the blocks need
    not divide the sequence (the TPU kernel's did)."""
    del seq_q, seq_k, head_dim
    return BLOCK_Q, BLOCK_K


def check_flash_blocks(block_q: Optional[int], block_k: Optional[int]):
    """Raise unless the blocks asked for are the kernels' (``None`` or 0
    takes them)."""
    bq, bk = block_q or BLOCK_Q, block_k or BLOCK_K
    if (bq, bk) != (BLOCK_Q, BLOCK_K):
        raise ValueError(
            f"the flash kernels' tiles are fixed at block_q={BLOCK_Q}, "
            f"block_k={BLOCK_K}; got ({bq}, {bk})")


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                 else sm_scale)


# ------------------------------------------------------------ plain versions
def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """Scaled f32 scores [B, H, Sq, Sk], end-aligned causal mask -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None):
    """The forward kernel's function in plain PyTorch: ``(O [B, Sq, H, D]
    in q's dtype, LSE [B, H, Sq] f32)``, scores and softmax in f32."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype).contiguous(), lse.contiguous()


def flash_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, [B, Sq, H, D] -> [B, H, Sq]."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _dscores(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """P recomputed from the LSE and dS = P * (dO V^T - delta) * scale,
    both [B, H, Sq, Sk] f32 (masked entries of P are exactly 0)."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_dkdv_plain(q, k, v, do, lse, delta, *, causal: bool = False,
                     sm_scale: Optional[float] = None):
    """The dK/dV kernel's function: ``dV = P^T dO``, ``dK = dS^T Q`` in
    f32, returned in k's and v's dtypes ([B, Sk, H, D])."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, _scale(q, sm_scale))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_dq_plain(q, k, v, do, lse, delta, *, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """The dQ kernel's function: ``dQ = dS K`` in f32, in q's dtype."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, _scale(q, sm_scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) \
        .to(q.dtype).contiguous()


# ------------------------------------------------------------------ kernels
def _library():
    from ray_tpu_torch._build import load_library
    lib = load_library(_SOURCE)
    if lib.flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers (inputs, then outputs); B Sq Sk H D; scale causal
        # dtype stream
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.flash_delta.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.flash_dkdv.argtypes = [p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, f, i, i, p]
        lib.flash_dq.argtypes = [p, p, p, p, p, p, p,
                                 i, i, i, i, i, f, i, i, p]
        for fn in (lib.flash_fwd, lib.flash_delta, lib.flash_dkdv,
                   lib.flash_dq):
            fn.restype = ctypes.c_int
    return lib


def _sm90_library():
    from ray_tpu_torch._build import load_library
    lib = load_library(_SM90_SOURCE)
    if lib.flash_fwd_sm90.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q k v o lse; B Sq Sk H D; scale causal stream
        lib.flash_fwd_sm90.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, p]
        lib.flash_fwd_sm90.restype = ctypes.c_int
    return lib


def _sm90_bwd_library():
    from ray_tpu_torch._build import load_library
    lib = load_library(_SM90_BWD_SOURCE)
    if lib.flash_dkdv_sm90.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q k v do lse delta, outputs; B Sq Sk H D; scale causal stream
        lib.flash_dkdv_sm90.argtypes = [p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, f, i, p]
        lib.flash_dq_sm90.argtypes = [p, p, p, p, p, p, p,
                                      i, i, i, i, i, f, i, p]
        lib.flash_bwd_sm90_smem.argtypes = [i, i]
        for fn in (lib.flash_dkdv_sm90, lib.flash_dq_sm90,
                   lib.flash_bwd_sm90_smem):
            fn.restype = ctypes.c_int
    return lib


def _require_sm90(dev: torch.device, name: str) -> None:
    """The bf16 kernels use wgmma, TMA and setmaxnreg, which exist only on
    sm_90 (H100/H200): raise on any other card."""
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"the bf16 {name} kernel needs an sm_90 card "
                           f"(H100/H200), got sm_{cap[0]}{cap[1]}")


def _check_qkv(q, k, v, causal: bool) -> None:
    """Shape rules of every flash function, on any device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if causal and sq > k.shape[1]:
        raise ValueError(
            f"causal flash attention needs sq <= sk (end-aligned rows "
            f"before the first key would see nothing); got sq={sq}, "
            f"sk={k.shape[1]}")


def _check_kernel(name: str, tensors) -> torch.device:
    """What the CUDA kernels take: float32 or bfloat16 (one dtype for the
    [B, S, H, D] operands), head_dim a multiple of 8 up to 256, one CUDA
    device, contiguous, 16-byte aligned."""
    first = tensors[0][1]
    dev, dtype = first.device, first.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel runs on cuda, got {dev}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    d = first.shape[-1]
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head_dim a multiple of 8 up "
                         f"to {_MAX_HEAD_DIM}, got {d}")
    for tname, t in tensors:
        want = torch.float32 if tname in ("lse", "delta") else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {tname} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, sm_scale: Optional[float] = None):
    """Flash forward: ``q [B, Sq, H, D]``, ``k, v [B, Sk, H, D]`` ->
    ``(O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32)``. A CUDA tensor
    goes to its dtype's kernel (bf16: ``flash_fwd_sm90``; f32: the
    ``mma.sync`` kernel), and one it cannot take raises; a CPU tensor
    goes to :func:`flash_fwd_plain`."""
    _check_qkv(q, k, v, causal)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=scale)
    dev = _check_kernel("flash_fwd", (("q", q), ("k", k), ("v", v)))
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, k.shape[1], h, d, scale, int(causal))
    with torch.cuda.device(dev):
        if q.dtype == torch.bfloat16:
            _require_sm90(dev, "flash forward")
            err = _sm90_library().flash_fwd_sm90(*args, _stream(dev))
        else:
            err = _library().flash_fwd(*args, _DTYPE_CODES[q.dtype],
                                       _stream(dev))
    _raise_on(err, "flash_fwd")
    flash_fwd.kernel_launches += 1
    return o, lse


flash_fwd.kernel_launches = 0


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32: ``[B, Sq, H, D]`` x2 ->
    ``[B, H, Sq]``. A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`flash_delta_plain`."""
    if o.shape != do.shape or o.dim() != 4:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must be one [B, S, H, D] shape")
    if o.device.type == "cpu":
        return flash_delta_plain(o, do)
    dev = _check_kernel("flash_delta", (("o", o), ("do", do)))
    b, s, h, d = o.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().flash_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, s, h, d,
            _DTYPE_CODES[o.dtype], _stream(dev))
    _raise_on(err, "flash_delta")
    flash_delta.kernel_launches += 1
    return delta


flash_delta.kernel_launches = 0


def _check_bwd(q, k, v, do, lse, delta, causal: bool) -> None:
    _check_qkv(q, k, v, causal)
    b, sq, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq):
            raise ValueError(f"{name} must be [B, H, Sq] = {(b, h, sq)}, "
                             f"got {tuple(t.shape)}")


def flash_dkdv(q, k, v, do, lse, delta, *, causal: bool = False,
               sm_scale: Optional[float] = None):
    """dK and dV (``[B, Sk, H, D]`` in k's and v's dtypes) from the saved
    LSE and delta. A CUDA tensor goes to its dtype's kernel (bf16:
    ``flash_dkdv_sm90``; f32: the ``mma.sync`` kernel), and one it cannot
    take raises; a CPU tensor goes to :func:`flash_dkdv_plain`."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_dkdv_plain(q, k, v, do, lse, delta, causal=causal,
                                sm_scale=scale)
    dev = _check_kernel("flash_dkdv", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
        ("delta", delta)))
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], h, d, scale, int(causal))
    with torch.cuda.device(dev):
        if q.dtype == torch.bfloat16:
            _require_sm90(dev, "flash dK/dV")
            err = _sm90_bwd_library().flash_dkdv_sm90(*args, _stream(dev))
        else:
            err = _library().flash_dkdv(*args, _DTYPE_CODES[q.dtype],
                                        _stream(dev))
    _raise_on(err, "flash_dkdv")
    flash_dkdv.kernel_launches += 1
    return dk, dv


flash_dkdv.kernel_launches = 0


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = False,
             sm_scale: Optional[float] = None) -> torch.Tensor:
    """dQ (``[B, Sq, H, D]`` in q's dtype) from the saved LSE and delta.
    A CUDA tensor goes to its dtype's kernel (bf16: ``flash_dq_sm90``;
    f32: the ``mma.sync`` kernel), and one it cannot take raises; a CPU
    tensor goes to :func:`flash_dq_plain`."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal=causal,
                              sm_scale=scale)
    dev = _check_kernel("flash_dq", (
        ("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
        ("delta", delta)))
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, k.shape[1], h, d, scale, int(causal))
    with torch.cuda.device(dev):
        if q.dtype == torch.bfloat16:
            _require_sm90(dev, "flash dQ")
            err = _sm90_bwd_library().flash_dq_sm90(*args, _stream(dev))
        else:
            err = _library().flash_dq(*args, _DTYPE_CODES[q.dtype],
                                      _stream(dev))
    _raise_on(err, "flash_dq")
    flash_dq.kernel_launches += 1
    return dq


flash_dq.kernel_launches = 0


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False,
              sm_scale: Optional[float] = None):
    """The whole backward: delta once, then dK/dV and dQ from it.
    Returns ``(dq, dk, dv)``."""
    do = do.contiguous()
    delta = flash_delta(o, do)
    dk, dv = flash_dkdv(q, k, v, do, lse, delta, causal=causal,
                        sm_scale=sm_scale)
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


# ------------------------------------------------------------- autograd op
@torch.library.custom_op("ray_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as an op of its own (see the module docstring):
    ``(O, LSE)`` of :func:`flash_fwd`."""
    return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)


@flash_attention_fwd.register_fake
def _(q, k, v, causal, sm_scale):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                           sm_scale=ctx.sm_scale)
    return dq, dk, dv, None, None


flash_attention_fwd.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention over ``(B, S, H, D)``, the layout
    the kernels read: the model's path, with no transposes."""
    _check_qkv(q, k, v, causal)
    o, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), bool(causal),
                               _scale(q, sm_scale))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention over ``(batch, heads, seq, head_dim)``, the JAX
    package's layout at this layer, differentiable: the forward kernel
    and, in the backward, the delta, dK/dV and dQ kernels (their plain
    versions on the CPU). ``block_q`` / ``block_k`` of ``None`` (or 0)
    take the kernels' tiles; other values raise, since the tiles are
    fixed at build time."""
    check_flash_blocks(block_q, block_k)
    o = flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             sm_scale=sm_scale)
    return o.transpose(1, 2)
