"""Decoder-only transformer LM in PyTorch: the serving subset of
``ray_tpu/models/transformer.py``.

Two block styles behind one config:

- ``"gptj"``: parallel attention + MLP residual off one LayerNorm
  (GPT-J-6B: rotary over the first 64 of 256 head dims, untied LM head
  with bias, tanh GELU).
- ``"llama"``: sequential pre-RMSNorm blocks, SwiGLU MLP, full-dim neox
  rotary, optional GQA (``n_kv_heads < n_heads``).

Parameters are a plain dict with the JAX package's tree and names;
per-layer weights stay stacked on a leading ``[n_layers, ...]`` axis and
the forward pass loops over layers on views of them. Matrices are held
in the compute dtype (``config.dtype``); norm scales and biases in f32.

The serving path: a paged KV cache ``[n_layers, num_blocks, block_size,
kv_heads, head_dim]`` written by chunked :func:`prefill` and batched
single-token :func:`decode_step`, with attention through
``ops.paged_attention`` (the hand-written kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import (apply_rotary, layer_norm, paged_attention,
                               rms_norm, rotary_table)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config, so one
    kwargs dict builds either (with ``dtype`` a torch dtype here).
    Training-only fields are kept and unused by the serving path."""
    vocab_size: int = 50400
    d_model: int = 4096
    n_layers: int = 28
    n_heads: int = 16
    head_dim: int = 256
    n_kv_heads: Optional[int] = None        # GQA; None = n_heads
    d_ff: int = 16384
    max_seq_len: int = 2048
    rotary_dim: int = 64                     # gptj rotates a prefix
    rope_base: float = 10000.0
    block_style: str = "gptj"               # "gptj" | "llama"
    dtype: Any = torch.bfloat16              # compute dtype
    remat: Optional[bool] = None
    remat_policy: str = "dots"
    ce_chunk_size: int = 512
    attn_impl: str = "auto"
    attn_block_q: int = 0
    attn_block_k: int = 0
    # Paged attention (serving): "auto" runs the CUDA kernel on a CUDA
    # tensor and its plain version on the CPU; "kernel" forces the
    # kernel; "reference" the whole-window gather. The two block_r
    # fields carry the JAX autotuner's result, which the port does not
    # have: they are accepted and unused (the kernel's wrapper picks
    # ops.paged_flash.default_paged_block_r).
    paged_impl: str = "auto"
    paged_block_r: int = 0
    paged_block_r_prefill: int = 0
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def num_params(self) -> int:
        """Parameter count of a dense config."""
        e, v, h = self.d_model, self.vocab_size, self.n_heads * self.head_dim
        kvh = self.kv_heads * self.head_dim
        per_layer = e * h + 2 * e * kvh + h * e
        if self.block_style == "llama":
            per_layer += 3 * e * self.d_ff + 2 * e
        else:
            per_layer += 2 * e * self.d_ff + self.d_ff + e + 2 * e
        total = v * e + self.n_layers * per_layer
        total += e if self.block_style == "llama" else 2 * e
        total += e * v + (v if self.block_style == "gptj" else 0)
        return total


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another.
    With no CUDA device and none named, raise: there is no fallback to
    the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ray_tpu_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ------------------------------------------------------------------ init
def init_params(config: TransformerConfig, seed: int = 0,
                device=None) -> Dict:
    """Random weights from ``seed`` in the JAX package's tree. Each
    matrix is drawn directly in the compute dtype (no f32 copy of a
    6B-parameter model), N(0, 0.02) with the residual-out matrices
    scaled by 1/sqrt(2L); norm scales are ones and biases zeros, in f32.
    The numbers differ from the JAX package's (another generator); tests
    carry weights over with ``_bridge.params_from_jax``."""
    c = config
    if c.n_experts:
        raise NotImplementedError("the port does not serve MoE configs yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = c.dtype
    h = c.n_heads * c.head_dim
    kvh = c.kv_heads * c.head_dim
    L = c.n_layers
    out_scale = 0.02 / (2 * L) ** 0.5

    def mat(shape, scale=0.02):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return w.mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    layers = {
        "wq": mat((L, c.d_model, h)),
        "wk": mat((L, c.d_model, kvh)),
        "wv": mat((L, c.d_model, kvh)),
        "wo": mat((L, h, c.d_model), out_scale),
    }
    if c.block_style == "llama":
        layers.update({
            "w_gate": mat((L, c.d_model, c.d_ff)),
            "w_up": mat((L, c.d_model, c.d_ff)),
            "w_down": mat((L, c.d_ff, c.d_model), out_scale),
            "attn_norm": ones(L, c.d_model),
            "mlp_norm": ones(L, c.d_model),
        })
        final = {"scale": ones(c.d_model)}
        head = {"w": mat((c.d_model, c.vocab_size))}
    else:
        layers.update({
            "fc_in": mat((L, c.d_model, c.d_ff)),
            "fc_in_b": zeros(L, c.d_ff),
            "fc_out": mat((L, c.d_ff, c.d_model), out_scale),
            "fc_out_b": zeros(L, c.d_model),
            "ln_scale": ones(L, c.d_model),
            "ln_bias": zeros(L, c.d_model),
        })
        final = {"scale": ones(c.d_model), "bias": zeros(c.d_model)}
        head = {"w": mat((c.d_model, c.vocab_size)),
                "b": zeros(c.vocab_size)}
    return {"embed": mat((c.vocab_size, c.d_model)), "layers": layers,
            "final_norm": final, "lm_head": head}


# ------------------------------------------------------- inference (KV)
def init_kv_cache(config: TransformerConfig, num_blocks: int,
                  block_size: int, device=None) -> Dict[str, torch.Tensor]:
    """The paged KV cache: ``{"k", "v"}`` of shape ``[n_layers,
    num_blocks, block_size, kv_heads, head_dim]`` in the compute dtype,
    zero-filled (a zero key scores 0, so the reserved trash block is
    numerically harmless)."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, num_blocks, block_size, c.kv_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev)}


def _mlp_sublayer(c: TransformerConfig, h: torch.Tensor, lp: Dict):
    """Dense MLP on normed input h. GPT-J's GELU is the tanh
    approximation, which is ``jax.nn.gelu``'s default."""
    dt = c.dtype
    if c.block_style == "llama":
        gate = F.silu(h @ lp["w_gate"])
        up = h @ lp["w_up"]
        return (gate * up) @ lp["w_down"]
    mlp = h.to(dt) @ lp["fc_in"] + lp["fc_in_b"].to(dt)
    mlp = F.gelu(mlp, approximate="tanh")
    return mlp @ lp["fc_out"] + lp["fc_out_b"].to(dt)


def _write_plan(block_tables: torch.Tensor, positions: torch.Tensor,
                write_mask: Optional[torch.Tensor], block_size: int):
    """Flat pool slots ``block * bs + pos % bs`` for this call's tokens,
    and the rows of ``[B*C]`` that are written (None = all). Positions
    masked out by ``write_mask`` are dropped, never written; their page
    index is clamped only so the lookup stays in bounds."""
    t = block_tables.shape[1]
    pos = positions.long()
    page = (pos // block_size).clamp(max=t - 1)
    bid = torch.gather(block_tables.long(), 1, page)
    dst = (bid * block_size + pos % block_size).reshape(-1)
    if write_mask is None:
        return dst, None
    rows = write_mask.reshape(-1).nonzero().squeeze(1)
    return dst[rows], rows


def _paged_attn_sublayer(c: TransformerConfig, h, lp, sin, cos, layout,
                         kc, vc, block_tables, positions, rot_positions,
                         plan, lens):
    """Project q/k/v for the new tokens, rotate them at their absolute
    positions, write k/v into the layer's cache blocks IN PLACE, then
    attend against the updated paged cache. ``kc``/``vc`` are one
    layer's ``[N, bs, KVH, D]`` views of the cache."""
    b, s, e = h.shape
    dt = c.dtype
    hd = h.to(dt)
    q = (hd @ lp["wq"]).view(b, s, c.n_heads, c.head_dim)
    k = (hd @ lp["wk"]).view(b, s, c.kv_heads, c.head_dim)
    v = (hd @ lp["wv"]).view(b, s, c.kv_heads, c.head_dim)
    q = apply_rotary(q, sin, cos, positions=rot_positions, layout=layout)
    k = apply_rotary(k, sin, cos, positions=rot_positions, layout=layout)

    dst, rows = plan
    n, bs = kc.shape[0], kc.shape[1]
    k_new = k.reshape(b * s, c.kv_heads, c.head_dim).to(kc.dtype)
    v_new = v.reshape(b * s, c.kv_heads, c.head_dim).to(vc.dtype)
    if rows is not None:
        k_new, v_new = k_new[rows], v_new[rows]
    # in place: the cache is the engine's one copy (JAX returns a new
    # array from a donated buffer instead)
    kc.view(n * bs, c.kv_heads, c.head_dim).index_copy_(0, dst, k_new)
    vc.view(n * bs, c.kv_heads, c.head_dim).index_copy_(0, dst, v_new)

    att = paged_attention(q.contiguous(), kc, vc, block_tables, positions,
                          lens=lens, impl=c.paged_impl)
    return att.reshape(b, s, c.n_heads * c.head_dim) @ lp["wo"]


def _forward_with_cache(c: TransformerConfig, params: Dict,
                        ids: torch.Tensor, cache: Dict[str, torch.Tensor],
                        block_tables: torch.Tensor,
                        positions: torch.Tensor,
                        write_mask: Optional[torch.Tensor],
                        lens: torch.Tensor) -> torch.Tensor:
    """Shared trunk of :func:`prefill` and :func:`decode_step`: (B, C)
    token ids at absolute ``positions`` -> (B, C, vocab) logits, writing
    each layer's k/v into the paged cache as it goes. ``lens`` (B,) is
    each sequence's live token count including this call's writes."""
    if c.n_experts:
        raise NotImplementedError(
            "paged decode does not support MoE configs yet")
    bs = cache["k"].shape[2]
    window = block_tables.shape[1] * bs
    # the rotary table spans the table window (not max_seq_len), as in
    # the JAX package; padded positions past it are clamped for the
    # lookup only (their rows are discarded)
    sin, cos = rotary_table(
        window, c.rotary_dim if c.block_style == "gptj" else c.head_dim,
        c.rope_base, device=ids.device)
    layout = "gptj" if c.block_style == "gptj" else "neox"
    rot_positions = positions.clamp(max=window - 1)
    plan = _write_plan(block_tables, positions, write_mask, bs)
    block_tables = block_tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    x = params["embed"][ids.long()].to(c.dtype)

    layers = params["layers"]
    for li in range(c.n_layers):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        kc, vc = cache["k"][li], cache["v"][li]
        if c.block_style == "gptj":
            h = layer_norm(x, lp["ln_scale"], lp["ln_bias"])
            att = _paged_attn_sublayer(c, h, lp, sin, cos, layout, kc, vc,
                                       block_tables, positions,
                                       rot_positions, plan, lens)
            mlp = _mlp_sublayer(c, h, lp)
            x = x + (att + mlp).to(x.dtype)
        else:
            h = rms_norm(x, lp["attn_norm"])
            att = _paged_attn_sublayer(c, h, lp, sin, cos, layout, kc, vc,
                                       block_tables, positions,
                                       rot_positions, plan, lens)
            x = x + att.to(x.dtype)
            h2 = rms_norm(x, lp["mlp_norm"]).to(c.dtype)
            x = x + _mlp_sublayer(c, h2, lp).to(x.dtype)

    fn = params["final_norm"]
    if c.block_style == "llama":
        x = rms_norm(x, fn["scale"])
    else:
        x = layer_norm(x, fn["scale"], fn["bias"])
    logits = x.to(c.dtype) @ params["lm_head"]["w"]
    if c.block_style != "llama":
        logits = logits + params["lm_head"]["b"].to(c.dtype)
    return logits


def prefill(config: TransformerConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], block_tables: torch.Tensor,
            start_pos: torch.Tensor, lens: torch.Tensor):
    """One prompt chunk per sequence, writing its cache blocks.

    ``tokens`` (B, C): chunk ``start_pos[b] .. start_pos[b]+lens[b]-1``
    of each prompt, zero-padded past ``lens[b]``. Chunk token i attends
    every cached position ``<= start_pos + i``. Returns ``(logits
    (B, C, vocab), cache)`` with the cache updated in place; the first
    generated token comes from ``logits[b, lens[b]-1]`` of the FINAL
    chunk."""
    b, chunk = tokens.shape
    ar = torch.arange(chunk, dtype=torch.int32, device=tokens.device)
    positions = start_pos.to(torch.int32)[:, None] + ar
    write_mask = ar[None, :] < lens.to(torch.int32)[:, None]
    live = (start_pos + lens).to(torch.int32)
    logits = _forward_with_cache(config, params, tokens, cache,
                                 block_tables, positions, write_mask, live)
    return logits, cache


def decode_step(config: TransformerConfig, params: Dict,
                token_ids: torch.Tensor, cache: Dict[str, torch.Tensor],
                block_tables: torch.Tensor, seq_lens: torch.Tensor):
    """One batched decode step: each sequence's newest token (``token_ids``
    (B,), at absolute position ``seq_lens[b]``) is written to its cache
    block and attends every earlier position. Returns ``(logits
    (B, vocab), cache)`` with the cache updated in place."""
    positions = seq_lens.to(torch.int32)[:, None]
    logits = _forward_with_cache(config, params, token_ids[:, None], cache,
                                 block_tables, positions, None,
                                 seq_lens.to(torch.int32) + 1)
    return logits[:, 0], cache
