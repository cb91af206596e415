"""Decoder-only transformer LM in PyTorch: the serving and training
subsets of ``ray_tpu/models/transformer.py``.

Two block styles behind one config:

- ``"gptj"``: parallel attention + MLP residual off one LayerNorm
  (GPT-J-6B: rotary over the first 64 of 256 head dims, untied LM head
  with bias, tanh GELU).
- ``"llama"``: sequential pre-RMSNorm blocks, SwiGLU MLP, full-dim neox
  rotary, optional GQA (``n_kv_heads < n_heads``).

Parameters are a plain dict with the JAX package's tree and names;
per-layer weights stay stacked on a leading ``[n_layers, ...]`` axis and
each forward pass unbinds them once into per-layer views (so the
backward stacks each leaf's per-layer gradients in one pass). Norm
scales and biases are f32. Matrices are cast to the compute dtype
(``config.dtype``) at each use, as in the JAX package: a trainer holds
f32 masters (:func:`init_params`' default), a server may hold them in
the compute dtype already, where the cast returns the tensor itself.

Serving: a paged KV cache ``[n_layers, num_blocks, block_size,
kv_heads, head_dim]`` written by chunked :func:`prefill` and batched
single-token :func:`decode_step`, with attention through
``ops.paged_attention`` (the hand-written paged kernel on the card).

Training: :func:`hidden_states` / :func:`apply` / :func:`lm_loss` over
:func:`run_layers`, with causal attention through
``ops.multihead_attention`` (the flash kernels on the card) and the
chunked fused LM-head loss. Rematerialization is a named policy
(:func:`remat_policy_fn`): ``"none"``, ``"full"`` (recompute each block
in the backward) or ``"dots"`` (selective checkpointing that saves the
matmul outputs and the flash op's output, and recomputes the rest).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops import (apply_rotary, cross_entropy_loss,
                               fused_lm_head_loss, layer_norm,
                               multihead_attention, paged_attention,
                               rms_norm, rotary_table)

REMAT_POLICIES = ("full", "none", "dots", "dots_all", "offload")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config, so one
    kwargs dict builds either (with ``dtype`` a torch dtype here).
    ``remat``/``remat_policy``, ``ce_chunk_size`` and ``attn_*`` are the
    training path's; the ``paged_*`` fields the serving path's."""
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
    # fields mirror the JAX package's: the kernel's rows per block tile
    # (decode, and prefill chunks when set), rounded up to 16, 32 or 64;
    # 0 picks ops.paged_flash.default_paged_block_r. The JAX autotuner
    # that fills them is not ported.
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

    @property
    def resolved_remat_policy(self) -> str:
        """Effective remat policy, honoring the legacy ``remat`` bool."""
        if self.remat is not None:
            return "full" if self.remat else "none"
        return self.remat_policy

    @property
    def num_active_params(self) -> int:
        """Params touched per token (dense configs: all of them)."""
        if not self.n_experts:
            return self.num_params
        raise NotImplementedError("the port does not run MoE configs yet")

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate train FLOPs/token (6·N active params + attention),
        the JAX package's formula."""
        s = seq_len or self.max_seq_len
        attn = 12 * self.n_layers * self.n_heads * self.head_dim * s
        return 6.0 * self.num_active_params + attn


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
                device=None, dtype: torch.dtype = torch.float32) -> Dict:
    """Random weights from ``seed`` in the JAX package's tree: matrices
    N(0, 0.02) with the residual-out matrices scaled by 1/sqrt(2L), drawn
    directly in ``dtype``; norm scales are ones and biases zeros, in f32.
    ``dtype`` defaults to f32, the masters a trainer updates (as in the
    JAX package); a server passes its compute dtype and holds no f32 copy
    of a 6B-parameter model. The numbers differ from the JAX package's
    (another generator); tests carry weights over with
    ``_bridge.params_from_jax``."""
    c = config
    if c.n_experts:
        raise NotImplementedError("the port does not run MoE configs yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = dtype
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


# ---------------------------------------------------------------- layers
def _unbind_layers(layer_params: Dict) -> list:
    """Per-layer dicts of views of the stacked ``[n, ...]`` leaves, each
    leaf unbound once: under autograd the backward of one ``unbind``
    stacks the per-layer gradients in one pass (indexing each layer
    would write a zero-filled ``[n, ...]`` gradient per layer)."""
    names = list(layer_params)
    cols = [torch.unbind(layer_params[n], 0) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def _final_norm(c: TransformerConfig, params: Dict, x: torch.Tensor):
    fn = params["final_norm"]
    if c.block_style == "llama":
        return rms_norm(x, fn["scale"])
    return layer_norm(x, fn["scale"], fn["bias"])


def _lm_head(c: TransformerConfig, params: Dict, x: torch.Tensor):
    """Logits in the compute dtype, as the JAX package's ``apply``."""
    logits = x.to(c.dtype) @ params["lm_head"]["w"].to(c.dtype)
    if c.block_style != "llama":
        logits = logits + params["lm_head"]["b"].to(c.dtype)
    return logits


# ----------------------------------------------------------------- remat
#: ops whose outputs the "dots" policy saves: the matmuls without batch
#: dims (q/k/v/o projections and the MLP's) and the flash forward op,
#: whose (O, LSE) is the attention output JAX saves by name
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.ray_tpu_torch.flash_attention_fwd.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy_fn(name: str):
    """Map a remat policy name to a selective-checkpoint policy function
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``).

    ``"full"`` returns ``None``: save nothing and recompute each block in
    the backward (the flash forward kernel runs twice per layer).
    ``"dots"`` saves the matmul outputs without batch dims (projections,
    MLP) and the flash op's output, so neither the flash kernel nor a
    projection re-runs in the backward; norms, rotary, activations and
    the reference path's batched score products are recomputed. On the
    reference attention path the attention output is recomputed (it is no
    op of its own there); the numbers are the same. ``"none"`` (no
    checkpointing) is the caller's branch, as in the JAX package.
    ``"dots_all"`` and ``"offload"`` are not ported yet."""
    if name == "full":
        return None
    if name == "dots":
        return _dots_policy
    if name in ("dots_all", "offload"):
        raise NotImplementedError(
            f"remat policy {name!r} is not ported yet; use 'none', 'full' "
            f"or 'dots'")
    raise ValueError(
        f"unknown remat policy {name!r}; have {REMAT_POLICIES}")


# --------------------------------------------------------------- forward
def _attention(c: TransformerConfig, q, k, v):
    """Causal attention through the ops layer's dispatcher (single
    device: the JAX package's ring over a sequence axis is not ported)."""
    return multihead_attention(q, k, v, causal=True, impl=c.attn_impl,
                               block_q=c.attn_block_q, block_k=c.attn_block_k)


def _attn_sublayer(c: TransformerConfig, h, lp, sin, cos, layout):
    """qkv projection -> rotary -> GQA repeat -> attention -> output
    projection. Shared by both block styles (only the rotary layout
    differs)."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(c, h, lp)
    q = apply_rotary(q, sin, cos, layout=layout)
    k = apply_rotary(k, sin, cos, layout=layout)
    if c.kv_heads != c.n_heads:
        rep = c.n_heads // c.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    att = _attention(c, q, k, v)
    return att.reshape(b, s, c.n_heads * c.head_dim) @ lp["wo"].to(c.dtype)


def _gptj_block(c: TransformerConfig, x, lp, attn):
    """Parallel attention + MLP residual off one LayerNorm; ``attn(h,
    lp)`` is the attention sublayer (training or paged serving)."""
    h = layer_norm(x, lp["ln_scale"], lp["ln_bias"])
    return x + (attn(h, lp) + _mlp_sublayer(c, h, lp)).to(x.dtype)


def _llama_block(c: TransformerConfig, x, lp, attn):
    """Sequential pre-RMSNorm attention then MLP."""
    h = rms_norm(x, lp["attn_norm"])
    x = x + attn(h, lp).to(x.dtype)
    h2 = rms_norm(x, lp["mlp_norm"]).to(c.dtype)
    return x + _mlp_sublayer(c, h2, lp).to(x.dtype)


def _rotary(c: TransformerConfig, length: int, device):
    """(sin, cos, layout) of the config's rotary embedding."""
    sin, cos = rotary_table(
        length, c.rotary_dim if c.block_style == "gptj" else c.head_dim,
        c.rope_base, device=device)
    return sin, cos, "gptj" if c.block_style == "gptj" else "neox"


def run_layers(config: TransformerConfig, layer_params: Dict,
               x: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """The transformer blocks in ``layer_params`` (leaves stacked
    ``[n, ...]``) over hidden states ``x``: (b, s, e) -> ((b, s, e),
    moe_aux), one block per layer under the config's remat policy."""
    c = config
    if c.n_experts:
        raise NotImplementedError("the port does not run MoE configs yet")
    sin, cos, layout = _rotary(c, x.shape[1], x.device)
    block = _gptj_block if c.block_style == "gptj" else _llama_block
    attn = functools.partial(_attn_sublayer, c, sin=sin, cos=cos,
                             layout=layout)
    body = functools.partial(block, c, attn=attn)
    policy = c.resolved_remat_policy
    kwargs = {}
    if policy != "none":
        fn = remat_policy_fn(policy)
        if fn is not None:
            kwargs["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, fn)
    for lp in _unbind_layers(layer_params):
        if policy == "none":
            x = body(x, lp)
        else:
            x = checkpoint(body, x, lp, use_reentrant=False,
                           preserve_rng_state=False, **kwargs)
    return x, 0.0


def hidden_states(config: TransformerConfig, params: Dict,
                  input_ids: torch.Tensor):
    """Embed -> blocks -> final norm: (b, s) ids -> ((b, s, e), moe_aux),
    the trunk under both :func:`apply` and :func:`lm_loss`."""
    c = config
    x = F.embedding(input_ids.long(), params["embed"]).to(c.dtype)
    x, moe_aux = run_layers(c, params["layers"], x)
    return _final_norm(c, params, x), moe_aux


def apply(config: TransformerConfig, params: Dict, input_ids: torch.Tensor,
          return_moe_aux: bool = False):
    """Forward pass: (batch, seq) ids -> (batch, seq, vocab) logits in
    the compute dtype; with ``return_moe_aux`` also the MoE aux loss (0.0
    for dense configs)."""
    x, moe_aux = hidden_states(config, params, input_ids)
    logits = _lm_head(config, params, x)
    return (logits, moe_aux) if return_moe_aux else logits


def lm_loss(config: TransformerConfig, params: Dict,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Next-token LM loss. ``batch``: ``{"input_ids": (b, s), "loss_mask":
    optional (b, s)}``. Returns ``(loss, {"n_tokens": n})``. With
    ``config.ce_chunk_size > 0`` (default) the LM-head projection is fused
    into the chunked cross entropy; ``0`` materializes the logits."""
    c = config
    ids = batch["input_ids"]
    labels = ids[:, 1:]
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    if c.ce_chunk_size:
        x, _ = hidden_states(c, params, ids)
        head = params["lm_head"]
        loss, n = fused_lm_head_loss(
            x.to(c.dtype)[:, :-1], head["w"], labels,
            head_bias=head.get("b"), mask=mask, chunk_size=c.ce_chunk_size)
    else:
        logits = apply(c, params, ids)
        loss, n = cross_entropy_loss(logits[:, :-1], labels, mask=mask)
    return loss, {"n_tokens": n}


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
    """Dense MLP on normed input h, matrices cast to the compute dtype at
    use. GPT-J's GELU is the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    dt = c.dtype
    if c.block_style == "llama":
        gate = F.silu(h @ lp["w_gate"].to(dt))
        up = h @ lp["w_up"].to(dt)
        return (gate * up) @ lp["w_down"].to(dt)
    mlp = h.to(dt) @ lp["fc_in"].to(dt) + lp["fc_in_b"].to(dt)
    mlp = F.gelu(mlp, approximate="tanh")
    return mlp @ lp["fc_out"].to(dt) + lp["fc_out_b"].to(dt)


def _project_qkv(c: TransformerConfig, h: torch.Tensor, lp: Dict):
    """q [b, s, H, D] and k, v [b, s, KVH, D] from normed input h, in the
    compute dtype (the JAX package's ``einsum("bse,ehd->bshd")``)."""
    b, s, _ = h.shape
    dt = c.dtype
    hd = h.to(dt)
    return ((hd @ lp["wq"].to(dt)).view(b, s, c.n_heads, c.head_dim),
            (hd @ lp["wk"].to(dt)).view(b, s, c.kv_heads, c.head_dim),
            (hd @ lp["wv"].to(dt)).view(b, s, c.kv_heads, c.head_dim))


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
    b, s, _ = h.shape
    q, k, v = _project_qkv(c, h, lp)
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

    # a prefill chunk (s > 1) may carry its own row tile, as in the JAX
    # package; 0 picks ops.paged_flash.default_paged_block_r
    br = c.paged_block_r_prefill if (s > 1 and c.paged_block_r_prefill) \
        else c.paged_block_r
    att = paged_attention(q.contiguous(), kc, vc, block_tables, positions,
                          lens=lens, impl=c.paged_impl, block_r=br or None)
    return att.reshape(b, s, c.n_heads * c.head_dim) @ lp["wo"].to(c.dtype)


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
    sin, cos, layout = _rotary(c, window, ids.device)
    rot_positions = positions.clamp(max=window - 1)
    plan = _write_plan(block_tables, positions, write_mask, bs)
    block_tables = block_tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    x = params["embed"][ids.long()].to(c.dtype)

    block = _gptj_block if c.block_style == "gptj" else _llama_block
    for li, lp in enumerate(_unbind_layers(params["layers"])):
        attn = functools.partial(
            _paged_attn_sublayer, c, sin=sin, cos=cos, layout=layout,
            kc=cache["k"][li], vc=cache["v"][li], block_tables=block_tables,
            positions=positions, rot_positions=rot_positions, plan=plan,
            lens=lens)
        x = block(c, x, lp, attn)

    return _lm_head(c, params, _final_norm(c, params, x))


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


class Transformer:
    """Convenience wrapper binding a config: ``init`` / ``apply`` /
    ``loss``."""

    def __init__(self, config: TransformerConfig):
        self.config = config

    def init(self, seed: int = 0, device=None) -> Dict:
        return init_params(self.config, seed, device)

    def apply(self, params, input_ids):
        return apply(self.config, params, input_ids)

    def loss(self, params, batch):
        return lm_loss(self.config, params, batch)
