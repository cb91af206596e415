"""Decoder-only transformer LM in PyTorch: the serving and training
subsets of ``ray_tpu/models/transformer.py``.

Two block styles behind one config:

- ``"gptj"``: parallel attention + MLP residual off one LayerNorm
  (GPT-J-6B: rotary over the first 64 of 256 head dims, untied LM head
  with bias, tanh GELU).
- ``"llama"``: sequential pre-RMSNorm blocks, SwiGLU MLP, full-dim neox
  rotary, optional GQA (``n_kv_heads < n_heads``).

With ``n_experts > 0`` every layer's MLP is a mixture of experts
(``models/moe.py``: Switch top-1 routing with a capacity), and the LM
loss adds ``moe_aux_weight`` times the load-balancing term.

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
``ops.multihead_attention`` (the flash kernels on the card; over a mesh
with ``sp > 1`` the ring, ``ops.ring_attention``) and the chunked fused
LM-head loss. Rematerialization is a named policy
(:func:`remat_policy_fn`): ``"none"``, ``"full"`` (recompute each block
in the backward) or ``"dots"`` (selective checkpointing that saves the
matmul outputs and the flash op's output, and recomputes the rest).

Pipelines: :func:`stage_slice_params` cuts the one-device tree into
stage chunks, :func:`stage_forward` and :func:`stage_loss` run one chunk,
and :func:`merge_stage_params` joins the chunks back
(``parallel/mpmd_pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.models.moe import (moe_layer, moe_logical_axes,
                                      moe_param_shapes)
from ray_tpu_torch.ops import (apply_rotary, cross_entropy_loss,
                               fused_lm_head_loss, layer_norm,
                               multihead_attention, paged_attention,
                               ring_attention, rms_norm, rotary_table)
from ray_tpu_torch.parallel.collective import (_all_gather, _all_reduce,
                                               copy_to_region, gather_shards,
                                               gather_slices,
                                               reduce_from_region)
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, axis_group, axis_sizes
from ray_tpu_torch.parallel.sharding import (FSDP_RULES, constrain,
                                             param_specs, spec_axes)

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
        """Parameter count (for MFU accounting)."""
        e, v, h = self.d_model, self.vocab_size, self.n_heads * self.head_dim
        kvh = self.kv_heads * self.head_dim
        per_layer = e * h + 2 * e * kvh + h * e
        if self.n_experts:
            per_layer += e * self.n_experts \
                + self.n_experts * 2 * e * self.d_ff + 2 * e
        elif self.block_style == "llama":
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
        """Params touched per token: with Switch top-1 routing only one
        expert's MLP runs per token, so FLOPs count none of the rest."""
        if not self.n_experts:
            return self.num_params
        inactive = self.n_layers * (self.n_experts - 1) \
            * 2 * self.d_model * self.d_ff
        return self.num_params - inactive

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
def init_leaves(config: TransformerConfig, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32):
    """``(path, tensor)`` of every leaf of :func:`init_params`' tree, one
    at a time, in the order it draws them from ``seed``'s generator: a
    caller that keeps a slice of each leaf (the sharded init) frees the
    rest before the next is drawn, and holds the same numbers."""
    c = config
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(int(seed))
    h = c.n_heads * c.head_dim
    kvh = c.kv_heads * c.head_dim
    L, e = c.n_layers, c.d_model
    out_scale = 0.02 / (2 * L) ** 0.5

    def mat(shape, scale=0.02):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    yield ("layers", "wq"), mat((L, e, h))
    yield ("layers", "wk"), mat((L, e, kvh))
    yield ("layers", "wv"), mat((L, e, kvh))
    yield ("layers", "wo"), mat((L, h, e), out_scale)
    if c.n_experts:             # JAX's sorted order of the MoE leaves
        for name, shape in sorted(moe_param_shapes(c).items()):
            yield ("layers", name), mat(
                (L,) + shape, out_scale if name == "moe_wo" else 0.02)
        if c.block_style == "llama":
            yield ("layers", "attn_norm"), ones(L, e)
            yield ("layers", "mlp_norm"), ones(L, e)
            yield ("final_norm", "scale"), ones(e)
            yield ("lm_head", "w"), mat((e, c.vocab_size))
        else:
            yield ("layers", "ln_scale"), ones(L, e)
            yield ("layers", "ln_bias"), zeros(L, e)
            yield ("final_norm", "scale"), ones(e)
            yield ("final_norm", "bias"), zeros(e)
            yield ("lm_head", "w"), mat((e, c.vocab_size))
            yield ("lm_head", "b"), zeros(c.vocab_size)
    elif c.block_style == "llama":
        yield ("layers", "w_gate"), mat((L, e, c.d_ff))
        yield ("layers", "w_up"), mat((L, e, c.d_ff))
        yield ("layers", "w_down"), mat((L, c.d_ff, e), out_scale)
        yield ("layers", "attn_norm"), ones(L, e)
        yield ("layers", "mlp_norm"), ones(L, e)
        yield ("final_norm", "scale"), ones(e)
        yield ("lm_head", "w"), mat((e, c.vocab_size))
    else:
        yield ("layers", "fc_in"), mat((L, e, c.d_ff))
        yield ("layers", "fc_in_b"), zeros(L, c.d_ff)
        yield ("layers", "fc_out"), mat((L, c.d_ff, e), out_scale)
        yield ("layers", "fc_out_b"), zeros(L, e)
        yield ("layers", "ln_scale"), ones(L, e)
        yield ("layers", "ln_bias"), zeros(L, e)
        yield ("final_norm", "scale"), ones(e)
        yield ("final_norm", "bias"), zeros(e)
        yield ("lm_head", "w"), mat((e, c.vocab_size))
        yield ("lm_head", "b"), zeros(c.vocab_size)
    yield ("embed",), mat((c.vocab_size, e))


def param_shapes(config: TransformerConfig) -> Dict:
    """The params' tree of global shapes, drawing nothing."""
    shapes: Dict = {"embed": None}
    for path, leaf in init_leaves(config, 0, "meta"):
        set_leaf(shapes, path, tuple(leaf.shape))
    return shapes


def set_leaf(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


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
    params: Dict = {"embed": None}
    for path, value in init_leaves(config, seed, device, dtype):
        set_leaf(params, path, value)
    return params


def logical_axes(config: TransformerConfig) -> Dict:
    """Tree (the params' structure) of logical-axis tuples, the JAX
    package's ``logical_axes``."""
    c = config
    common = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv"),
        "wv": ("layers", "embed", "kv"),
        "wo": ("layers", "heads", "embed"),
    }
    if c.n_experts:
        layers = {**common, **moe_logical_axes()}
        if c.block_style == "llama":
            layers.update({"attn_norm": ("layers", "embed"),
                           "mlp_norm": ("layers", "embed")})
            final = {"scale": ("embed",)}
            head = {"w": ("embed", "vocab")}
        else:
            layers.update({"ln_scale": ("layers", "embed"),
                           "ln_bias": ("layers", "embed")})
            final = {"scale": ("embed",), "bias": ("embed",)}
            head = {"w": ("embed", "vocab"), "b": ("vocab",)}
    elif c.block_style == "llama":
        layers = {**common,
                  "w_gate": ("layers", "embed", "mlp"),
                  "w_up": ("layers", "embed", "mlp"),
                  "w_down": ("layers", "mlp", "embed"),
                  "attn_norm": ("layers", "embed"),
                  "mlp_norm": ("layers", "embed")}
        final = {"scale": ("embed",)}
        head = {"w": ("embed", "vocab")}
    else:
        layers = {**common,
                  "fc_in": ("layers", "embed", "mlp"),
                  "fc_in_b": ("layers", "mlp"),
                  "fc_out": ("layers", "mlp", "embed"),
                  "fc_out_b": ("layers", "embed"),
                  "ln_scale": ("layers", "embed"),
                  "ln_bias": ("layers", "embed")}
        final = {"scale": ("embed",), "bias": ("embed",)}
        head = {"w": ("embed", "vocab"), "b": ("vocab",)}
    return {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": final,
        "lm_head": head,
    }


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
def _attention(c: TransformerConfig, q, k, v, seq=None):
    """Dispatch causal attention: the ring over ``seq`` (a sequence
    group of more than one rank), otherwise the ops layer's dispatcher
    (the flash kernels on the card)."""
    if seq is not None and seq.size > 1:
        return ring_attention(q, k, v, seq, causal=True)
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
    lp)`` is the attention sublayer (training or paged serving). Returns
    ``(x, moe)``, ``moe`` as :func:`_mlp_sublayer` gives it."""
    h = layer_norm(x, lp["ln_scale"], lp["ln_bias"])
    att = attn(h, lp)
    mlp, moe = _mlp_sublayer(c, h, lp)
    return x + (att + mlp).to(x.dtype), moe


def _llama_block(c: TransformerConfig, x, lp, attn):
    """Sequential pre-RMSNorm attention then MLP."""
    h = rms_norm(x, lp["attn_norm"])
    x = x + attn(h, lp).to(x.dtype)
    h2 = rms_norm(x, lp["mlp_norm"]).to(c.dtype)
    mlp, moe = _mlp_sublayer(c, h2, lp)
    return x + mlp.to(x.dtype), moe


def _rotary(c: TransformerConfig, length: int, device):
    """(sin, cos, layout) of the config's rotary embedding."""
    sin, cos = rotary_table(
        length, c.rotary_dim if c.block_style == "gptj" else c.head_dim,
        c.rope_base, device=device)
    return sin, cos, "gptj" if c.block_style == "gptj" else "neox"


def _run_blocks(c: TransformerConfig, layer_params: Dict, x: torch.Tensor,
                body, after=None):
    """``body(x, lp) -> (x, moe)`` for each layer of ``layer_params``
    under the config's remat policy (``after(x)`` once a block is done).
    Returns ``x`` and the layers' ``moe`` terms (None for dense
    blocks)."""
    policy = c.resolved_remat_policy
    kwargs = {}
    if policy != "none":
        fn = remat_policy_fn(policy)
        if fn is not None:
            kwargs["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, fn)
    terms = []
    for lp in _unbind_layers(layer_params):
        if policy == "none":
            x, moe = body(x, lp)
        else:
            x, moe = checkpoint(body, x, lp, use_reentrant=False,
                                preserve_rng_state=False, **kwargs)
        terms.append(moe)
        if after is not None:
            after(x)
    return x, terms


def _moe_totals(terms):
    """The MoE terms of a stack of blocks: ``(aux, stats)``, the aux terms
    summed over the layers and the ``[n_layers, 2]`` stats (each layer's
    whole aux value and dropped share); ``(0.0, None)`` for dense
    blocks."""
    if not terms or terms[0] is None:
        return 0.0, None
    return sum(a for a, _ in terms), torch.stack([st for _, st in terms])


def _moe_report(aux: Dict, stats) -> None:
    """``aux["moe_aux"]`` (the whole term, summed over the layers) and
    ``aux["moe_dropped"]`` (each layer's share of dropped tokens)."""
    aux["moe_aux"] = stats[:, 0].sum()
    aux["moe_dropped"] = stats[:, 1]


def run_layers(config: TransformerConfig, layer_params: Dict,
               x: torch.Tensor, mesh=None,
               rules=None) -> Tuple[torch.Tensor, float]:
    """The transformer blocks in ``layer_params`` (leaves stacked
    ``[n, ...]``) over hidden states ``x``: (b, s, e) -> ((b, s, e),
    moe_aux), one block per layer under the config's remat policy.
    Under ``mesh`` (a ``build_mesh`` DeviceMesh; ``rules`` default to
    ``FSDP_RULES``) ``layer_params`` are this rank's shards and ``x`` its
    rows (see :func:`model_layout`)."""
    c = config
    if mesh is not None:
        lay = model_layout(c, mesh, rules)
        layers = gather_params(c, layer_params, lay.specs["layers"], lay)
        x, terms = _run_layers_sharded(c, layers, x, lay)
    else:
        x, terms = _run_layers(c, layer_params, x)
    return x, _moe_totals(terms)[0]


def _run_layers(c: TransformerConfig, layer_params: Dict, x: torch.Tensor):
    sin, cos, layout = _rotary(c, x.shape[1], x.device)
    block = _gptj_block if c.block_style == "gptj" else _llama_block
    attn = functools.partial(_attn_sublayer, c, sin=sin, cos=cos,
                             layout=layout)
    return _run_blocks(c, layer_params, x,
                       functools.partial(block, c, attn=attn))


def _trunk(c: TransformerConfig, params: Dict, input_ids: torch.Tensor):
    """Embed -> blocks -> final norm on one device: the hidden states and
    the layers' MoE terms."""
    x = F.embedding(input_ids.long(), params["embed"]).to(c.dtype)
    x, terms = _run_layers(c, params["layers"], x)
    return _final_norm(c, params, x), terms


def hidden_states(config: TransformerConfig, params: Dict,
                  input_ids: torch.Tensor, mesh=None, rules=None):
    """Embed -> blocks -> final norm: (b, s) ids -> ((b, s, e), moe_aux),
    the trunk under both :func:`apply` and :func:`lm_loss` (under
    ``mesh``: this rank's shards, rows and sequence chunk, and its share
    of ``moe_aux``, whose sum over the data axes is the term)."""
    c = config
    if mesh is not None:
        lay = model_layout(c, mesh, rules)
        x, terms = _trunk_sharded(c, gather_params(c, params, lay.specs,
                                                   lay), input_ids, lay)
    else:
        x, terms = _trunk(c, params, input_ids)
    return x, _moe_totals(terms)[0]


def apply(config: TransformerConfig, params: Dict, input_ids: torch.Tensor,
          mesh=None, rules=None, return_moe_aux: bool = False):
    """Forward pass: (batch, seq) ids -> (batch, seq, vocab) logits in
    the compute dtype; with ``return_moe_aux`` also the MoE aux loss (0.0
    for dense configs). Under ``mesh``: this rank's rows' (and sequence
    chunk's) logits over the whole vocabulary (gathered over the vocab
    axis), and this rank's share of the aux loss."""
    c = config
    if mesh is not None:
        lay = model_layout(c, mesh, rules)
        g = gather_params(c, params, lay.specs, lay)
        x, terms = _trunk_sharded(c, g, input_ids, lay)
        x = copy_to_region(x, lay.vocab)
        logits = gather_slices(_lm_head(c, g, x), 2, lay.vocab)
    else:
        x, terms = _trunk(c, params, input_ids)
        logits = _lm_head(c, params, x)
    return (logits, _moe_totals(terms)[0]) if return_moe_aux else logits


def lm_loss(config: TransformerConfig, params: Dict, batch: Dict,
            mesh=None, rules=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token LM loss. ``batch``: ``{"input_ids": (b, s), "loss_mask":
    optional (b, s)}``. Returns ``(loss, aux)`` with ``aux["n_tokens"]``;
    an MoE config adds ``moe_aux_weight`` times the Switch aux term (summed
    over the layers) to the loss and reports it as ``aux["moe_aux"]``,
    with each layer's share of tokens dropped for capacity as
    ``aux["moe_dropped"]``. With ``config.ce_chunk_size > 0`` (default)
    the LM-head projection is fused into the chunked cross entropy; ``0``
    materializes the logits.

    Under ``mesh`` ``params`` are this rank's shards and ``batch`` its
    rows (and, over ``sp``, its sequence chunk); the loss is the mean
    over every rank's unmasked tokens (each rank's masked sum over the
    global count, summed over the data axes, never a mean of per-rank
    means), the same on every rank. Gradients of sharded leaves come back
    reduce-scattered; those of leaves replicated over a data axis are
    this rank's share, which the train step sums."""
    if mesh is not None:
        lay = model_layout(config, mesh, rules)
        return lm_loss_sharded(config, params, batch, lay)
    c = config
    ids = batch["input_ids"]
    labels = ids[:, 1:]
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    x, terms = _trunk(c, params, ids)
    if c.ce_chunk_size:
        head = params["lm_head"]
        loss, n = fused_lm_head_loss(
            x.to(c.dtype)[:, :-1], head["w"], labels,
            head_bias=head.get("b"), mask=mask, chunk_size=c.ce_chunk_size)
    else:
        logits = _lm_head(c, params, x)
        loss, n = cross_entropy_loss(logits[:, :-1], labels, mask=mask)
    aux = {"n_tokens": n}
    if c.n_experts:
        moe_aux, stats = _moe_totals(terms)
        loss = loss + c.moe_aux_weight * moe_aux
        _moe_report(aux, stats)
    return loss, aux


# ------------------------------------------------------ pipeline stages
# The MPMD pipeline (parallel/mpmd_pipeline.py) splits the model into
# chunks: chunk 0 owns the embedding and the first layers, middle chunks
# own layer ranges, the last chunk owns its layers, the final norm and
# the LM head (its loss is stage_loss). Per-layer weights are stacked on
# the leading ``layers`` axis, so a chunk's parameters are ``leaf[lo:hi]``
# of the one-device tree, bit for bit.

def stage_layer_ranges(n_layers: int, n_stages: int):
    """Near-even contiguous ``[lo, hi)`` layer ranges, earlier stages
    taking the remainder (they also carry the embedding)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"n_stages must be in [1, {n_layers}], got {n_stages}")
    base, rem = divmod(n_layers, n_stages)
    ranges, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def stage_slice_params(config: TransformerConfig, params: Dict,
                       stage: int, n_stages: int) -> Dict:
    """One stage's slice of a parameter tree (tensors or numpy arrays):
    its range of the stacked layer leaves (views), plus the embedding
    (stage 0) and the final norm and LM head (the last stage)."""
    if config.n_experts:
        raise NotImplementedError(
            "pipeline stage splitting does not support MoE configs "
            "(the aux loss would need cross-stage wiring)")
    lo, hi = stage_layer_ranges(config.n_layers, n_stages)[stage]
    out: Dict = {"layers": {k: v[lo:hi]
                            for k, v in params["layers"].items()}}
    if stage == 0:
        out["embed"] = params["embed"]
    if stage == n_stages - 1:
        out["final_norm"] = params["final_norm"]
        out["lm_head"] = params["lm_head"]
    return out


def merge_stage_params(config: TransformerConfig,
                       chunk_params: Dict[int, Dict]) -> Dict:
    """Inverse of :func:`stage_slice_params`: the one-device tree from
    the slices of chunks ``0..K-1`` (keyed by chunk). Works on any
    param-shaped tree of tensors or numpy arrays, Adam moments
    included."""
    if not chunk_params:
        raise ValueError("missing chunks: got an empty chunk set")
    K = max(chunk_params) + 1
    missing = [c for c in range(K) if c not in chunk_params]
    if missing or "final_norm" not in chunk_params[K - 1]:
        raise ValueError(
            f"missing chunks: have {sorted(chunk_params)}, need a "
            f"contiguous 0..K-1 set ending in the final-norm/LM-head "
            f"chunk")
    first = chunk_params[0]["layers"]

    def cat(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, 0)
        return np.concatenate(xs, 0)

    return {"layers": {k: cat([chunk_params[c]["layers"][k]
                               for c in range(K)]) for k in first},
            "embed": chunk_params[0]["embed"],
            "final_norm": chunk_params[K - 1]["final_norm"],
            "lm_head": chunk_params[K - 1]["lm_head"]}


def stage_forward(config: TransformerConfig, stage: int, n_stages: int,
                  stage_params: Dict, inp: torch.Tensor) -> torch.Tensor:
    """One stage's forward: stage 0 embeds (b, s) token ids; later stages
    take the upstream (b, s, e) activation. The last stage applies the
    final norm, so its output feeds :func:`stage_loss`. The output is in
    the compute dtype, what crosses to the next stage."""
    c = config
    if stage == 0:
        x = F.embedding(inp.long(), stage_params["embed"]).to(c.dtype)
    else:
        x = inp.to(c.dtype)
    x, _ = run_layers(c, stage_params["layers"], x)
    if stage == n_stages - 1:
        x = _final_norm(c, stage_params, x)
    return x


def stage_loss(config: TransformerConfig, stage_params: Dict,
               h: torch.Tensor, input_ids: torch.Tensor,
               loss_mask: Optional[torch.Tensor] = None):
    """The last stage's LM loss from final-normed hidden states ``h``:
    :func:`lm_loss`'s fused LM-head loss (``ce_chunk_size > 0``) or its
    materialized logits. Returns ``(loss, n)``."""
    c = config
    labels = input_ids[:, 1:]
    mask = loss_mask[:, 1:] if loss_mask is not None else None
    head = stage_params["lm_head"]
    if c.ce_chunk_size:
        return fused_lm_head_loss(
            h.to(c.dtype)[:, :-1], head["w"], labels,
            head_bias=head.get("b"), mask=mask, chunk_size=c.ce_chunk_size)
    logits = _lm_head(c, stage_params, h)
    return cross_entropy_loss(logits[:, :-1], labels, mask=mask)


# ------------------------------------------------------- sharded forward
# Under a mesh every rank holds its shards of the params (as
# parallel.sharding.shard_params places them) and its rows of the batch.
# The storage axes of the "embed" rule (fsdp) are gathered before use;
# "heads"/"mlp" split the attention heads and the MLP over one axis
# (column-parallel q/k/v and fc_in, row-parallel wo and fc_out, whose
# partial sums are all-reduced, the Megatron layout that JAX's constraint
# of each block's output to ("batch", "sequence", None) implies);
# "vocab" splits the embedding and the LM head (vocab-parallel).
# "sequence" (sp) splits each row's positions in contiguous chunks:
# rotary positions are global, attention is the ring over sp, and sp is
# a data axis for the loss and the gradients. "expert" (ep) splits the
# MoE experts; the tokens are not split over it (models/moe.py).

@dataclasses.dataclass
class ModelLayout:
    """How this rank's shards of a model sit on a mesh."""
    mesh: Any
    rules: Any
    specs: Dict                 # the spec of every param leaf
    storage: Tuple[str, ...]    # the "embed" axes, gathered before use
    heads: Any                  # AxisGroup heads and MLP are split over
    vocab: Any                  # AxisGroup the vocabulary is split over
    kv_split: bool              # k/v heads split as well (rules' "kv")
    data: Any                   # AxisGroup of the batch and sequence axes
    seq: Any                    # AxisGroup the sequence is split over
    experts: Any                # AxisGroup the MoE experts are split over
    transport: Any              # collective.GradTransport of the gathers


def _one_axis(rules, name: str) -> Optional[str]:
    axes = spec_axes(rules.get(name))
    if len(axes) > 1:
        raise NotImplementedError(
            f"the port splits {name!r} over one mesh axis, not {axes}")
    return axes[0] if axes else None


def model_layout(config: TransformerConfig, mesh, rules=None,
                 transport=None) -> ModelLayout:
    """Check that ``config`` can run on ``mesh`` under ``rules`` (default
    ``FSDP_RULES``) and say how: "embed" may map only to batch axes (its
    shards are gathered), "heads" and "mlp" to one axis together, "kv"
    and "vocab" to that axis or None, "sequence" and "expert" to one axis
    each outside those; heads, kv heads, d_ff, vocab and experts must
    divide. A ``pp`` axis that no rule names replicates the step over it,
    as the JAX package's GSPMD step does (every pp rank computes the same
    step); the pipelines over ``pp`` are ``ops.pipeline.pipeline_apply``
    and ``parallel.ParallelPlan(pp=...)``."""
    from ray_tpu_torch.parallel.collective import FP32
    rules = FSDP_RULES if rules is None else rules
    axis_sizes(mesh)                  # raises TypeError for a JAX Mesh
    if spec_axes(rules.get("layers")):
        raise NotImplementedError("the port keeps the layers axis whole")
    batch = set(spec_axes(rules.get("batch")))
    storage = spec_axes(rules.get("embed"))
    if not set(storage) <= batch or \
            tuple(a for a in AXIS_ORDER if a in storage) != storage:
        raise NotImplementedError(
            f"'embed' maps to {storage}: the port gathers embed shards "
            f"over batch axes {tuple(batch)} only, listed in AXIS_ORDER")
    split = _one_axis(rules, "heads")
    if _one_axis(rules, "mlp") != split:
        raise NotImplementedError("'heads' and 'mlp' must map to one axis")
    kv = _one_axis(rules, "kv")
    vocab = _one_axis(rules, "vocab")
    if kv not in (None, split) or vocab not in (None, split):
        raise NotImplementedError(
            f"'kv' and 'vocab' map to None or to {split!r}")
    seq, expert = _one_axis(rules, "sequence"), _one_axis(rules, "expert")
    if {seq, expert} & (batch | {split}) - {None} or \
            (seq is not None and seq == expert):
        raise NotImplementedError(
            f"'sequence' ({seq!r}) and 'expert' ({expert!r}) map to axes "
            f"of their own, not the batch's or the heads'")
    heads_g = axis_group(mesh, split)
    for what, n in (("n_heads", config.n_heads), ("d_ff", config.d_ff)) + \
            ((("n_kv_heads", config.kv_heads),) if kv else ()):
        if n % heads_g.size:
            raise ValueError(f"{what} {n} not divisible by {split}="
                             f"{heads_g.size}")
    experts_g = axis_group(mesh, expert)
    if config.n_experts % experts_g.size:
        raise ValueError(f"n_experts {config.n_experts} not divisible by "
                         f"{expert}={experts_g.size}")
    return ModelLayout(mesh=mesh, rules=rules,
                       specs=param_specs(logical_axes(config), rules),
                       storage=storage, heads=heads_g,
                       vocab=axis_group(mesh, vocab), kv_split=bool(kv),
                       data=axis_group(mesh, tuple(batch) + (
                           (seq,) if seq else ())),
                       seq=axis_group(mesh, seq), experts=experts_g,
                       transport=FP32 if transport is None else transport)


def gather_params(c: TransformerConfig, params: Dict, specs: Dict,
                  lay: ModelLayout) -> Dict:
    """Every leaf of ``params`` (shards) joined over the storage axes
    (``gather_shards``: all-gather forward, reduce-scatter backward);
    per-layer matrices are cast to the compute dtype first, so the wire
    carries what the products read. Dims split over the heads or vocab
    axis stay split."""
    def one(x, spec, cast):
        for d, entry in enumerate(spec):
            axes = spec_axes(entry)
            if axes and set(axes) <= set(lay.storage):
                return gather_shards(x, d, axis_group(lay.mesh, axes),
                                     c.dtype if cast else None,
                                     lay.transport)
        return x
    if "layers" not in specs:       # a layers tree alone
        return {k: one(v, specs[k], v.dim() >= 3) for k, v in params.items()}
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = gather_params(c, v, specs[k], lay)
        elif isinstance(v, dict):
            out[k] = {n: one(t, specs[k][n], False) for n, t in v.items()}
        else:
            out[k] = one(v, specs[k], False)
    return out


def _kv_weight_to_tp(w: torch.Tensor, group) -> torch.Tensor:
    """wk/wv on their way into the heads' split. ``FSDP_RULES`` and
    ``DDP_RULES`` map "kv" to None: wk and wv are replicated over the
    heads axis while wq is split over it, so each rank projects only the
    k/v heads its own q heads read and its gradient of wk/wv is its
    heads' share. Identity forward, all-reduce backward: the gradients
    are summed over the axis (``llama2-tiny``'s GQA in the tests)."""
    return copy_to_region(w, group)


def _local_kv(c: TransformerConfig, hd, lp, lay: ModelLayout, hl: int,
              sin, cos, layout):
    """k and v (rotated) for this rank's ``hl`` q heads: [b, s, hl, D]
    each, kv head ``j // rep`` for q head ``j`` as the GQA repeat
    gives."""
    b, s, _ = hd.shape
    dt, D = c.dtype, c.head_dim
    rep = c.n_heads // c.kv_heads
    if lay.kv_split:
        first = 0
        wk, wv = lp["wk"].to(dt), lp["wv"].to(dt)
        heads = torch.arange(hl, device=hd.device) // rep
    else:
        q0 = lay.heads.rank * hl
        first, last = q0 // rep, (q0 + hl - 1) // rep + 1
        cols = slice(first * D, last * D)
        wk = _kv_weight_to_tp(lp["wk"].to(dt), lay.heads)[:, cols]
        wv = _kv_weight_to_tp(lp["wv"].to(dt), lay.heads)[:, cols]
        heads = (q0 + torch.arange(hl, device=hd.device)) // rep - first
    k = apply_rotary((hd @ wk).view(b, s, -1, D), sin, cos, layout=layout)
    v = (hd @ wv).view(b, s, -1, D)
    if k.shape[2] != hl:
        k, v = k.index_select(2, heads), v.index_select(2, heads)
    return k, v


def _attn_part(c: TransformerConfig, h, lp, sin, cos, layout,
               lay: ModelLayout):
    """This rank's heads of the attention sublayer: its share of the
    output projection (row-parallel; the caller all-reduces it)."""
    b, s, _ = h.shape
    dt = c.dtype
    hl = c.n_heads // lay.heads.size
    hd = h.to(dt)
    q = apply_rotary((hd @ lp["wq"].to(dt)).view(b, s, hl, c.head_dim),
                     sin, cos, layout=layout)
    k, v = _local_kv(c, hd, lp, lay, hl, sin, cos, layout)
    att = _attention(c, q, k, v, lay.seq)
    return att.reshape(b, s, hl * c.head_dim) @ lp["wo"].to(dt)


def _mlp_part(c: TransformerConfig, h, lp):
    """This rank's slice of the MLP (column-parallel in, row-parallel
    out, no output bias): its share of the output."""
    dt = c.dtype
    if c.block_style == "llama":
        gate = F.silu(h @ lp["w_gate"].to(dt))
        return (gate * (h @ lp["w_up"].to(dt))) @ lp["w_down"].to(dt)
    mlp = h.to(dt) @ lp["fc_in"].to(dt) + lp["fc_in_b"].to(dt)
    return F.gelu(mlp, approximate="tanh") @ lp["fc_out"].to(dt)


def _gptj_block_sharded(c: TransformerConfig, x, lp, sin, cos, layout,
                        lay: ModelLayout):
    """The GPT-J block with heads and MLP split: one all-reduce sums the
    attention and MLP shares, and the output bias is added once after
    it. An MoE MLP routes on the normed input itself (whole on every
    rank) and its share, summed over the experts, joins the attention's
    before the all-reduce."""
    ln = layer_norm(x, lp["ln_scale"], lp["ln_bias"])
    h = copy_to_region(ln, lay.heads)
    part = _attn_part(c, h, lp, sin, cos, layout, lay)
    if c.n_experts:
        mlp, aux, stats = moe_layer(c, lp, ln, lay, h)
        out = reduce_from_region(part + mlp, lay.heads)
        return x + out.to(x.dtype), (aux, stats)
    part = part + _mlp_part(c, h, lp)
    out = reduce_from_region(part, lay.heads) + lp["fc_out_b"].to(c.dtype)
    return x + out.to(x.dtype), None


def _llama_block_sharded(c: TransformerConfig, x, lp, sin, cos, layout,
                         lay: ModelLayout):
    h = copy_to_region(rms_norm(x, lp["attn_norm"]), lay.heads)
    x = x + reduce_from_region(_attn_part(c, h, lp, sin, cos, layout, lay),
                               lay.heads).to(x.dtype)
    ln2 = rms_norm(x, lp["mlp_norm"]).to(c.dtype)
    h2 = copy_to_region(ln2, lay.heads)
    if c.n_experts:
        mlp, aux, stats = moe_layer(c, lp, ln2, lay, h2)
        return x + reduce_from_region(mlp, lay.heads).to(x.dtype), \
            (aux, stats)
    return x + reduce_from_region(_mlp_part(c, h2, lp),
                                  lay.heads).to(x.dtype), None


def _run_layers_sharded(c: TransformerConfig, layers: Dict, x, lay):
    s = x.shape[1]
    sin, cos, layout = _rotary(c, s * lay.seq.size, x.device)
    if lay.seq.size > 1:         # this chunk's global positions
        sin = sin.narrow(0, lay.seq.rank * s, s)
        cos = cos.narrow(0, lay.seq.rank * s, s)
    block = _gptj_block_sharded if c.block_style == "gptj" \
        else _llama_block_sharded
    body = functools.partial(block, c, sin=sin, cos=cos, layout=layout,
                             lay=lay)
    return _run_blocks(c, layers, x, body, after=lambda out: constrain(
        out, lay.mesh, lay.rules, ("batch", "sequence", None)))


def _embed_sharded(c: TransformerConfig, embed, ids, lay: ModelLayout):
    """Vocab-parallel lookup: each rank looks up the ids in its slice
    (zeros elsewhere) and the rows are summed over the vocab axis."""
    if lay.vocab.size == 1:
        return F.embedding(ids.long(), embed).to(c.dtype)
    vl = embed.shape[0]
    local = ids.long() - lay.vocab.rank * vl
    inside = (local >= 0) & (local < vl)
    x = F.embedding(local.clamp(0, vl - 1), embed) * inside[..., None]
    return reduce_from_region(x, lay.vocab).to(c.dtype)


def _trunk_sharded(c: TransformerConfig, g: Dict, ids, lay: ModelLayout):
    """Embed -> blocks -> final norm over gathered params ``g``: the
    hidden states and the layers' MoE terms."""
    x = _embed_sharded(c, g["embed"], ids, lay)
    x, terms = _run_layers_sharded(c, g["layers"], x, lay)
    return _final_norm(c, g, x), terms


def _chunk_labels(ids, mask, seq):
    """Labels and their mask for every position of this rank's chunk of
    sequences split over ``seq``: the next token, the chunk's last
    position taking the next chunk's first; the last global position
    has none (mask 0)."""
    if mask is None:
        mask = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    firsts = _all_gather(ids[:, :1].contiguous(), seq)[:, :, 0]
    valid = _all_gather(mask[:, :1].float().contiguous(), seq)[:, :, 0]
    nxt = seq.rank + 1
    if nxt < seq.size:
        return (torch.cat([ids[:, 1:], firsts[nxt][:, None]], 1),
                torch.cat([mask[:, 1:].float(), valid[nxt][:, None]], 1))
    return (torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1),
            torch.cat([mask[:, 1:].float(),
                       torch.zeros_like(valid[0][:, None])], 1))


def lm_loss_sharded(c: TransformerConfig, params: Dict, batch: Dict,
                    lay: ModelLayout) -> Tuple[torch.Tensor, Dict]:
    """:func:`lm_loss` under ``lay``: ``params`` this rank's shards,
    ``batch`` its rows (and sequence chunk). The train step calls it with
    its own gradient transport in ``lay``. Over ``sp`` the logits are
    materialized, as the JAX package does for a sharded sequence."""
    ids = batch["input_ids"]
    mask = batch.get("loss_mask")
    seq_split = lay.seq.size > 1
    if seq_split:
        labels, mask = _chunk_labels(ids, mask, lay.seq)
    else:
        labels = ids[:, 1:]
        mask = mask[:, 1:] if mask is not None else None
    # the global batch's mean: each rank divides its masked sum by the
    # count over every data rank, and the losses are summed over them
    local_n = mask.float().sum() if mask is not None else torch.tensor(
        float(labels.numel()), device=ids.device)
    n = _all_reduce(local_n.reshape(1).clone(), lay.data)[0].clamp_min(1.0)
    g = gather_params(c, params, lay.specs, lay)
    x, terms = _trunk_sharded(c, g, ids, lay)
    x = copy_to_region(x, lay.vocab)
    head = g["lm_head"]
    if c.ce_chunk_size and not seq_split:
        loss, _ = fused_lm_head_loss(
            x.to(c.dtype)[:, :-1], head["w"], labels,
            head_bias=head.get("b"), mask=mask, chunk_size=c.ce_chunk_size,
            tp_group=lay.vocab, normalizer=n)
    else:
        logits = gather_slices(_lm_head(c, g, x), 2, lay.vocab)
        loss, _ = cross_entropy_loss(
            logits if seq_split else logits[:, :-1], labels, mask=mask,
            normalizer=n)
    aux = {"n_tokens": n}
    if c.n_experts:
        moe_aux, stats = _moe_totals(terms)
        loss = loss + c.moe_aux_weight * moe_aux
        _moe_report(aux, stats)
    return reduce_from_region(loss, lay.data), aux


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
    """Dense or MoE MLP on normed input h, matrices cast to the compute
    dtype at use: ``(out, moe)``, ``moe`` None for a dense MLP and
    ``(aux, stats)`` of :func:`~ray_tpu_torch.models.moe.moe_layer` for
    an MoE one. GPT-J's GELU is the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    dt = c.dtype
    if c.n_experts:
        out, aux, stats = moe_layer(c, lp, h.to(dt))
        return out, (aux, stats)
    if c.block_style == "llama":
        gate = F.silu(h @ lp["w_gate"].to(dt))
        up = h @ lp["w_up"].to(dt)
        return (gate * up) @ lp["w_down"].to(dt), None
    mlp = h.to(dt) @ lp["fc_in"].to(dt) + lp["fc_in_b"].to(dt)
    mlp = F.gelu(mlp, approximate="tanh")
    return mlp @ lp["fc_out"].to(dt) + lp["fc_out_b"].to(dt), None


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
    if c.n_experts:       # as the JAX package's paged path
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
        x, _ = block(c, x, lp, attn)

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
    ``loss`` plus the sharding-annotation tree."""

    def __init__(self, config: TransformerConfig):
        self.config = config

    def init(self, seed: int = 0, device=None) -> Dict:
        return init_params(self.config, seed, device)

    def logical_axes(self) -> Dict:
        return logical_axes(self.config)

    def apply(self, params, input_ids, mesh=None, rules=None):
        return apply(self.config, params, input_ids, mesh=mesh, rules=rules)

    def loss(self, params, batch, mesh=None, rules=None):
        return lm_loss(self.config, params, batch, mesh=mesh, rules=rules)
