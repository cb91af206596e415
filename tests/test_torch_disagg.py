"""The port's KV hand-off against the JAX package's, on the CPU: the wire
codec (bf16 bit-exact, int8 blockwise byte-identical to the JAX
package's numpy quantizer), payloads crossing between the packages both
ways, the engine-level hand-off (port to port, JAX export to port adopt,
port export to JAX adopt, each stream equal to the colocated JAX
stream), prefix-hit block skipping, and warm-prefix export and import.
Model and engine knobs are those of ``tests/serve/test_disagg.py``."""

import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.parallel import quantization as jax_quant
from ray_tpu.serve import disagg as jax_disagg
from ray_tpu.serve import llm_engine as jax_llm
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.parallel import quantization as quant
from ray_tpu_torch.serve import (EngineConfig, LLMEngine, disagg,
                                 kv_ship_bytes, pack_kv_blocks,
                                 unpack_kv_blocks)
from ray_tpu_torch.serve.llm_engine import _DONE

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                remat_policy="none")
ENGINE_KW = dict(decode_slots=4, kv_block_size=4, max_seq_len=48,
                 prefill_chunk=8, max_new_tokens=16)
SHAPE = (2, 5, 4, 2, 8)     # [n_layers, blocks, block_size, kvh, hd]


def _slab(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _bits(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


# ------------------------------------------------------------ quantizer
@pytest.mark.parametrize("numel", [1, 180, 256, 257, 1000, 4096 + 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_is_byte_identical_to_jax_numpy_twin(numel, dtype):
    """Values and scales of the tensor quantizer and of the port's numpy
    twin equal the JAX package's ``quantize_int8_np`` byte for byte
    (all-zero blocks, half-way ties and a zero-padded last block
    included); dequantization agrees too."""
    rng = np.random.default_rng(numel)
    x = (rng.standard_normal(numel) * rng.uniform(1e-3, 50)) \
        .astype(np.float32)
    x[::5] = 0.0
    if numel >= 256:
        x[:256] = 0.0                           # one all-zero block
    if numel >= 4:
        x[-4:] = [0.5, 1.5, -2.5, 127.0]        # ties after scaling
    t = torch.from_numpy(x).to(dtype)
    xs = t.float().numpy()                      # the values quantized
    want_q, want_s = jax_quant.quantize_int8_np(xs)
    got_q, got_s = quant.quantize_int8(t)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q.numpy().tobytes() == want_q.tobytes()
    assert got_s.numpy().tobytes() == want_s.tobytes()
    np_q, np_s = quant.quantize_int8_np(xs)
    assert np_q.tobytes() == want_q.tobytes()
    assert np_s.tobytes() == want_s.tobytes()
    want = jax_quant.dequantize_int8_np(want_q, want_s, shape=(numel,))
    got = quant.dequantize_int8(got_q, got_s, shape=(numel,))
    assert got.numpy().tobytes() == want.tobytes()
    assert quant.wire_bytes(numel) == \
        jax_quant.wire_bytes(numel) == got_q.numel() + 4 * got_s.numel()


# --------------------------------------------------------------- codec
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_wire_bf16_bit_exact(dtype):
    k, v = _slab(SHAPE, 1, dtype), _slab(SHAPE, 2, dtype)
    kv = pack_kv_blocks(k, v, wire="bf16")
    k2, v2 = unpack_kv_blocks(kv)
    assert k2.dtype == dtype and tuple(k2.shape) == SHAPE
    assert _bits(k2) == _bits(k) and _bits(v2) == _bits(v)
    assert kv["wire_bytes"] == 2 * k.numel() * k.element_size()


def test_kv_wire_bf16_without_a_numpy_bfloat16(monkeypatch):
    """With no extension's bfloat16 registered in numpy, a bf16 slab
    travels as its int16 bit pattern and still unpacks bit-exact."""
    monkeypatch.setattr(disagg, "_numpy_bf16", lambda: None)
    k, v = _slab(SHAPE, 3, torch.bfloat16), _slab(SHAPE, 4, torch.bfloat16)
    kv = pack_kv_blocks(k, v, wire="bf16")
    assert kv["k"].dtype == np.int16 and kv["dtype"] == "bfloat16"
    k2, v2 = unpack_kv_blocks(kv)
    assert _bits(k2) == _bits(k) and _bits(v2) == _bits(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_payloads_cross_between_packages_bit_exact(dtype):
    """A port payload unpacks in the JAX package, and a JAX payload in
    the port, to the same bits (bf16 wire) or the same dequantized
    values (int8 wire, byte-identical quantization)."""
    k, v = _slab(SHAPE, 5, dtype), _slab(SHAPE, 6, dtype)
    np_dtype = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    k_np = k.float().numpy().astype(np_dtype)
    v_np = v.float().numpy().astype(np_dtype)
    for wire in ("bf16", "int8"):
        port = pack_kv_blocks(k, v, wire=wire)
        ref = jax_disagg.pack_kv_blocks(k_np, v_np, wire=wire)
        assert port["shape"] == ref["shape"] and \
            port["dtype"] == ref["dtype"] == str(np.dtype(np_dtype))
        for name in ("k", "v", "k_scales", "v_scales"):
            assert (name in port) == (name in ref)
            if name in port:
                assert port[name].tobytes() == ref[name].tobytes(), name
        jk, jv = jax_disagg.unpack_kv_blocks(port)
        pk, pv = unpack_kv_blocks(ref)
        assert jk.dtype == np.dtype(np_dtype) and pk.dtype == dtype
        want_k, want_v = jax_disagg.unpack_kv_blocks(ref)
        assert jk.tobytes() == want_k.tobytes()
        assert jv.tobytes() == want_v.tobytes()
        assert _bits(pk) == want_k.tobytes()
        assert _bits(pv) == want_v.tobytes()
        if wire == "bf16":
            assert _bits(pk) == _bits(k)


def test_kv_wire_int8_uneven_last_block():
    shape = (1, 3, 6, 2, 5)   # numel 180: one partial quant block
    k, v = _slab(shape, 7), _slab(shape, 8)
    kv = pack_kv_blocks(k, v, wire="int8")
    assert kv["k"].dtype == np.int8 and kv["k_scales"].dtype == np.float32
    k2, v2 = unpack_kv_blocks(kv)
    assert tuple(k2.shape) == shape and k2.dtype == torch.float32
    for a, b in ((k, k2), (v, v2)):
        # symmetric int8: |err| <= max|x| / 127 per quant block
        assert (a - b).abs().max().item() <= \
            a.abs().max().item() / 127 + 1e-7
    assert kv["wire_bytes"] < 2 * k.numel() * 4


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_ship_bytes_equals_the_packed_size(wire, dtype):
    shape = (2, 8, 4, 2, 8)
    k, v = _slab(shape, 9, dtype), _slab(shape, 10, dtype)
    kv = pack_kv_blocks(k, v, wire=wire)
    nb = k.element_size()
    want = kv_ship_bytes(n_blocks=8, block_size=4, kv_heads=2, head_dim=8,
                         n_layers=2, wire=wire, dtype_bytes=nb)
    assert kv["wire_bytes"] == want == jax_disagg.kv_ship_bytes(
        n_blocks=8, block_size=4, kv_heads=2, head_dim=8, n_layers=2,
        wire=wire, dtype_bytes=nb)
    # GPT-J-6B: 458,752 B of KV a token; 22 blocks of 32 tokens
    assert kv_ship_bytes(22, 32, 16, 256, 28, "bf16") == 22 * 32 * 458752


def test_kv_wire_rejects_bad_input():
    k = _slab((1, 2, 4, 2, 8), 11)
    with pytest.raises(ValueError, match="wire"):
        pack_kv_blocks(k, k, wire="fp4")
    with pytest.raises(ValueError, match="shape"):
        pack_kv_blocks(k, k[:, :1], wire="bf16")
    with pytest.raises(ValueError, match="dtype"):
        pack_kv_blocks(k, k.to(torch.bfloat16), wire="bf16")
    with pytest.raises(ValueError, match="dtype"):
        pack_kv_blocks(k.to(torch.int32), k.to(torch.int32))
    kv = pack_kv_blocks(k, k, wire="bf16")
    with pytest.raises(ValueError, match="wire"):
        unpack_kv_blocks(dict(kv, wire="zstd"))
    with pytest.raises(ValueError, match="shape"):
        unpack_kv_blocks(dict(kv, shape=[1, 3, 4, 2, 8]))


# ----------------------------------------------- engine-level hand-off
@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**MODEL_KW, dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port(tree, **kw):
    cfg = TransformerConfig(**MODEL_KW, dtype=torch.float32)
    return LLMEngine(cfg, EngineConfig(**dict(ENGINE_KW, **kw)),
                     params=params_from_jax(tree, cfg, "cpu"),
                     device="cpu")


def _jax(weights, **kw):
    jcfg, jparams, _ = weights
    return jax_llm.LLMEngine(
        jcfg, jax_llm.EngineConfig(**dict(ENGINE_KW, **kw)), params=jparams)


@pytest.fixture(scope="module")
def engines(weights):
    """JAX: a colocated reference that also exports, and an adopter.
    Port: an exporter and an adopter."""
    engs = {"jax_ref": _jax(weights), "jax_dec": _jax(weights),
            "port_pre": _port(weights[2]), "port_dec": _port(weights[2])}
    yield engs
    for e in engs.values():
        e.shutdown()


def _drain(req, timeout_s=60.0):
    toks, deadline = [], time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            item = req.out.get(timeout=0.5)
        except Exception:
            continue
        if item is _DONE or item is jax_llm._DONE:
            return toks
        if isinstance(item, BaseException):
            raise item
        toks.append(item)
    raise TimeoutError("adopt stream did not finish")


@pytest.mark.parametrize("route", ["port_to_port", "jax_to_port",
                                   "port_to_jax"])
def test_handoff_streams_equal_the_colocated_jax_stream(engines, route):
    """prefill_export -> submit_adopt streams the colocated JAX engine's
    greedy tokens (first token included), whichever package exports and
    whichever adopts; both pools audit clean."""
    prompts = {"port_to_port": [7, 11, 13, 17, 19, 23, 29, 31, 37, 3],
               "jax_to_port": [8, 12, 14, 18, 20, 24, 30, 32, 38, 4, 6],
               "port_to_jax": [9, 13, 15, 19, 21, 25, 31, 33, 39]}
    prompt = prompts[route]
    pre = engines["jax_ref" if route == "jax_to_port" else "port_pre"]
    dec = engines["jax_dec" if route == "port_to_jax" else "port_dec"]
    want = list(engines["jax_ref"].generate_sync(prompt, 12))
    a0 = dec.stats()
    payload = pre.prefill_export(prompt)
    assert payload["n_blocks"] == -(-len(prompt) // 4) >= 2
    assert payload["wire"] == "bf16" and payload["block_size"] == 4
    # the port counts the arrays shipped; the JAX package adds its
    # serializer's framing
    ship = kv_ship_bytes(payload["n_blocks"], 4, 2, 8, 2, "bf16",
                         dtype_bytes=4)
    assert payload["wire_bytes"] == ship if pre is engines["port_pre"] \
        else ship <= payload["wire_bytes"] <= ship + 1024
    assert int(payload["first"]) == want[0]
    got = _drain(dec.submit_adopt(payload, max_new_tokens=12))
    assert got == want
    assert pre.pool_audit() == [] and dec.pool_audit() == []
    s = dec.stats()
    assert s["kv_adopts"] == a0["kv_adopts"] + 1
    assert s["kv_adopt_blocks"] - a0["kv_adopt_blocks"] == \
        payload["n_blocks"]
    assert s["kv_adopt_bytes"] - a0["kv_adopt_bytes"] == \
        payload["wire_bytes"]
    assert pre.stats()["kv_exports"] >= 1


def test_handoff_int8_first_token_exact_and_stream(weights, engines):
    """The int8 wire: the first token is computed before quantization, so
    it is exact; the port quantizes as the JAX package does, so the
    adopted stream is the JAX int8 test's (equal to the colocated stream
    for this seed)."""
    pre = _port(weights[2], kv_wire="int8")
    try:
        prompt = [5, 9, 14, 22, 33, 41, 2, 8, 12]
        want = list(engines["jax_ref"].generate_sync(prompt, 10))
        payload = pre.prefill_export(prompt)
        assert payload["wire"] == "int8"
        assert payload["kv"]["k"].dtype == np.int8
        assert payload["wire_bytes"] == kv_ship_bytes(
            3, 4, 2, 8, 2, "int8")
        got = _drain(engines["port_dec"].submit_adopt(payload, 10))
        assert got[0] == want[0]
        assert got == want
        assert engines["port_dec"].pool_audit() == []
        assert pre.stats()["kv_export_wall_s"] > 0
    finally:
        pre.shutdown()


def test_export_carries_the_first_logprob(weights):
    eng = _port(weights[2], capture_logprobs=True)
    try:
        prompt = [3, 5, 7, 9, 11, 13]
        want = list(eng.generate_sync(prompt, 2, detailed=True))[0]
        payload = eng.prefill_export(prompt)
        assert payload["first"] == want[0]
        assert payload["first_lp"] == pytest.approx(want[2], abs=1e-6)
        dec = _port(weights[2], capture_logprobs=True)
        try:
            got = _drain(dec.submit_adopt(payload, 2, detailed=True))
            assert got[0] == want
        finally:
            dec.shutdown()
    finally:
        eng.shutdown()


def test_adopt_block_size_mismatch_raises(engines):
    pre, dec = engines["port_pre"], engines["port_dec"]
    payload = pre.prefill_export([3, 5, 7, 9, 11])
    with pytest.raises(ValueError, match="block_size"):
        dec.submit_adopt(dict(payload, block_size=8), max_new_tokens=4)
    with pytest.raises(ValueError, match="block_size"):
        dec.import_warm_prefixes(dict(payload, block_size=8, chains=[]))
    assert pre.pool_audit() == [] and dec.pool_audit() == []


def test_adopt_prefix_hit_skips_shipped_blocks(engines):
    pre, dec = engines["port_pre"], engines["port_dec"]
    prompt = [2, 4, 6, 8, 10, 12, 14, 16, 18]   # 2 full blocks + tail
    s0 = dec.stats()
    got1 = _drain(dec.submit_adopt(pre.prefill_export(prompt), 4))
    s1 = dec.stats()
    got2 = _drain(dec.submit_adopt(pre.prefill_export(prompt), 4))
    s2 = dec.stats()
    first = s1["kv_adopt_blocks"] - s0["kv_adopt_blocks"]
    second = s2["kv_adopt_blocks"] - s1["kv_adopt_blocks"]
    assert got1 == got2
    assert (first, second) == (3, 1)             # the 2 full blocks hit
    assert s2["prefix_hit_blocks_total"] - s1["prefix_hit_blocks_total"] \
        == 2
    assert dec.pool_audit() == []


# ------------------------------------------------ warm-prefix migration
def test_export_warm_prefixes_hits_floor(weights):
    """Only chains proven warm ship: a once-used prefix stays; after a
    repeat its chain exports, and a survivor that imports it serves the
    prefix from its trie, with the victim's stream."""
    victim, survivor = _port(weights[2]), _port(weights[2])
    try:
        prefix = [3, 1, 4, 1, 5, 9, 2, 6]    # 2 full blocks
        list(victim.generate_sync(prefix + [30], 4))
        assert victim.export_warm_prefixes(min_hits=1) is None
        list(victim.generate_sync(prefix + [31], 4))
        payload = victim.export_warm_prefixes(min_hits=1)
        assert payload is not None and payload["n_blocks"] >= 2
        assert survivor.import_warm_prefixes(None) == 0
        assert survivor.import_warm_prefixes(payload) == payload["n_blocks"]
        want = list(victim.generate_sync(prefix + [32], 4))
        assert list(survivor.generate_sync(prefix + [32], 4)) == want
        assert survivor.stats()["prefix_hit_blocks_total"] >= 2
        assert victim.pool_audit() == [] and survivor.pool_audit() == []
    finally:
        victim.shutdown()
        survivor.shutdown()


def test_import_of_a_jax_warm_prefix_payload(weights):
    """A JAX engine's warm-prefix export is imported by the port, whose
    streams over that prefix equal the JAX engine's."""
    victim, survivor = _jax(weights), _port(weights[2])
    try:
        prefix = [6, 2, 8, 3, 1, 8, 5, 3]
        for t in (40, 41):
            list(victim.generate_sync(prefix + [t], 4))
        payload = victim.export_warm_prefixes(min_hits=1)
        assert payload is not None
        assert survivor.import_warm_prefixes(payload) == payload["n_blocks"]
        want = list(victim.generate_sync(prefix + [42], 6))
        assert list(survivor.generate_sync(prefix + [42], 6)) == want
        assert survivor.stats()["prefix_hit_blocks_total"] >= 2
        assert survivor.pool_audit() == []
    finally:
        victim.shutdown()
        survivor.shutdown()


def test_import_never_evicts_under_pressure(weights):
    victim = _port(weights[2])
    survivor = _port(weights[2], max_seq_len=16, decode_slots=1)
    try:
        prefix = [3, 1, 4, 1, 5, 9, 2, 6]
        for t in (30, 31, 32):
            list(victim.generate_sync(prefix + [t], 4))
        payload = victim.export_warm_prefixes(min_hits=1)
        assert payload is not None
        # fill the survivor's cache with its own warm blocks first
        list(survivor.generate_sync([9, 9, 9, 9, 8, 8, 8, 8, 7], 3))
        free0 = survivor.stats()
        n = survivor.import_warm_prefixes(payload)
        assert 0 <= n <= free0["free_blocks"] - free0["blocks_cached"]
        assert survivor.stats()["prefix_evictions_total"] == \
            free0["prefix_evictions_total"]
        assert survivor.pool_audit() == []
        assert list(survivor.generate_sync([2, 4, 6], 3))
    finally:
        victim.shutdown()
        survivor.shutdown()
