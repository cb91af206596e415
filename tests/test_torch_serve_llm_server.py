"""The serving slice as a whole on the CPU: ``LLMServer`` behind
``serve.run``, the HTTP proxy and the disaggregated pair, against the
JAX package's engine.

The JAX ``LLMEngine`` runs in this process with no JAX runtime on the
model and engine knobs of ``tests/serve/test_disagg.py``; its weights
go, as numpy, to a test subclass of the port's ``LLMServer`` that builds
its engine from them on the CPU (the tree is an init argument, so the
replica gets the same weights). Greedy streams through a handle and
through an HTTP POST to the proxy must equal the JAX engine's, taken one
request at a time (the JAX batched decode writes into slots still in
prefill: ROADMAP Queue 3). The disaggregated pair, built from a seed by
``deploy_disaggregated``, must stream what a colocated port replica of
the same seed streams. Also: the int8 weight codec against the JAX
codec, ``sync_weights``, and a traced request through the runtime into
the controller's store."""

import json
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.rlhf.weight_sync import pack_weights as jax_pack_weights
from ray_tpu.rlhf.weight_sync import unpack_weights as jax_unpack_weights
from ray_tpu.serve.llm_engine import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.rlhf import weight_sync as WS
from ray_tpu_torch.serve.disagg import kv_ship_bytes
from ray_tpu_torch.serve.llm_engine import LLMEngine, LLMServer

MODEL_KW = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                remat_policy="none")
MODEL_DICT = dict(MODEL_KW, dtype="float32")
ENGINE_KW = dict(decode_slots=4, kv_block_size=4, max_seq_len=48,
                 prefill_chunk=8, max_new_tokens=16)
NEW = ENGINE_KW["max_new_tokens"]
TIMEOUT_S = 120.0


def carried_llm_server():
    """A test subclass of ``LLMServer`` whose engine serves a carried
    numpy tree (JAX layout) on the CPU. Made inside a function, so the
    runtime's serializer ships it to the replica by value (this module is
    not importable in workers)."""

    class CarriedLLMServer(LLMServer):
        def __init__(self, tree, model, engine):
            self._tree = tree
            super().__init__(model=model, engine=engine, device="cpu")

        def _make_engine(self, device, seed):
            params = params_from_jax(self._tree, self.model_config, device)
            return LLMEngine(self.model_config, self.engine_config,
                             params=params, device=device,
                             replica_tag=f"pid:{os.getpid()}")

    return CarriedLLMServer


def _prompts():
    rng = np.random.default_rng(0)
    base = rng.integers(1, 64, 12).tolist()          # 3 full blocks
    return [base,
            list(base),                               # full match -> CoW
            base[:8] + rng.integers(1, 64, 5).tolist(),   # prefix hit
            rng.integers(1, 64, 7).tolist(),
            rng.integers(1, 64, 30).tolist()]         # 4 prefill chunks


@pytest.fixture(scope="module")
def jax_weights():
    jcfg = JaxConfig(**MODEL_KW, dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_streams(jax_weights):
    jcfg, jparams, _ = jax_weights
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW), params=jparams)
    try:
        return [list(jeng.generate_sync(p, timeout_s=TIMEOUT_S))
                for p in _prompts()]
    finally:
        jeng.shutdown()


@pytest.fixture(scope="module")
def proxy():
    """One runtime and HTTP proxy for the module, workers off the card,
    every request sampled for tracing."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    mp.setenv("RAY_TPU_TORCH_TRACE_SAMPLE_N", "1")
    ray_tpu_torch.init(num_cpus=8, _num_initial_workers=3)
    try:
        serve.start(http_options={"port": 0})
        yield serve.proxy_address()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        mp.undo()


def _post(url, body):
    """POST ``body`` as JSON; returns (X-Request-Id, the streamed
    integer tokens, one JSON value a line)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        rid = r.headers.get("X-Request-Id")
        return rid, [json.loads(line) for line in
                     r.read().decode().splitlines() if line]


def _each(fn, items):
    """``fn`` over ``items`` at once, one thread each; results in order."""
    out = [None] * len(items)
    errors = []

    def run(i, x):
        try:
            out[i] = fn(x)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, x))
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    if errors:
        raise errors[0]
    return out


def _idle_stats(handle, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while True:
        s = handle.stats.remote().result(timeout_s=TIMEOUT_S)
        if s["free_slots"] == ENGINE_KW["decode_slots"] \
                and s["queue_depth"] == 0 and s["prefilling"] == 0:
            return s
        assert time.monotonic() < deadline, f"never idle: {s}"
        time.sleep(0.05)


def test_serve_run_and_http_streams_equal_the_jax_engine(
        proxy, jax_weights, jax_streams):
    _, _, tree = jax_weights
    prompts = _prompts()
    app = serve.deployment(carried_llm_server()).bind(tree, MODEL_DICT,
                                                      ENGINE_KW)
    h = serve.run(app, name="carried", route_prefix="/carried")
    stream = h.options(stream=True)
    via_handle = _each(lambda p: list(stream.generate.remote(p)), prompts)
    via_http = _each(lambda p: _post(proxy + "/carried", p)[1], prompts)
    s = _idle_stats(h)
    assert h.pool_audit.remote().result(timeout_s=TIMEOUT_S) == []
    assert via_handle == jax_streams
    assert via_http == jax_streams
    assert all(len(t) == NEW for t in jax_streams)
    assert s["tokens_total"] == 2 * NEW * len(prompts)
    assert s["prefix_hit_blocks_total"] > 0
    serve.delete("carried")


def test_disaggregated_pair_streams_equal_a_colocated_replica(proxy):
    prompts = _prompts()
    coloc = serve.run(serve.deployment(name="coloc")(LLMServer).bind(
        model=MODEL_DICT, engine=ENGINE_KW), name="coloc",
        route_prefix=None)
    want = _each(lambda p: list(coloc.options(stream=True).generate.remote(
        p)), prompts)
    router = serve.deploy_disaggregated(MODEL_DICT, ENGINE_KW, name="pd",
                                        kv_wire="bf16", route_prefix="/pd")
    via_router = _each(lambda p: list(router.generate(p)), prompts)
    via_http = _each(lambda p: _post(proxy + "/pd", {
        "prompt": p, "max_new_tokens": NEW})[1], prompts)
    assert via_router == want and via_http == want
    pre = serve.get_deployment_handle("pd-prefill")
    dec = serve.get_deployment_handle("pd-decode")
    sp, sd = _idle_stats(pre), _idle_stats(dec)
    for h in (pre, dec):
        assert h.pool_audit.remote().result(timeout_s=TIMEOUT_S) == []
    bs = ENGINE_KW["kv_block_size"]
    shipped = 2 * sum(kv_ship_bytes(-(-len(p) // bs), bs,
                                    MODEL_KW["n_heads"],
                                    MODEL_KW["head_dim"],
                                    MODEL_KW["n_layers"], "bf16",
                                    dtype_bytes=4) for p in prompts)
    assert sp["kv_exports"] == sd["kv_adopts"] == 2 * len(prompts)
    assert sp["kv_export_bytes"] == sd["kv_adopt_bytes"] == shipped
    assert router.stats == {"requests": len(prompts), "retries": 0,
                            "handoff_errors": 0}
    for name in ("coloc", "pd-prefill", "pd-decode"):
        serve.delete(name)


def test_a_traced_http_request_reaches_the_controllers_store(proxy):
    """Every request is sampled in this module's runtime: the waterfall
    of one HTTP request, filed under the id the proxy returned, holds
    the engine's phases and the router's annotations."""
    from ray_tpu_torch.serve import request_trace as RT
    from ray_tpu_torch.util.state import get_request_trace
    serve.run(serve.deployment(name="traced")(LLMServer).bind(
        model=MODEL_DICT, engine=dict(ENGINE_KW, enable_trace=True)),
        name="traced", route_prefix="/traced")
    rid, toks = _post(proxy + "/traced", [5, 6, 7, 8, 9])
    assert rid and len(toks) == NEW
    deadline = time.monotonic() + 30
    w = None
    while w is None or w["status"] != RT.DONE:
        assert time.monotonic() < deadline, f"no waterfall for {rid}: {w}"
        time.sleep(0.1)
        w = get_request_trace(rid)
    phases = {s["phase"] for s in w["spans"]}
    assert {RT.QUEUED, RT.ADMITTED, RT.PREFILL, RT.FIRST_TOKEN, RT.DECODE,
            RT.DONE} <= phases
    assert w["meta"].get("policy") and "admission" in w["meta"]
    assert any(p.startswith("worker:") for p in w["procs"].values())
    serve.delete("traced")


def test_weight_codec_matches_the_jax_codec():
    """Same numpy tree in: the same bytes on the wire and the same
    dequantised tree out of either package's codec."""
    rng = np.random.default_rng(3)
    tree = {"embed": rng.standard_normal((7, 33)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 5, 300)).astype(
                np.float32), "scale": np.ones(5, np.float32)},
            "step": np.arange(4, dtype=np.int32)}
    mine, theirs = WS.pack_weights(tree, 7), jax_pack_weights(tree, 7)
    assert mine.keys() == theirs.keys()
    assert (mine["version"], mine["block_size"]) == \
        (theirs["version"], theirs["block_size"])
    assert mine["entries"].keys() == theirs["entries"].keys()
    for key, e in mine["entries"].items():
        f = theirs["entries"][key]
        assert e.keys() == f.keys()
        for field, v in e.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == f[field].dtype
                assert v.tobytes() == f[field].tobytes(), (key, field)
            else:
                assert tuple(v) == tuple(f[field]) if field == "shape" \
                    else v == f[field]
    assert WS.packed_wire_bytes(mine) == sum(
        a.nbytes for e in theirs["entries"].values()
        for a in e.values() if isinstance(a, np.ndarray))
    got, v1 = WS.unpack_weights(theirs)
    want, v2 = jax_unpack_weights(mine)
    assert v1 == v2 == 7
    flat = WS._flatten(got)
    assert [k for k, _ in flat] == [k for k, _ in WS._flatten(want)]
    for (k, a), (_, b) in zip(flat, WS._flatten(want)):
        assert a.dtype == np.asarray(b).dtype and a.tobytes() == \
            np.asarray(b).tobytes(), k


def test_sync_weights_stages_the_dequantised_tree():
    """``LLMServer.sync_weights`` on the CPU: the packed tree of this
    engine's own weights doubled is staged as version 3 and swapped in
    at the next step."""
    from ray_tpu_torch._bridge import to_numpy
    srv = LLMServer(model=MODEL_DICT, engine=ENGINE_KW, device="cpu")
    try:
        old = to_numpy(srv.engine._params)
        doubled = jax.tree.map(lambda a: 2 * a, old)
        assert srv.sync_weights(WS.pack_weights(doubled, 3)) == 3
        toks = list(srv.engine.generate_sync([1, 2, 3], 2,
                                             detailed=True))
        assert [v for _, v, _ in toks] == [3, 3]
        new = to_numpy(srv.engine._params)
        for (k, a), (_, b) in zip(WS._flatten(new), WS._flatten(doubled)):
            scale = np.abs(b).max() / 127 if b.size else 0.0
            assert np.abs(a - b).max() <= scale / 2 + 1e-6, k
        assert srv.stats()["weight_swaps"] == 1
        assert srv.kv_block_bytes() == ENGINE_KW["kv_block_size"] * 2 * \
            MODEL_KW["n_layers"] * MODEL_KW["n_heads"] * \
            MODEL_KW["head_dim"] * 4
        srv.check_health()
    finally:
        srv.engine.shutdown()
