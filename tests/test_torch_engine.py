"""The port's ``LLMEngine`` on the CPU against the JAX package's.

Both engines serve the same tiny model (weights carried over from the
JAX package's ``init_params`` with ``params_from_jax``) with the same
engine knobs, and must give identical greedy token streams, including
a prompt that shares a prefix (radix hits) and one fully matched,
block-aligned prompt (copy-on-write). Model and engine knobs are those
of ``tests/serve/test_disagg.py``."""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.serve.llm_engine import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
from ray_tpu_torch import RequestTooLargeError
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.serve import EngineConfig, LLMEngine

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                remat_policy="none")
ENGINE_KW = dict(decode_slots=4, kv_block_size=4, max_seq_len=48,
                 prefill_chunk=8, max_new_tokens=16)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**MODEL_KW, dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_engine(tree, **kw):
    cfg = TransformerConfig(**MODEL_KW, dtype=torch.float32)
    return LLMEngine(cfg, EngineConfig(**dict(ENGINE_KW, **kw)),
                     params=params_from_jax(tree, cfg, "cpu"),
                     device="cpu")


def _serve(engine, prompts):
    """First prompt alone (its blocks enter the trie), then the rest
    concurrently; returns the token streams in prompt order."""
    first = list(engine.generate_sync(prompts[0], timeout_s=300))
    reqs = [engine.submit(p) for p in prompts[1:]]
    out = [first]
    for r in reqs:
        toks = []
        while True:
            item = r.out.get(timeout=300)
            if not isinstance(item, int):
                assert not isinstance(item, BaseException), item
                break
            toks.append(item)
        out.append(toks)
    return out


def _wait_idle(engine, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = engine.stats()
        if s["free_slots"] == engine.config.decode_slots \
                and s["queue_depth"] == 0 and s["prefilling"] == 0:
            return s
        time.sleep(0.05)
    raise AssertionError(f"engine never went idle: {engine.stats()}")


def test_greedy_streams_match_jax_engine(weights):
    jcfg, jparams, tree = weights
    rng = np.random.default_rng(0)
    base = rng.integers(1, 64, 12).tolist()          # 3 full blocks
    prompts = [base,
               list(base),                            # full match -> CoW
               base[:8] + rng.integers(1, 64, 5).tolist(),   # prefix hit
               rng.integers(1, 64, 7).tolist(),
               rng.integers(1, 64, 30).tolist()]      # 4 prefill chunks
    # the JAX engine one request at a time: its batched decode step also
    # writes for slots still in prefill (token 0 over position 0 of their
    # first block, which may be a shared prefix block), so its streams
    # served concurrently carry that corruption (ROADMAP Queue 3); the
    # port, served concurrently, must match its fault-free streams
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW), params=jparams)
    try:
        want = [list(jeng.generate_sync(p, timeout_s=300)) for p in prompts]
    finally:
        jeng.shutdown()
    teng = _port_engine(tree)
    try:
        got = _serve(teng, prompts)
        s = _wait_idle(teng)
        assert teng.pool_audit() == []
    finally:
        teng.shutdown()
    assert got == want
    assert all(len(t) == ENGINE_KW["max_new_tokens"] for t in got)
    assert s["cow_copies_total"] >= 1
    assert s["prefix_hit_blocks_total"] >= 3 + 2
    assert s["tokens_total"] == sum(len(t) for t in got)


def test_cancel_eos_and_async_generate(weights):
    _, _, tree = weights
    eng = _port_engine(tree)
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        full = list(eng.generate_sync(prompt, max_new_tokens=10))
        assert len(full) == 10
        # EOS: the stream stops before the EOS token itself
        eos = full[3]
        cut = list(eng.generate_sync(prompt, max_new_tokens=10,
                                     eos_token_id=eos))
        assert cut == full[:full.index(eos)]
        # cancel: stop after two tokens; slot and blocks come back
        gen = eng.generate_sync(prompt, max_new_tokens=40)
        assert [next(gen), next(gen)] == full[:2]
        gen.close()
        _wait_idle(eng)
        assert eng.pool_audit() == []

        async def consume():
            return [t async for t in eng.generate(prompt, 10)]
        assert asyncio.run(consume()) == full
        with pytest.raises(RequestTooLargeError):
            eng.submit(list(range(1, 49)))
        _wait_idle(eng)
        assert eng.pool_audit() == []
        assert eng.stats()["free_blocks"] == eng.stats()["total_blocks"]
    finally:
        eng.shutdown()


def test_engine_needs_cuda_unless_told_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = TransformerConfig(**MODEL_KW, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(cfg, EngineConfig(**ENGINE_KW))


def _prefill_beside_a_neighbour(engine, prompts, new_tokens=8):
    """Detailed streams of ``prompts`` (a, b, c): ``a`` alone, ``b``
    while a neighbour decodes (its prefill chunks run beside decode
    steps), then ``c`` alone."""
    a, b, c = prompts
    runs = [list(engine.generate_sync(a, new_tokens, detailed=True))]
    nb = engine.submit([5, 6, 7], 40)
    nb.out.get(timeout=60)                 # the neighbour is decoding
    runs.append(list(engine.generate_sync(b, new_tokens, detailed=True)))
    engine.cancel(nb)
    _wait_idle(engine)
    runs.append(list(engine.generate_sync(c, new_tokens, detailed=True)))
    return runs


def _lp_diffs(got, want):
    """Max |logprob difference| of each pair of detailed streams (inf
    where their tokens differ)."""
    out = []
    for a, b in zip(got, want):
        same = [t for t, _, _ in a] == [t for t, _, _ in b]
        out.append(max(abs(x[2] - y[2]) for x, y in zip(a, b)) if same
                   else float("inf"))
    return out


def test_decode_does_not_write_into_prefilling_slots(weights):
    """A slot still in prefill has seq_len 0: the batched decode step must
    not write its token 0 over position 0 of its first block, here a
    prefix block that three prompts share. The port gives every prompt the
    stream and logprobs of a run with no neighbour, and the shared block
    stays intact for the next request; the JAX engine does not (its
    decode writes every slot: ROADMAP Queue 3)."""
    jcfg, jparams, tree = weights
    rng = np.random.default_rng(1)
    base = rng.integers(1, 64, 8).tolist()                 # 2 full blocks
    prompts = [base + rng.integers(1, 64, 22).tolist() for _ in range(3)]
    diffs = {}
    for pkg in ("port", "jax"):
        engs = [_port_engine(tree, capture_logprobs=True) if pkg == "port"
                else JaxEngine(jcfg, JaxEngineConfig(
                    **ENGINE_KW, capture_logprobs=True), params=jparams)
                for _ in range(2)]
        try:
            got = _prefill_beside_a_neighbour(engs[0], prompts)
            want = [list(engs[1].generate_sync(p, 8, detailed=True))
                    for p in prompts]
            diffs[pkg] = _lp_diffs(got, want)
            assert engs[0].pool_audit() == []
        finally:
            for e in engs:
                e.shutdown()
    assert max(diffs["port"]) <= 1e-6, diffs
    # the reference's fault: b's own prefill, then c through the block
    assert min(diffs["jax"][1:]) > 1e-4, diffs
