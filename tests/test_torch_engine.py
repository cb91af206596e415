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
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW), params=jparams)
    try:
        want = _serve(jeng, prompts)
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
