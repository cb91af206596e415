"""RLHF rollouts against the JAX package's, on the CPU.

``RolloutEngine.stream_round`` at version 0, one engine with one decode
slot (the JAX batched decode writes into slots still in prefill: ROADMAP
Queue 3 item 1), 4 suffixes after a shared system prompt, at the tiny
f32 model of ``tests/rlhf/test_rlhf_chaos.py`` with the JAX weights
carried over: tokens equal, logprobs within 1e-5, advantages within
1e-6, the same prefix hits. Then both packages' ``WeightPublisher``
publish one perturbed tree: the packed payloads are byte-identical, the
wire accounting equal, and a prompt that shares no cached prefix (the
JAX engine keeps its prefix index across a swap: Queue 3 item 2) decodes
the same tokens and logprobs, every token stamped with the new version.
"""

import jax
import numpy as np
import pytest

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.rlhf.config import RLHFConfig as JaxRLHFConfig
from ray_tpu.rlhf.rollout import RolloutEngine as JaxRolloutEngine
from ray_tpu.rlhf.weight_sync import WeightPublisher as JaxPublisher
from ray_tpu.rlhf.weight_sync import pack_weights as jax_pack_weights
from ray_tpu.serve.llm_engine import _resolve_dtype as jax_dtype

from ray_tpu_torch.rlhf import RLHFConfig, RolloutEngine, WeightPublisher
from ray_tpu_torch.rlhf.weight_sync import pack_weights

pytestmark = pytest.mark.rlhf

MODEL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
             head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
             dtype="float32", remat_policy="none")
KW = dict(placement="anakin", num_engines=1, max_new_tokens=8,
          system_prompt=tuple(range(2, 18)), prompt_len=22, model=MODEL,
          engine=dict(decode_slots=1, kv_block_size=4, prefill_chunk=8))
SUFFIXES = [[2 + (j * 7 + k * 3) % 60 for k in range(6)] for j in range(4)]


def _params():
    m = dict(MODEL, dtype=jax_dtype("float32"))
    return jax.tree.map(np.asarray, jax_init_params(
        JaxConfig(**m), jax.random.PRNGKey(0)))


def _round(engine):
    stream = engine.stream_round(SUFFIXES, collect=True)
    out = {i["shard_key"]: b for b, i in stream.iter_blocks(timeout=300)}
    return [out[j] for j in range(len(SUFFIXES))], engine.stats()


def _payload_arrays(packed):
    return {k: {f: np.asarray(v) for f, v in e.items()
                if f in ("q", "scales", "raw")}
            for k, e in packed["entries"].items()}


def test_version0_round_and_a_publish_match_the_jax_engine():
    params = _params()
    jeng = JaxRolloutEngine(JaxRLHFConfig(**KW), params=params)
    peng = RolloutEngine(RLHFConfig(**KW), params=params, device="cpu")
    try:
        jb, js = _round(jeng)
        pb, ps = _round(peng)
        for j, (a, b) in enumerate(zip(jb, pb)):
            assert np.array_equal(a["prompt"], b["prompt"]), j
            assert np.array_equal(a["tokens"], b["tokens"]), j
            assert (a["versions"] == 0).all() and (b["versions"] == 0).all()
            np.testing.assert_allclose(b["logprobs"], a["logprobs"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(b["advantages"], a["advantages"],
                                       rtol=0, atol=1e-6)
            assert np.array_equal(a["block_uid"], b["block_uid"])
        assert ps["trajectories"] == js["trajectories"] == 4
        assert ps["tokens_total"] == js["tokens_total"]
        for k in ("prefix_hit_blocks_total", "prompt_blocks_total"):
            assert ps["engines"][0][k] == js["engines"][0][k], k
        assert ps["prefix_hit_rate"] == js["prefix_hit_rate"] > 0
        assert ps["staleness_samples"] == js["staleness_samples"] == 4

        # one publish of a perturbed tree through each package
        new = jax.tree.map(lambda x: x * 1.1, params)
        jpub = JaxPublisher(jeng.engines, block_size=64)
        ppub = WeightPublisher(peng.engines, block_size=64)
        assert jpub.publish(new) == ppub.publish(new) == 1
        jst, pst = jpub.stats(), ppub.stats()
        for k in ("wire_bytes_total", "f32_bytes_total", "compression"):
            assert pst[k] == jst[k], k
        ja = _payload_arrays(jax_pack_weights(new, 1, 64))
        pa = _payload_arrays(pack_weights(new, 1, 64))
        assert list(ja) == list(pa)
        for k in ja:
            for f in ja[k]:
                assert ja[k][f].tobytes() == pa[k][f].tobytes(), (k, f)

        # a prompt that shares no cached prefix, after the swap
        probe = [60 - i for i in range(13)]
        jt = list(jeng.engines[0].generate_sync(probe, 6, detailed=True))
        pt = list(peng.engines[0].generate_sync(probe, 6, detailed=True))
        assert [t for t, _, _ in pt] == [t for t, _, _ in jt]
        assert {v for _, v, _ in pt} == {v for _, v, _ in jt} == {1}
        np.testing.assert_allclose([lp for _, _, lp in pt],
                                   [lp for _, _, lp in jt], rtol=0,
                                   atol=1e-5)
        assert peng.stats()["sync_stall_s"] == 0.0
    finally:
        jeng.shutdown()
        peng.shutdown()


def test_rollout_engine_needs_the_card_unless_the_cpu_is_named():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RolloutEngine(RLHFConfig(**KW), params=_params())
