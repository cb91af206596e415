"""The port's engine features against the JAX package's engine, on the
CPU in f32: speculative decode (prompt lookup, one verify call over the
slot array), log-probability capture with ``detailed`` streams,
in-flight weight staging, warm-up and the serve metrics.

Both engines serve the same tiny model (weights carried over with
``params_from_jax``) with the knobs of ``tests/serve/test_llm_engine.py``;
greedy streams must be equal token for token and log-probabilities
within 1e-5."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.serve import llm_engine as jax_llm
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.core.metric_defs import runtime_metrics
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.serve import (EngineConfig, LLMEngine,
                                 prefix_fingerprint)
from ray_tpu_torch.serve import llm_engine as port_llm

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                remat_policy="none")
ENGINE_KW = dict(decode_slots=4, kv_block_size=4, max_seq_len=48,
                 prefill_chunk=8, max_new_tokens=16)
LONG_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]
# the three prompts of the JAX package's spec-on/off test: drafts that
# accept, a long irregular prompt, a short one
SPEC_PROMPTS = [([5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6, 7], 20),
                (LONG_PROMPT, 10),
                ([9, 8, 7], 5)]
PACKAGES = {"jax": jax_llm, "torch": port_llm}


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
def port_off(weights):
    """Prefix sharing and speculation off: the reference streams."""
    eng = _port(weights[2], enable_prefix_sharing=False)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def port_spec(weights):
    eng = _port(weights[2], spec_tokens=4)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def jax_spec(weights):
    eng = _jax(weights, spec_tokens=4)
    yield eng
    eng.shutdown()


def _wait_clean(eng, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = eng.stats()
        if s["free_slots"] == eng.config.decode_slots \
                and s["free_blocks"] == s["total_blocks"]:
            return s
        time.sleep(0.02)
    raise AssertionError(f"slot/block leak: {eng.stats()}")


# ------------------------------------------------- speculative decode
def test_speculative_streams_match_spec_off_and_jax(port_spec, port_off,
                                                     jax_spec):
    """Port spec-on == port spec-off == JAX spec-on for every prompt, and
    the two spec engines draft and accept the same counts."""
    for prompt, mnt in SPEC_PROMPTS:
        p0, j0 = port_spec.stats()["spec"], jax_spec.stats()["spec"]
        want = list(jax_spec.generate_sync(prompt, max_new_tokens=mnt))
        got = list(port_spec.generate_sync(prompt, max_new_tokens=mnt))
        ref = list(port_off.generate_sync(prompt, max_new_tokens=mnt))
        assert got == ref == want, (prompt, got, ref, want)
        p1, j1 = port_spec.stats()["spec"], jax_spec.stats()["spec"]
        for key in ("drafted", "accepted"):
            assert p1[key] - p0[key] == j1[key] - j0[key], (prompt, key)
    s = port_spec.stats()["spec"]
    assert s["drafted"] > 0 and s["accepted"] > 0
    assert 0 < s["acceptance_rate"] <= 1
    assert port_spec.pool_audit() == []
    _wait_clean(port_spec)


def test_speculation_with_eos_inside_an_accepted_chain(port_spec,
                                                        port_off):
    """An EOS that the verify step emits inside a chain of accepted drafts
    ends the stream exactly where one-token decode ends it."""
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7]
    full = list(port_off.generate_sync(prompt, max_new_tokens=12))
    s0 = port_spec.stats()["spec"]
    assert list(port_spec.generate_sync(prompt, max_new_tokens=12)) == full
    assert port_spec.stats()["spec"]["accepted"] > s0["accepted"]
    cand = [i for i in range(2, 12) if full[i] not in full[:i]]
    assert cand, full
    idx = cand[0]
    trunc = list(port_spec.generate_sync(prompt, max_new_tokens=12,
                                         eos_token_id=full[idx]))
    assert trunc == full[:idx]
    _wait_clean(port_spec)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_draft_prompt_lookup_unit(pkg):
    """_draft: the continuation of the most recent earlier occurrence of
    the trailing n-gram, longest n first; no match, no drafts. One body
    on both packages' methods."""
    mod = PACKAGES[pkg]
    eng = SimpleNamespace(config=mod.EngineConfig(spec_tokens=4))

    def draft(history, n):
        return mod.LLMEngine._draft(eng, mod._Request(1, history, 8, None),
                                    n)

    assert draft([1, 2, 3, 4, 1, 2, 3], 3) == [4, 1, 2]
    assert draft([1, 2, 3, 4, 1, 2, 3], 1) == [4]
    assert draft([1, 2, 3, 4, 5, 6, 7], 3) == []
    assert draft([1, 2, 9, 1, 2, 8, 1, 2], 2) == [8, 1]
    assert draft([1, 2, 9, 1, 2, 8, 1, 2], 0) == []
    assert draft([7], 3) == []


def test_low_acceptance_turns_drafting_off(weights, port_off):
    """A floor no partial acceptance meets turns drafting off for a slot
    after its first rejected draft; its stream is unchanged."""
    eng = _port(weights[2], spec_tokens=4, spec_min_acceptance=1.0)
    try:
        got = list(eng.generate_sync(LONG_PROMPT, max_new_tokens=12))
        s = eng.stats()["spec"]
        assert s["disables"] >= 1
        assert s["accepted"] < s["drafted"]
        assert got == list(port_off.generate_sync(LONG_PROMPT, 12))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_config_validation_raises(weights, pkg):
    """capture_logprobs with spec_tokens > 0 raises, as do a bad wire and
    negative spec knobs, in both packages."""
    mod = PACKAGES[pkg]
    cfg = weights[0] if pkg == "jax" else \
        TransformerConfig(**MODEL_KW, dtype=torch.float32)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    for bad in (dict(capture_logprobs=True, spec_tokens=2),
                dict(kv_wire="fp4"), dict(spec_tokens=-1),
                dict(spec_ngram=0)):
        with pytest.raises(ValueError):
            mod.LLMEngine(cfg, mod.EngineConfig(**dict(ENGINE_KW, **bad)),
                          **kw)


# ------------------------------------------- log-probabilities, staging
def test_detailed_streams_match_jax_logprobs(weights):
    """``detailed`` streams of ``(token, version, logprob)``: the same
    tokens and versions as the JAX engine, logprobs within 1e-5."""
    jeng = _jax(weights, capture_logprobs=True)
    peng = _port(weights[2], capture_logprobs=True)
    try:
        for prompt, mnt in SPEC_PROMPTS + [(list(range(1, 30)), 8)]:
            want = list(jeng.generate_sync(prompt, mnt, detailed=True))
            got = list(peng.generate_sync(prompt, mnt, detailed=True))
            assert [t[:2] for t in got] == [t[:2] for t in want]
            np.testing.assert_allclose([t[2] for t in got],
                                       [t[2] for t in want], rtol=0,
                                       atol=1e-5)
            assert all(np.isfinite(t[2]) and t[2] <= 0 for t in got)
        # plain streams stay plain ints, with the same tokens
        assert list(peng.generate_sync(LONG_PROMPT, 6)) == \
            [t[0] for t in peng.generate_sync(LONG_PROMPT, 6,
                                              detailed=True)]
    finally:
        jeng.shutdown()
        peng.shutdown()


def _teacher_forced(cfg, trees, prompt, stream):
    """The greedy tokens and logprobs a ``detailed`` stream must carry if
    each token was computed with the tree of its stamp: the prompt
    through ``prefill`` with the first token's tree, then each later
    token's input through ``decode_step`` with that token's tree (a step
    writes its input's K/V with the weights it runs)."""
    from ray_tpu_torch.models import decode_step, init_kv_cache, prefill
    bs = ENGINE_KW["kv_block_size"]
    T = -(-(len(prompt) + len(stream)) // bs)
    cache = init_kv_cache(cfg, 1 + T, bs, device="cpu")
    bt = torch.arange(1, T + 1, dtype=torch.int32)[None]
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    n = len(prompt)
    logits, cache = prefill(cfg, trees[stream[0][1]], i32(prompt), cache,
                            bt, i32(0), i32(n))
    rows = [logits[0, n - 1]]
    for j in range(1, len(stream)):
        logits, cache = decode_step(cfg, trees[stream[j][1]],
                                    i32(stream[j - 1][0]), cache, bt,
                                    i32(n + j - 1))
        rows.append(logits[0])
    lp = torch.log_softmax(torch.stack(rows).float(), -1)
    toks = lp.argmax(-1)
    return toks.tolist(), lp.gather(-1, toks[:, None])[:, 0].tolist()


def test_stage_weights_stamps_versions_without_a_stall(weights):
    """A staged tree (another seed's weights) swaps in at a step
    boundary: every token is stamped by the version that produced it (a
    stream's stamps never go back) and is the token, with the logprob,
    of a teacher-forced replay that runs each step on the tree of its
    stamp; the new tree's logprobs differ from the old one's. No slot
    waits (sync_stall_s stays 0), and staging the old tree back gives
    the old streams again."""
    jcfg, _, tree = weights
    eng = _port(tree, capture_logprobs=True, max_seq_len=48)
    cfg, old = eng.model_config, eng._params
    new = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1))), cfg,
        "cpu")
    trees = {0: old, 1: new, 2: old}

    def check(stream, prompt):
        toks, lps = _teacher_forced(cfg, trees, prompt, stream)
        assert [t for t, _, _ in stream] == toks
        np.testing.assert_allclose([lp for _, _, lp in stream], lps,
                                   rtol=0, atol=1e-5)

    try:
        ref = list(eng.generate_sync(LONG_PROMPT, 24, detailed=True))
        assert {v for _, v, _ in ref} == {0}
        check(ref, LONG_PROMPT)
        # stage from inside the 4th decode step of the next stream: the
        # swap lands at the next step boundary, mid-stream
        decode_once, calls = eng._decode_once, []

        def decode_and_stage():
            calls.append(1)
            if len(calls) == 4:
                eng.stage_weights(new, version=1)
            decode_once()

        eng._decode_once = decode_and_stage
        got = list(eng.generate_sync(LONG_PROMPT, 24, detailed=True))
        eng._decode_once = decode_once
        versions = [v for _, v, _ in got]
        assert versions == [0] * 5 + [1] * 19
        check(got, LONG_PROMPT)
        assert [t[:2] for t in got[:5]] == [t[:2] for t in ref[:5]]
        assert max(abs(a[2] - b[2]) for a, b in zip(got[5:], ref[5:])) \
            > 1e-2
        after = list(eng.generate_sync(LONG_PROMPT, 4, detailed=True))
        assert {v for _, v, _ in after} == {1}
        check(after, LONG_PROMPT)
        assert eng.weight_version == 1
        # staging before a request: every token is the new version's,
        # here the old tree again
        eng.stage_weights(old, version=2)
        assert eng.weight_version == 2
        again = list(eng.generate_sync(LONG_PROMPT, 24, detailed=True))
        assert {v for _, v, _ in again} == {2}
        assert [t for t, _, _ in again] == [t for t, _, _ in ref]
        np.testing.assert_allclose([t[2] for t in again],
                                   [t[2] for t in ref], rtol=0, atol=1e-5)
        s = eng.stats()
        assert s["weight_swaps"] == 2 and s["weight_version"] == 2
        assert s["sync_stall_s"] == 0.0
    finally:
        eng.shutdown()


def test_a_swap_drops_the_prefix_index(weights):
    """A prompt cached before a swap is prefilled anew after it: its
    stream is that of the new tree alone (a teacher-forced replay on it).
    The JAX engine keeps its prefix index across the swap, so the same
    request reads the old tree's K/V for its cached blocks and misses
    the new tree's logprobs (ROADMAP Queue 3)."""
    jcfg, _, tree = weights
    jnew = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = TransformerConfig(**MODEL_KW, dtype=torch.float32)
    new = params_from_jax(jax.tree.map(np.asarray, jnew), cfg, "cpu")
    diffs, want = {}, None
    for pkg in ("port", "jax"):
        eng = _port(tree, capture_logprobs=True) if pkg == "port" \
            else _jax(weights, capture_logprobs=True)
        try:
            list(eng.generate_sync(LONG_PROMPT, 6))      # caches 4 blocks
            eng.stage_weights(new if pkg == "port" else jnew, version=1)
            got = list(eng.generate_sync(LONG_PROMPT, 6, detailed=True))
            assert {v for _, v, _ in got} == {1}
            assert eng.stats()["prefix_hit_blocks_total"] == \
                (4 if pkg == "jax" else 0)
            if pkg == "port":
                want = _teacher_forced(cfg, {1: new}, LONG_PROMPT, got)
                assert [t for t, _, _ in got] == want[0]
                assert eng.pool_audit() == []
            diffs[pkg] = max(abs(lp - w) for (_, _, lp), w in
                             zip(got, want[1]))
        finally:
            eng.shutdown()
    assert diffs["port"] <= 1e-5 < 1e-3 < diffs["jax"], diffs


def test_pool_drop_index_frees_cached_blocks_and_keeps_held_ones():
    from ray_tpu_torch.serve.prefix_cache import PrefixBlockPool
    pool = PrefixBlockPool(9, 2)
    a, b, c = pool.allocate(3)
    node, _ = pool.insert_child(pool._root, (1, 2), a)
    node, _ = pool.insert_child(node, (3, 4), b)
    pool.release([a])                    # a: cached; b: held and indexed
    assert pool.stats()["trie_blocks"] == 2
    assert pool.drop_index() == 2
    s = pool.stats()
    assert s["trie_blocks"] == 0 and s["cached"] == 0
    assert s["active"] == 2 and s["free"] == 6
    assert pool.match_prefix([1, 2, 3, 4]) == ([], 0, pool._root)
    # an insert under an old node aborts; the held block frees normally
    assert pool.insert_child(node, (5, 6), c) == (None, False)
    pool.release([b, c])
    assert pool.stats()["free"] == 8 and pool.audit() == []


def test_stage_weights_rejects_a_tree_that_does_not_match(weights):
    eng = _port(weights[2])
    try:
        good = eng._params
        bad_dtype = dict(good, embed=good["embed"].to(torch.float64))
        with pytest.raises(ValueError, match="embed"):
            eng.stage_weights(bad_dtype, 1)
        bad_shape = dict(good, embed=good["embed"][:, :8])
        with pytest.raises(ValueError, match="embed"):
            eng.stage_weights(bad_shape, 1)
        missing = {k: v for k, v in good.items() if k != "lm_head"}
        with pytest.raises(ValueError, match="tree"):
            eng.stage_weights(missing, 1)
        assert eng.weight_version == 0 and eng.stats()["weight_swaps"] == 0
    finally:
        eng.shutdown()


# ------------------------------------------------- warm-up, stats, metrics
def test_warmup_resets_session_stats(weights):
    eng = _port(weights[2], spec_tokens=2)
    try:
        eng.warmup()
        s = eng.stats()
        assert s["ttft_ewma_s"] is None and s["tokens_total"] == 0
        assert s["decode_steps"] == 0 and s["prefill_chunks"] == 0
        assert s["decode_wall_s"] == 0.0 and s["spec"]["drafted"] == 0
        list(eng.generate_sync([7, 7, 7], max_new_tokens=3))
        s = eng.stats()
        assert s["ttft_ewma_s"] is not None and s["tokens_total"] == 3
        assert eng.pool_audit() == []
    finally:
        eng.shutdown()


def test_stats_carry_the_jax_engines_fields(port_spec, jax_spec):
    prompt = list(range(2, 14))                       # 3 full blocks
    list(port_spec.generate_sync(prompt, 4))
    list(jax_spec.generate_sync(prompt, 4))
    got, want = port_spec.stats(), jax_spec.stats()
    assert set(want) <= set(got), set(want) - set(got)
    assert set(want["spec"]) == set(got["spec"])
    # most recently touched first: this prompt's first block
    fp = prefix_fingerprint(prompt, ENGINE_KW["kv_block_size"])
    assert got["prefix_fingerprints"][0] == want["prefix_fingerprints"][0] \
        == fp
    _wait_clean(port_spec)


def _count(metric):
    """Total of a counter's values, or a histogram's observations."""
    if hasattr(metric, "_counts"):
        return sum(sum(c) for c in metric._counts.values())
    return sum(metric._values.values())


def test_serve_metrics_move(port_spec):
    m = runtime_metrics()
    before = {n: _count(getattr(m, n)) for n in
              ("serve_tokens", "serve_ttft", "serve_spec_accept",
               "serve_batch_occupancy")}
    toks = list(port_spec.generate_sync(SPEC_PROMPTS[0][0], 12))
    after = {n: _count(getattr(m, n)) for n in before}
    assert after["serve_tokens"] - before["serve_tokens"] == len(toks)
    assert after["serve_ttft"] - before["serve_ttft"] == 1
    assert after["serve_spec_accept"] > before["serve_spec_accept"]
    assert after["serve_batch_occupancy"] > before["serve_batch_occupancy"]
    _wait_clean(port_spec)


def test_concurrent_speculative_streams_no_leaks(port_spec, port_off):
    """Six clients on four speculative slots: every stream equals its
    spec-off stream and nothing leaks."""
    prompts = [[1 + i, 2, 3, 1 + i, 2, 3, 1 + i, 2] for i in range(6)]
    want = [list(port_off.generate_sync(p, 10)) for p in prompts]
    got = {}

    def client(i):
        got[i] = list(port_spec.generate_sync(prompts[i], 10))

    ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert [got[i] for i in range(6)] == want
    assert port_spec.pool_audit() == []
    _wait_clean(port_spec)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_metrics_registry_exports_as_the_jax_package(pkg):
    """Counter, Gauge and Histogram render the same Prometheus text and
    snapshot in both packages; ``isolated_registry`` drops what it
    registered; the runtime catalog keeps the JAX package's names."""
    import ray_tpu.core.metric_defs as jax_defs
    import ray_tpu.util.metrics as jax_metrics
    import ray_tpu_torch.core.metric_defs as port_defs
    import ray_tpu_torch.util.metrics as port_metrics
    mod = jax_metrics if pkg == "jax" else port_metrics

    def exercise(m):
        with m.isolated_registry():
            mark = len(m.registry_snapshot())
            c = m.Counter("t_requests_total", "requests", tag_keys=("k",))
            c.inc(2, tags={"k": "a"})
            c.inc(tags={"k": 'b"q'})
            g = m.Gauge("t_depth", "depth")
            g.set(3.5)
            h = m.Histogram("t_lat", "latency", boundaries=[0.1, 1.0])
            for v in (0.05, 0.5, 0.5, 7.0):
                h.observe(v)
            with pytest.raises(ValueError):
                c.inc(0)
            names = [x["name"] for x in m.export_snapshot()[mark:]]
            text = m.export_prometheus()
            snap = m.export_snapshot()[mark:]
        assert len(m.registry_snapshot()) == mark
        return names, text[text.index("# TYPE t_requests_total"):], snap

    want = exercise(jax_metrics)
    got = exercise(mod)
    assert got[0] == ["t_requests_total", "t_depth", "t_lat"]
    assert got[1:] == want[1:]
    assert 't_lat_bucket{le="+Inf"} 4' in got[1]
    # the whole runtime catalog since the core runtime's copy, serving
    # metrics included
    jax_all = {m._name for m in vars(jax_defs.runtime_metrics()).values()
               if hasattr(m, "_name")}
    port_all = {m._name for m in vars(port_defs.runtime_metrics()).values()
                if hasattr(m, "_name")}
    assert {n for n in jax_all if n.startswith("serve_")} <= port_all
    assert port_all == jax_all
