"""Per-request tracing, the SLO watchdog and the trace store of the port
against the JAX package's, on the CPU.

The tracer, store and SLO cases of ``tests/serve/test_request_trace.py``
run as one body on both packages' classes; then the port's engine: the
waterfall's phases (the same sequence as the JAX engine's for one
request), tail sampling, the queue-wait split of TTFT, clock-skew
clamping, the decode tick, the typed FAILED span of a dead engine, and
the speculative, hand-off and weight-swap spans."""

import random
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.serve.request_trace as jax_rt
import ray_tpu.serve.slo as jax_slo
import ray_tpu_torch.serve.request_trace as port_rt
import ray_tpu_torch.serve.slo as port_slo
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.serve import llm_engine as jax_llm
from ray_tpu_torch import EngineDeadError
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.core.metric_defs import runtime_metrics
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.serve import EngineConfig, LLMEngine

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                head_dim=8, d_ff=32, max_seq_len=64, rotary_dim=8,
                remat_policy="none")
ENGINE_KW = dict(decode_slots=4, kv_block_size=4, max_seq_len=48,
                 prefill_chunk=8, max_new_tokens=16, enable_trace=True)
WATERFALL = {"QUEUED", "ADMITTED", "PREFILL", "FIRST_TOKEN", "DECODE",
             "DONE"}


@pytest.fixture(params=["jax", "torch"])
def P(request):
    """One package's tracing classes: the same test body runs on both."""
    rt, slo = (jax_rt, jax_slo) if request.param == "jax" \
        else (port_rt, port_slo)
    return SimpleNamespace(RT=rt, RequestTrace=rt.RequestTrace,
                           RequestTracer=rt.RequestTracer,
                           RequestTraceStore=rt.RequestTraceStore,
                           new_request_id=rt.new_request_id,
                           SLOBudget=slo.SLOBudget,
                           SLOWatchdog=slo.SLOWatchdog)


# ----------------------------------------------------------- sampling
def test_phases_and_caps_match(P):
    for name in ("PHASE_ORDER", "TERMINAL_PHASES", "MAX_SPANS_PER_REQUEST",
                 "MAX_GAPS_PER_REQUEST"):
        assert getattr(P.RT, name) == getattr(jax_rt, name)


def test_request_id_format_and_uniqueness(P):
    ids = {P.new_request_id() for _ in range(64)}
    assert len(ids) == 64
    assert all(i.startswith("req-") and len(i) == 20 for i in ids)


def test_tracer_one_in_n_sampling_is_deterministic(P):
    tr = P.RequestTracer(sample_n=4)
    verdicts = [tr.begin().sampled for _ in range(8)]
    assert verdicts == [True, False, False, False,
                        True, False, False, False]


def test_tail_sampling_ship_rules(P):
    """Only sampled, failed or shed traces ship; a fast unsampled DONE is
    recorded locally and discarded."""
    RT = P.RT
    tr = P.RequestTracer(sample_n=10**9)
    t0 = tr.begin()            # counter 0: the 1-in-N hit
    assert t0.sampled
    t = tr.begin()
    t.span(RT.DONE, time.time())
    assert not tr.finish(t)
    assert len(tr.shipped_local) == 0
    assert tr.recent[-1] is t
    t = tr.begin()
    tr.finish(t, err=ValueError("boom"))
    assert len(tr.shipped_local) == 1
    p = tr.shipped_local[-1]
    assert p["status"] == RT.FAILED
    assert p["spans"][-1]["attrs"]["error"] == "ValueError"
    t = tr.begin()
    t.span(RT.SHED, time.time(), None, reason="tenant_over_quota")
    tr.finish(t)
    assert tr.shipped_local[-1]["status"] == RT.SHED
    t0.span(RT.DONE, time.time())
    tr.finish(t0)
    assert tr.shipped_local[-1]["status"] == RT.DONE
    assert tr.shipped_local[-1]["sampled"] is True
    assert set(tr.shipped_local[-1]) == {
        "request_id", "part", "proc", "seq", "ts", "status", "sampled",
        "slo", "meta", "dropped", "spans"}


def test_tracer_send_callable_takes_the_payload(P):
    got = []
    tr = P.RequestTracer(sample_n=1, send=got.append)
    t = tr.begin()
    t.span(P.RT.DONE, time.time())
    assert tr.finish(t)
    assert len(got) == 1 and len(tr.shipped_local) == 0


def test_disabled_tracer_is_a_noop(P):
    tr = P.RequestTracer(sample_n=1)
    tr.enabled = False
    assert tr.begin() is None
    assert tr.finish(None) is False


def test_span_cap_drops_oldest_and_counts(P):
    t = P.RequestTrace("req-cap")
    for i in range(P.RT.MAX_SPANS_PER_REQUEST + 8):
        t.span(P.RT.DECODE, float(i), float(i) + 0.5, tokens=1)
    assert len(t.spans) == P.RT.MAX_SPANS_PER_REQUEST
    assert t.dropped == 8
    assert t.spans[0]["t0"] == 8.0


def test_span_clock_skew_clamps_negative_width(P):
    t = P.RequestTrace("req-skew")
    t.span(P.RT.PREFILL, 10.0, 9.0)
    assert t.spans[0]["t1"] == 10.0


# ------------------------------------------------------- SLO watchdog
def test_slo_watchdog_trips_flip_ship_and_annotate(P):
    wd = P.SLOWatchdog(P.SLOBudget(queue_s=0.1, ttft_s=0.5,
                                   inter_token_p99_s=0.05))
    t = P.RequestTrace("req-slo")
    assert not t.ship
    assert not wd.observe_queue(t, 0.05)
    assert wd.observe_queue(t, 0.2)
    assert t.ship and t.slo["queue"] == {"value": 0.2, "budget": 0.1}
    assert wd.observe_ttft(t, 0.6)
    assert t.slo["ttft"]["budget"] == 0.5
    t2 = P.RequestTrace("req-slo2")
    for _ in range(20):
        assert not wd.observe_gap(t2, 0.01)
    assert wd.observe_gap(t2, 0.2)
    assert t2.slo["inter_token_p99"]["value"] >= 0.2
    assert t2.ship


def test_slo_disabled_budget_never_trips(P):
    wd = P.SLOWatchdog(P.SLOBudget(queue_s=0.0, ttft_s=-1.0,
                                   inter_token_p99_s=0.0))
    t = P.RequestTrace("req-off")
    assert not wd.observe_queue(t, 100.0)
    assert not wd.observe_ttft(t, 100.0)
    assert not wd.observe_gap(t, 100.0)
    assert not t.ship and not t.slo


def test_slo_budget_defaults_without_a_config(P):
    assert P.SLOBudget.from_config(None) == P.SLOBudget()
    b = P.SLOBudget.from_config(SimpleNamespace(
        slo_queue_s=2.0, slo_ttft_s=3.0, slo_inter_token_p99_s=0.5))
    assert (b.queue_s, b.ttft_s, b.inter_token_p99_s) == (2.0, 3.0, 0.5)
    assert P.SLOBudget.from_config(None).ttft_s == \
        jax_slo.SLOBudget.from_config(None).ttft_s


# ------------------------------------------------- the trace store
def _payload(rid, part="engine", seq=1, spans=None, status="DONE", **kw):
    return dict({"request_id": rid, "part": part, "proc": f"p-{part}",
                 "seq": seq, "ts": 100.0 + seq, "status": status,
                 "sampled": True, "slo": {}, "meta": {}, "dropped": 0,
                 "spans": spans or []}, **kw)


def test_store_dedups_by_part_seq_and_merges_parts(P):
    RT = P.RT
    st = P.RequestTraceStore()
    eng = _payload("req-a", spans=[
        {"request_id": "req-a", "phase": RT.QUEUED, "t0": 1.0, "t1": 2.0},
        {"request_id": "req-a", "phase": RT.DONE, "t0": 3.0, "t1": 3.0}])
    assert st.ingest(eng)
    assert not st.ingest(dict(eng))
    assert st.deduped == 1
    rtr = _payload("req-a", part="router", seq=7, status=None, spans=[
        {"request_id": "req-a", "phase": RT.ADMITTED,
         "t0": 2.5, "t1": 2.5}])
    assert st.ingest(rtr)
    w = st.waterfall("req-a")
    assert [s["phase"] for s in w["spans"]] == [RT.QUEUED, RT.ADMITTED,
                                                RT.DONE]
    assert w["status"] == RT.DONE
    assert w["procs"] == {"engine": "p-engine", "router": "p-router"}
    assert st.waterfall("req-missing") is None


def test_store_status_precedence_failed_beats_done(P):
    RT = P.RT
    st = P.RequestTraceStore()
    st.ingest(_payload("req-f1", part="engine", status=RT.DONE))
    st.ingest(_payload("req-f1", part="router", seq=2, status=RT.FAILED))
    assert st.waterfall("req-f1")["status"] == RT.FAILED
    st.ingest(_payload("req-f2", part="router", status=RT.FAILED))
    st.ingest(_payload("req-f2", part="engine", seq=2, status=RT.DONE))
    assert st.waterfall("req-f2")["status"] == RT.FAILED


def test_store_sorts_out_of_order_spans_monotone(P):
    RT = P.RT
    st = P.RequestTraceStore()
    st.ingest(_payload("req-o", spans=[
        {"request_id": "req-o", "phase": RT.DONE, "t0": 9.0, "t1": 9.0},
        {"request_id": "req-o", "phase": RT.QUEUED, "t0": 1.0, "t1": 2.0},
        {"request_id": "req-o", "phase": RT.PREFILL, "t0": 2.0,
         "t1": 1.5}]))
    w = st.waterfall("req-o")
    t0s = [s["t0"] for s in w["spans"]]
    assert t0s == sorted(t0s)
    assert all(s["t1"] >= s["t0"] for s in w["spans"])
    assert w["dur_s"] == pytest.approx(8.0)


def test_store_bounded_drop_oldest(P):
    st = P.RequestTraceStore(max_requests=4)
    for i in range(6):
        st.ingest(_payload(f"req-{i}"))
    rows = st.rows(limit=50)
    assert len(rows) == 4
    assert {r["request_id"] for r in rows} == {f"req-{i}"
                                               for i in range(2, 6)}
    assert rows[0]["request_id"] == "req-5"


def test_store_chaos_dups_exactly_one_complete_waterfall(P):
    """Every payload arrives 1-3 times in a seeded shuffle: each request
    ends with one complete waterfall, no span doubled."""
    RT = P.RT
    rng = random.Random(1101)
    st = P.RequestTraceStore()
    want, deliveries = {}, []
    for i in range(12):
        rid = f"req-chaos{i:02d}"
        spans = [{"request_id": rid, "phase": ph,
                  "t0": 10.0 * i + j, "t1": 10.0 * i + j + 0.5}
                 for j, ph in enumerate(
                     (RT.QUEUED, RT.ADMITTED, RT.PREFILL,
                      RT.FIRST_TOKEN, RT.DECODE, RT.DONE))]
        p = _payload(rid, seq=i + 1, spans=spans)
        want[rid] = len(spans)
        deliveries += [p] * rng.randint(1, 3)
    rng.shuffle(deliveries)
    for p in deliveries:
        st.ingest(dict(p))
    for rid, n in want.items():
        w = st.waterfall(rid)
        assert w is not None and w["status"] == RT.DONE
        assert len(w["spans"]) == n
        t0s = [s["t0"] for s in w["spans"]]
        assert t0s == sorted(t0s)
        assert sum(d["count"] for d in w["phases"].values()) == n


def test_store_slowest_picks_longest_waterfall(P):
    st = P.RequestTraceStore()
    for i, dur in enumerate((1.0, 5.0, 2.0)):
        st.ingest(_payload(f"req-s{i}", spans=[
            {"request_id": f"req-s{i}", "phase": P.RT.QUEUED,
             "t0": 0.0, "t1": dur}]))
    assert st.slowest()["request_id"] == "req-s1"


# ------------------------------------------------- engine integration
def _engine(**kw):
    """A traced port engine on the JAX package's seed-0 weights (the
    speculative case needs a stream whose drafts accept)."""
    cfg = TransformerConfig(**MODEL_KW, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_init_params(
        JaxConfig(**MODEL_KW, dtype=jnp.float32), jax.random.PRNGKey(0)))
    return LLMEngine(cfg, EngineConfig(**dict(ENGINE_KW, **kw)),
                     params=params_from_jax(tree, cfg, "cpu"), device="cpu")


@pytest.fixture(scope="module")
def traced_engine():
    eng = _engine()
    yield eng
    eng.shutdown()


def _shipped(eng, rid, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for p in list(eng._tracer.shipped_local):
            if p["request_id"] == rid:
                return p
        time.sleep(0.02)
    raise AssertionError(
        f"no shipped payload for {rid}: "
        f"{[p['request_id'] for p in eng._tracer.shipped_local]}")


def test_engine_waterfall_has_six_phases(traced_engine):
    eng = traced_engine
    shipped = runtime_metrics().request_spans_shipped
    before = sum(shipped._values.values())
    rid = port_rt.new_request_id()
    toks = list(eng.generate_sync(
        [1, 2, 3, 4], max_new_tokens=8,
        trace_ctx={"request_id": rid, "sampled": True,
                   "enqueue_ts": time.time(), "policy": "gauge",
                   "admission": "admitted"}))
    assert len(toks) == 8
    p = _shipped(eng, rid)
    phases = [s["phase"] for s in p["spans"]]
    assert WATERFALL <= set(phases)
    assert phases.count("DONE") == 1 and phases.count("QUEUED") == 1
    done = p["spans"][-1]
    assert done["phase"] == "DONE" and done["attrs"]["tokens"] == 8
    assert p["meta"] == {"policy": "gauge", "admission": "admitted"}
    assert p["status"] == "DONE" and p["part"] == "engine"
    assert sum(shipped._values.values()) == before + 1


def test_engine_waterfall_matches_the_jax_engines(traced_engine):
    """One request alone: the same phase sequence, chunk positions and
    token counts as the JAX engine's waterfall."""
    jeng = jax_llm.LLMEngine(JaxConfig(**MODEL_KW, dtype=jnp.float32),
                             jax_llm.EngineConfig(**ENGINE_KW))
    try:
        prompt = list(range(3, 23))                 # three prefill chunks
        rows = []
        for eng in (jeng, traced_engine):
            rid = port_rt.new_request_id()
            list(eng.generate_sync(prompt, 20, trace_ctx={
                "request_id": rid, "sampled": True}))
            p = _shipped(eng, rid)
            rows.append([(s["phase"], {k: v for k, v in
                                       s.get("attrs", {}).items()
                                       if k in ("pos", "tokens", "slot")})
                         for s in p["spans"]])
        assert rows[0] == rows[1]
        assert [ph for ph, _ in rows[1]].count("PREFILL") == 3
    finally:
        jeng.shutdown()


def test_engine_unsampled_fast_request_ships_zero_spans(traced_engine):
    eng = traced_engine
    rid = port_rt.new_request_id()
    before = len(eng._tracer.shipped_local)
    list(eng.generate_sync(
        [5, 6, 7], max_new_tokens=4,
        trace_ctx={"request_id": rid, "sampled": False,
                   "enqueue_ts": time.time()}))
    time.sleep(0.2)
    assert all(p["request_id"] != rid for p in eng._tracer.shipped_local)
    assert len(eng._tracer.shipped_local) == before
    assert any(t.request_id == rid for t in eng._tracer.recent)


def test_queue_wait_is_split_out_of_ttft(traced_engine):
    eng = traced_engine
    rid = port_rt.new_request_id()
    list(eng.generate_sync(
        [9, 9, 9], max_new_tokens=4,
        trace_ctx={"request_id": rid, "sampled": True,
                   "enqueue_ts": time.time() - 0.5}))
    p = _shipped(eng, rid)
    a = next(s for s in p["spans"] if s["phase"] == "FIRST_TOKEN")["attrs"]
    assert a["queue_wait_s"] >= 0.45
    assert a["ttft_s"] >= a["queue_wait_s"] > a["engine_ttft_s"]
    assert a["ttft_s"] == pytest.approx(
        a["queue_wait_s"] + a["engine_ttft_s"], abs=0.25)
    q = next(s for s in p["spans"] if s["phase"] == "QUEUED")
    assert q["t1"] - q["t0"] >= 0.45
    assert (eng.stats()["queue_wait_ewma_s"] or 0) > 0.1


def test_future_enqueue_stamp_is_clamped(traced_engine):
    eng = traced_engine
    rid = port_rt.new_request_id()
    list(eng.generate_sync(
        [4, 4, 4], max_new_tokens=2,
        trace_ctx={"request_id": rid, "sampled": True,
                   "enqueue_ts": time.time() + 60.0}))
    p = _shipped(eng, rid)
    q = next(s for s in p["spans"] if s["phase"] == "QUEUED")
    adm = next(s for s in p["spans"] if s["phase"] == "ADMITTED")
    assert q["t0"] <= adm["t0"]
    ft = next(s for s in p["spans"] if s["phase"] == "FIRST_TOKEN")
    assert ft["attrs"]["queue_wait_s"] >= 0.0


def test_pinned_id_without_verdict_keeps_baseline_sampling():
    eng = _engine(decode_slots=2)
    try:
        rid = port_rt.new_request_id()
        list(eng.generate_sync([2, 3, 5], max_new_tokens=2,
                               trace_ctx={"request_id": rid}))
        assert _shipped(eng, rid)["sampled"] is True
    finally:
        eng.shutdown()


def test_engine_death_ships_failed_span_naming_typed_error():
    eng = _engine(decode_slots=2)
    try:
        list(eng.generate_sync([1, 2, 3], max_new_tokens=2))

        def boom():
            raise RuntimeError("injected decode fault")

        eng._decode_once = boom
        rid = port_rt.new_request_id()
        with pytest.raises(EngineDeadError):
            list(eng.generate_sync(
                [7, 7, 7], max_new_tokens=8,
                trace_ctx={"request_id": rid, "sampled": False}))
        p = _shipped(eng, rid)
        assert p["status"] == "FAILED"
        failed = p["spans"][-1]
        assert failed["phase"] == "FAILED"
        assert failed["attrs"]["error"] == "EngineDeadError"
        assert "injected decode fault" in failed["attrs"]["detail"]
    finally:
        eng.shutdown()


def test_decode_tick_bounds_span_count():
    eng = _engine(decode_slots=2, trace_decode_tick=8, max_new_tokens=40,
                  max_seq_len=48)
    try:
        rid = port_rt.new_request_id()
        toks = list(eng.generate_sync(
            [3, 1], max_new_tokens=40,
            trace_ctx={"request_id": rid, "sampled": True}))
        p = _shipped(eng, rid)
        decode = [s for s in p["spans"] if s["phase"] == "DECODE"]
        assert 1 <= len(decode) <= (len(toks) // 8) + 1
        assert sum(s["attrs"]["tokens"] for s in decode) == len(toks) - 1
    finally:
        eng.shutdown()


def test_engine_disabled_trace_records_nothing():
    eng = _engine(decode_slots=2, enable_trace=False)
    try:
        list(eng.generate_sync([3, 1, 4], max_new_tokens=3,
                               trace_ctx={"request_id": "req-x",
                                          "sampled": True}))
        assert len(eng._tracer.shipped_local) == 0
        assert len(eng._tracer.recent) == 0
    finally:
        eng.shutdown()


def test_spec_handoff_and_weight_swap_spans():
    """A speculative engine records SPEC_VERIFY spans; a hand-off records
    KV_SHIP on the exporter and KV_SHIP + KV_ADOPT on the adopter; a
    weight swap during decode records WEIGHT_SWAP."""
    spec = _engine(spec_tokens=4)
    pre = _engine(trace_part="prefill")
    dec = _engine(trace_part="decode")
    try:
        rid = port_rt.new_request_id()
        ctx = {"request_id": rid, "sampled": True}
        list(spec.generate_sync([5, 6, 7] * 4, 12, trace_ctx=ctx))
        verify = [s for s in _shipped(spec, rid)["spans"]
                  if s["phase"] == "SPEC_VERIFY"]
        assert verify and sum(s["attrs"]["accepted"] for s in verify) > 0

        rid = port_rt.new_request_id()
        ctx = {"request_id": rid, "sampled": True}
        payload = pre.prefill_export(list(range(1, 11)), trace_ctx=ctx)
        # stage new weights from inside the first decode step, so the
        # swap lands at the next step boundary with the request active
        decode_once = dec._decode_once

        def decode_and_stage():
            if dec.stats()["weight_swaps"] == 0 and \
                    dec._staged_weights is None:
                dec.stage_weights(dec._params, version=3)
            decode_once()

        dec._decode_once = decode_and_stage
        toks = list(dec._items(dec.submit_adopt(payload, 30, trace_ctx=ctx),
                               "adopt", 60))
        assert toks[0] == payload["first"] and len(toks) == 30
        p_pre, p_dec = _shipped(pre, rid), _shipped(dec, rid)
        assert p_pre["part"] == "prefill" and p_dec["part"] == "decode"
        assert "KV_SHIP" in [s["phase"] for s in p_pre["spans"]]
        dec_phases = [s["phase"] for s in p_dec["spans"]]
        assert {"KV_SHIP", "KV_ADOPT", "FIRST_TOKEN", "DONE"} <= \
            set(dec_phases)
        swaps = [s for s in p_dec["spans"] if s["phase"] == "WEIGHT_SWAP"]
        assert [s["attrs"]["version"] for s in swaps] == [3]
        # a store merges the two parts into one waterfall
        st = port_rt.RequestTraceStore()
        assert st.ingest(p_pre) and st.ingest(p_dec)
        w = st.waterfall(rid)
        assert w["status"] == "DONE"
        assert w["procs"].keys() == {"prefill", "decode"}
    finally:
        for e in (spec, pre, dec):
            e.shutdown()
