"""Weight swaps and shared prefixes, on the port's engine on the CPU.

A swap drops the prefix index (the KV it held was written by the old
weights). Two queued requests sharing a system prompt admitted right
after it must prefill the shared blocks once, not twice: the second
waits for the first to index them and matches them. And the prefixes the
dropped index had reused are prefilled again on the new weights ahead of
every queued request, so that a request admitted after a swap matches
them whenever the swap landed, as an RLHF round's trajectories do after
a sync; a re-prefilled prefix stays reused across the next swap when no
request came between the two, and a re-prefill that a swap cuts short is
queued again. A re-prefilled prefix that the requests admitted after it
did not match is not prefilled at the next swap, so rounds of distinct
shared prompts (grouped sampling) re-prefill one round's prompts a swap,
not every prompt seen. Every stream is that of an engine that never held
the old weights, so no KV of the old weights is reused.
"""

import threading

import pytest
import torch

from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.serve import EngineConfig, LLMEngine

pytestmark = pytest.mark.rlhf

MODEL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8,
             d_ff=32, max_seq_len=64, rotary_dim=8, remat_policy="none",
             dtype=torch.float32)
ENGINE = dict(decode_slots=2, kv_block_size=4, max_seq_len=48,
              prefill_chunk=8, max_new_tokens=6)
SYSTEM = list(range(2, 18))                  # 4 full blocks
PROMPTS = [SYSTEM + [40, 41, 42], SYSTEM + [50, 51, 52]]


def _engine(params):
    return LLMEngine(TransformerConfig(**MODEL), EngineConfig(**ENGINE),
                     params=params, device="cpu")


def _tokens(eng, req):
    return list(eng._items(req, "test", 60.0))


def test_a_swap_before_a_shared_admission_prefills_the_prefix_once():
    cfg = TransformerConfig(**MODEL)
    old, new = (init_params(cfg, seed, "cpu") for seed in (0, 1))
    eng = _engine(old)
    try:
        # the system prompt is indexed under the old weights
        list(eng.generate_sync(SYSTEM + [60, 61], 2))
        before = eng.stats()
        # hold the step thread at its next step's first op, queue both
        # requests and stage the new weights; that step then swaps, and
        # admits the pair with the index empty
        entered, gate = threading.Event(), threading.Event()

        def hold():
            entered.set()
            assert gate.wait(30)

        holder = threading.Thread(
            target=eng._run_on_step_thread, args=(hold,), daemon=True)
        holder.start()
        assert entered.wait(30)
        reqs = [eng.submit(p) for p in PROMPTS]
        eng.stage_weights(new, version=1)
        gate.set()
        holder.join(30)
        got = [_tokens(eng, r) for r in reqs]
        after = eng.stats()
    finally:
        eng.shutdown()
    assert after["weight_swaps"] == 1
    n_prefix = len(SYSTEM) // ENGINE["kv_block_size"]
    # the shared prefix is prefilled once: the second request matches
    # the blocks the first one wrote under the new weights
    hits = after["prefix_hit_blocks_total"] - before["prefix_hit_blocks_total"]
    assert hits == n_prefix
    # 19 prompt tokens in chunks of 8 for the first request, the 3 after
    # the shared blocks for the second
    assert after["prefill_chunks"] - before["prefill_chunks"] == 3 + 1
    assert after["prefix_wait_steps"] > before["prefix_wait_steps"]
    fresh = _engine(new)
    try:
        want = [list(fresh.generate_sync(p)) for p in PROMPTS]
    finally:
        fresh.shutdown()
    assert got == want


def test_requests_admitted_before_a_swap_do_not_hold_later_ones():
    """A request whose prefill began before a swap indexes nothing after
    it (its inserts abort), so a later request sharing its prompt is not
    held for it: it prefills under the new weights at once."""
    cfg = TransformerConfig(**MODEL)
    old, new = (init_params(cfg, seed, "cpu") for seed in (0, 1))
    eng = _engine(old)
    try:
        entered, gate = threading.Event(), threading.Event()
        prefill_one, calls = eng._prefill_one_chunk, []

        def prefill_then_stage():
            # after the first request's first chunk: stage, so the swap
            # lands between its chunks and before the second's admission
            prefill_one()
            calls.append(1)
            if len(calls) == 1:
                eng.stage_weights(new, version=1)
                entered.set()
                assert gate.wait(30)

        eng._prefill_one_chunk = prefill_then_stage
        first = eng.submit(PROMPTS[0])
        assert entered.wait(30)
        second = eng.submit(PROMPTS[1])
        gate.set()
        _tokens(eng, first)
        got = _tokens(eng, second)
        s = eng.stats()
    finally:
        eng.shutdown()
    assert s["weight_swaps"] == 1
    assert s["prefix_hit_blocks_total"] == 0
    fresh = _engine(new)
    try:
        want = list(fresh.generate_sync(PROMPTS[1]))
    finally:
        fresh.shutdown()
    assert got == want


def test_a_swap_prefills_the_reused_prefixes_again_first():
    """The system prompt, reused once under the old weights, is prefilled
    again at the swap (``rewarm_blocks``, outside the prompt-block and
    token counts); the next request sharing it matches all of it."""
    cfg = TransformerConfig(**MODEL)
    old, new = (init_params(cfg, seed, "cpu") for seed in (0, 1))
    eng = _engine(old)
    later = SYSTEM + [60, 61, 62]
    try:
        for p in PROMPTS:
            list(eng.generate_sync(p, 2))
        before = eng.stats()
        assert before["prefix_hit_blocks_total"] == 4
        eng.stage_weights(new, version=1)
        got = list(eng.generate_sync(later))
        after = eng.stats()
    finally:
        eng.shutdown()
    n_prefix = len(SYSTEM) // ENGINE["kv_block_size"]
    assert after["weight_swaps"] == 1
    assert after["rewarm_blocks"] == n_prefix
    assert after["prefix_hit_blocks_total"] \
        - before["prefix_hit_blocks_total"] == n_prefix
    assert after["prompt_blocks_total"] - before["prompt_blocks_total"] \
        == -(-len(later) // ENGINE["kv_block_size"])
    assert after["tokens_total"] - before["tokens_total"] == len(got)
    fresh = _engine(new)
    try:
        assert got == list(fresh.generate_sync(later))
    finally:
        fresh.shutdown()


def test_a_swap_during_a_re_prefill_queues_it_again():
    """A second swap that lands while the first swap's re-prefill of the
    system prompt is between its chunks: that re-prefill's inserts abort
    (old weights), and the prompt is prefilled again on the newest
    weights, so the next request still matches all of it."""
    cfg = TransformerConfig(**MODEL)
    old, mid, new = (init_params(cfg, seed, "cpu") for seed in (0, 1, 2))
    eng = _engine(old)
    later = SYSTEM + [60, 61, 62]
    try:
        for p in PROMPTS:
            list(eng.generate_sync(p, 2))
        prefill_one, staged = eng._prefill_one_chunk, []

        def prefill_then_stage():
            head = eng._prefilling[0] if eng._prefilling else None
            prefill_one()
            if head is not None and head.rewarm and not staged \
                    and head.prefill_pos < len(head.prompt):
                staged.append(head.rid)
                eng.stage_weights(new, version=2)

        eng._prefill_one_chunk = prefill_then_stage
        eng.stage_weights(mid, version=1)
        got = list(eng.generate_sync(later))
        s = eng.stats()
    finally:
        eng.shutdown()
    n_prefix = len(SYSTEM) // ENGINE["kv_block_size"]
    assert staged and s["weight_swaps"] == 2 and s["weight_version"] == 2
    assert s["rewarm_blocks"] == 2 * n_prefix
    assert s["prefix_hit_blocks_total"] == n_prefix + n_prefix
    fresh = _engine(new)
    try:
        assert got == list(fresh.generate_sync(later))
    finally:
        fresh.shutdown()


def test_a_re_prefilled_prefix_stays_reused_across_the_next_swap():
    """Two swaps with no request between them: the prefix the first one
    prefilled again counts as reused, so the second prefills it again
    too and the next request matches all of it."""
    import time
    cfg = TransformerConfig(**MODEL)
    old, mid, new = (init_params(cfg, seed, "cpu") for seed in (0, 1, 2))
    eng = _engine(old)
    later = SYSTEM + [60, 61, 62]
    n_prefix = len(SYSTEM) // ENGINE["kv_block_size"]
    try:
        for p in PROMPTS:
            list(eng.generate_sync(p, 2))
        eng.stage_weights(mid, version=1)
        deadline = time.monotonic() + 30
        while eng.stats()["rewarm_blocks"] < n_prefix \
                or eng.stats()["prefilling"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        eng.stage_weights(new, version=2)
        got = list(eng.generate_sync(later))
        s = eng.stats()
    finally:
        eng.shutdown()
    assert s["weight_swaps"] == 2
    assert s["rewarm_blocks"] == 2 * n_prefix
    assert s["prefix_hit_blocks_total"] == n_prefix + n_prefix
    fresh = _engine(new)
    try:
        assert got == list(fresh.generate_sync(later))
    finally:
        fresh.shutdown()


def _settle(eng, rewarm_blocks):
    """Wait until the engine has re-prefilled ``rewarm_blocks`` in all
    and holds no prefill."""
    import time
    deadline = time.monotonic() + 30
    while eng.stats()["rewarm_blocks"] < rewarm_blocks \
            or eng.stats()["prefilling"]:
        assert time.monotonic() < deadline, eng.stats()
        time.sleep(0.01)


def test_a_re_prefilled_prefix_no_later_request_matched_is_dropped():
    """The first swap prefills the reused system prompt again; the one
    request admitted after it shares none of it; the second swap then
    prefills nothing again, and the next request sharing the system
    prompt prefills all of it."""
    cfg = TransformerConfig(**MODEL)
    old, mid, new = (init_params(cfg, seed, "cpu") for seed in (0, 1, 2))
    eng = _engine(old)
    other = list(range(20, 39))
    later = SYSTEM + [60, 61, 62]
    n_prefix = len(SYSTEM) // ENGINE["kv_block_size"]
    try:
        for p in PROMPTS:
            list(eng.generate_sync(p, 2))
        eng.stage_weights(mid, version=1)
        list(eng.generate_sync(other, 2))
        assert eng.stats()["rewarm_blocks"] == n_prefix
        before = eng.stats()
        eng.stage_weights(new, version=2)
        got = list(eng.generate_sync(later))
        s = eng.stats()
    finally:
        eng.shutdown()
    assert s["weight_swaps"] == 2
    assert s["rewarm_blocks"] == n_prefix
    assert s["prefix_hit_blocks_total"] == before["prefix_hit_blocks_total"]
    fresh = _engine(new)
    try:
        assert got == list(fresh.generate_sync(later))
    finally:
        fresh.shutdown()


def test_rounds_of_grouped_prompts_re_prefill_one_round_a_swap():
    """Each round two samples of a prompt of its own (3 full blocks),
    then a swap: the swap prefills that round's prompt again and no
    earlier one, so the re-prefill a swap stays one prompt's blocks; each
    round's second sample matches its first's blocks."""
    rounds = 3
    cfg = TransformerConfig(**MODEL)
    params = [init_params(cfg, seed, "cpu") for seed in range(rounds + 1)]
    eng = _engine(params[0])
    bs = ENGINE["kv_block_size"]
    n_blocks = 3
    try:
        for r in range(rounds):
            prompt = [2 + 7 * r + i for i in range(n_blocks * bs)] + [1]
            for _ in range(2):
                list(eng.generate_sync(prompt, 2))
            eng.stage_weights(params[r + 1], version=r + 1)
            # an unrelated request lands the swap and lets its
            # re-prefill finish
            list(eng.generate_sync([60 - r, 61, 62], 1))
            _settle(eng, (r + 1) * n_blocks)
        s = eng.stats()
    finally:
        eng.shutdown()
    assert s["weight_swaps"] == rounds
    assert s["rewarm_blocks"] == rounds * n_blocks
    assert s["prefix_hit_blocks_total"] == rounds * n_blocks
