"""The JAX package's ``tests/serve/test_llm_engine.py`` bodies on the
port's serving runtime (loaded by ``tests/test_torch_runtime_loader.py``):
``LLMServer`` behind ``serve.run``, its streaming handle, its stats and
flight-recorder events, and the replica-kill legs."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

_ENGINE = ("builds a JAX engine in-process (MODEL_KW carries a JAX dtype); "
           "the engine's scheduler, prefix sharing, speculation, warm-up "
           "and stats are held on the port's engine against the JAX one "
           "by tests/test_torch_engine.py and "
           "tests/test_torch_engine_features.py")

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_concurrent_streams_no_leaks_and_deterministic": _ENGINE,
    "test_cancel_frees_slot_and_blocks": _ENGINE,
    "test_admission_under_full_occupancy_waits_not_recompiles": _ENGINE,
    "test_eos_stops_stream_early": _ENGINE,
    "test_oversized_prompt_fails_typed": _ENGINE,
    "test_step_loop_death_fails_requests_typed_no_hang": _ENGINE,
    "test_prefix_sharing_bit_identical_with_hits": _ENGINE,
    "test_cow_on_fully_aligned_prompt": _ENGINE,
    "test_concurrent_same_prompt_share_blocks": _ENGINE,
    "test_cancel_and_eos_decref_not_leak": _ENGINE,
    "test_pool_pressure_evicts_lru_and_admits": _ENGINE,
    "test_speculative_decode_bit_identical": _ENGINE,
    "test_speculation_with_eos_mid_chain": _ENGINE,
    "test_draft_prompt_lookup_unit": _ENGINE,
    "test_low_acceptance_disables_slot": _ENGINE,
    "test_compile_once_with_sharing_and_speculation": _ENGINE,
    "test_stats_decode_wall_split_and_page_accounting": _ENGINE,
    "test_stats_expose_trie_root_fingerprints": _ENGINE,
    "test_warmup_compiles_then_resets_session_stats": _ENGINE,
    "test_kv_block_math": _ENGINE,
}

globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_llm_engine.py", LEAVE_OUT))
