"""The JAX package's ``tests/serve/test_disagg.py`` bodies on the port's
serving runtime (loaded by ``tests/test_torch_runtime_loader.py``): the
router's fleet backfill, and the disaggregated fleets' drain migration
and chaos legs through ``DisaggRouter`` (whose colocated reference
engine, the file's ``_engine``, is the port's on the CPU here)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

_CODEC = ("packs numpy slabs (ml_dtypes bfloat16 among them); the port's "
          "codec packs tensors, and tests/test_torch_disagg.py holds it "
          "against the JAX codec, payloads crossing both ways")
_ENGINE = ("builds JAX engines in-process; tests/test_torch_disagg.py "
           "holds the hand-off, warm-prefix export and import on the "
           "port's engines against the JAX engine's streams")

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_kv_wire_bf16_bit_exact": _CODEC,
    "test_kv_wire_oob_serializer_roundtrip": _CODEC,
    "test_kv_wire_int8_uneven_last_block": _CODEC,
    "test_kv_wire_rejects_bad_input": _CODEC,
    "test_kv_ship_bytes_analytic_matches_packed": _CODEC,
    "test_handoff_bit_parity_bf16": _ENGINE,
    "test_handoff_int8_decode_parity": _ENGINE,
    "test_adopt_block_size_mismatch_raises": _ENGINE,
    "test_adopt_prefix_hit_skips_shipped_blocks": _ENGINE,
    "test_export_warm_prefixes_hits_floor": _ENGINE,
    "test_import_never_evicts_under_pressure": _ENGINE,
}



def port_engine(**kw):
    """The port's counterpart of the JAX file's ``_engine``, the chaos
    legs' colocated reference: the same model and engine knobs on the
    port's engine on the CPU, its weights drawn from seed 0 as the
    replicas draw theirs."""
    import torch

    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.serve.llm_engine import EngineConfig, LLMEngine
    cfg = TransformerConfig(**dict(MODEL_DICT, dtype=torch.float32))
    return LLMEngine(cfg, EngineConfig(**dict(ENGINE_KW, **kw)),
                     device="cpu")


globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_disagg.py", LEAVE_OUT,
                                 replace={"_engine": port_engine}))
