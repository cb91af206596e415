"""The JAX package's ``tests/core/test_serialization_oob.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_nested_device_array_ships_out_of_band":
        "a jax.Array body; tests/test_torch_runtime_tensors.py holds "
        "tensors to the same contract",
    "test_restore_is_zero_copy_view":
        "a jax.Array body; a tensor is restored as a copy (see "
        "tests/test_torch_runtime_tensors.py)",
    "test_bfloat16_roundtrips":
        "a jax.Array body; tests/test_torch_runtime_tensors.py",
    "test_top_level_device_array_unchanged_contract":
        "a jax.Array body; tests/test_torch_runtime_tensors.py",
    "test_to_host": "a jax.Array body; tests/test_torch_runtime_tensors.py",
}

globals().update(FIXTURES)
globals().update(load_core_tests("test_serialization_oob.py", LEAVE_OUT))
