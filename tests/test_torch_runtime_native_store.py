"""The JAX package's ``tests/core/test_native_store.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_cross_process_visibility":
        "its child starts through multiprocessing's spawn, which pickles "
        "the target by reference, and the loaded module exists only in "
        "this process",
}

globals().update(FIXTURES)
globals().update(load_core_tests("test_native_store.py", LEAVE_OUT))
