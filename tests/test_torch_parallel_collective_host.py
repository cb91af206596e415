"""The JAX package's ``tests/parallel/test_collective.py`` bodies on the
port's collective layer (loaded by ``tests/test_torch_runtime_loader.py``):
the ``host`` backend across actor processes through the runtime's KV
store, and declarative group creation."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

# The "xla" bodies drive the JAX package's in-graph stubs, which take every
# rank's tensor stacked (world, *shape) in one process; the port's eager ops
# take this rank's tensor on each rank, and tests/test_torch_parallel_
# collective.py holds them against those stubs on four gloo ranks.
XLA = ("the JAX 'xla' stub takes stacked per-rank tensors in one process; "
       "tests/test_torch_parallel_collective.py holds the port's eager ops "
       "against it on gloo ranks")
LEAVE_OUT = {
    "test_xla_allreduce": XLA,
    "test_xla_allgather_reducescatter": XLA,
    "test_quantized_allreduce_parity_across_world_sizes": XLA,
    "test_quantized_allreduce_stochastic_and_op_validation": XLA,
    "test_quantized_reducescatter_parity": XLA,
}

globals().update(FIXTURES)
globals().update(load_core_tests("parallel/test_collective.py", LEAVE_OUT))
