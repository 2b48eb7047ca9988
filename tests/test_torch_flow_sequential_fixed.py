"""The slice with ``warm_start='sequential'`` (each pair from the previous
pair's solution) and ``dy_mode='fixed'`` against the JAX package; tolerances
and the check are in tests/test_torch_flow.py.  One JAX compile per file, so
that the files spread over the test workers."""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

from test_torch_flow import check_slice


def test_sequential_fixed_matches_jax():
    check_slice("sequential", "fixed")
