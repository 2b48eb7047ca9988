"""The slice with ``warm_start='sequential'`` (each pair from the previous
pair's solution) and ``dy_mode='compat'`` against the JAX package;
tolerances and the check are in tests/test_torch_flow.py.  One JAX compile
per file, so that the files spread over the test workers."""

from test_torch_flow import check_slice


def test_sequential_compat_matches_jax():
    check_slice("sequential", "compat")
