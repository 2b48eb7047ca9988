"""The slice with ``warm_start='cold'`` (all pairs batched from the initial
guess) and ``dy_mode='fixed'`` against the JAX package; tolerances and the
check are in tests/test_torch_flow.py.  One JAX compile per file, so that
the files spread over the test workers."""

from test_torch_flow import check_slice


def test_cold_fixed_matches_jax():
    check_slice("cold", "fixed")
