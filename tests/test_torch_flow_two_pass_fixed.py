"""The slice with ``warm_start='two-pass'`` and ``dy_mode='fixed'`` against
the JAX package; tolerances and the check are in tests/test_torch_flow.py."""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

from test_torch_flow import check_slice


def test_two_pass_fixed_matches_jax():
    check_slice("two-pass", "fixed")
