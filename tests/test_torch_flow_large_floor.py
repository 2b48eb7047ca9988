"""The large-grid branch of tests/test_torch_flow_large.py refined to the
df32 floor of both packages (0.003 x tol): the port's float32 solve, with
the hybrid matvec and with the fused one, against the JAX package's refined
as far and the float64 direct solve.  Inputs, helpers, tolerances and the
eight threads are those of tests/test_torch_flow_large.py; its own file,
so that its JAX solve runs on another test worker than the default exit's.
"""

from torch_threads import eight_intra_op_threads  # noqa: F401,I001 (autouse; first: see its module)

import pytest

from test_torch_flow_large import TIGHT_EXIT, _solve, epe, references


@pytest.fixture(scope="module")
def floor_exit():
    return references(TIGHT_EXIT)


@pytest.mark.parametrize("matvec", ["hybrid", "auto"])
def test_large_grid_branch_refined_to_the_df32_floor_matches_jax(floor_exit, matvec):
    movie, oracle, jax_run = floor_exit
    ours = _solve(movie, matvec, TIGHT_EXIT)
    assert epe(ours, oracle) < 1e-3
    assert epe(ours, jax_run) < 1e-4
