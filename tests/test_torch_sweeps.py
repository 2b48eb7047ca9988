"""The port's regularisation sweep and shgo tuner
(``opticalflow_tpu_torch.analysis``) against the JAX package's, on the CPU.

One JAX compile of a solve in this file: the JAX batched sweep (the tuner's
direct objective solves on the host, with no compile).  The movie is the
JAX package's own sweep fixture (tests/test_analysis.py): 3 frames of
24x24, x100.

Tolerances:
* port vs JAX batched sweep, both float64 (x64): every statistic to rtol
  1e-4, the JAX package's own bound between its batched and serial sweeps
  (both stop at residuals under rtol 1e-6, at different iterates; measured,
  the remodelling variances differ by up to 4e-6 relative), the converged
  masks equal;
* chunk invariance: rtol 1e-10 (each pair's arithmetic does not depend on
  the other pairs of its batch), as the JAX package's own test;
* batched vs serial, float64, rtol 1e-10 solves: the JAX package's own
  bounds (speed means rtol 1e-4, remodelling means rtol 1e-3);
* tuner with the direct objective, both float64 assembled solves: the
  optimum to rtol 1e-6 and the minimum to rtol 1e-9 (functionals that
  agree to ~1e-12; the local minimiser's finite-difference steps may take a
  few more or fewer evaluations).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import numpy as np
import pytest
import torch

from opticalflow_tpu.analysis import sweeps as jsweeps
from opticalflow_tpu.analysis import tuning as jtuning
from opticalflow_tpu_torch import SolverConfig
from opticalflow_tpu_torch.analysis import sweeps, tuning
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.utils import observability

F64 = dict(device="cpu", dtype=torch.float64)
KEYS = ("speed_means", "speed_variances", "remodelling_means", "remodelling_variances",
        "functional", "functional_ref_compat")


@pytest.fixture(scope="module")
def movie():
    movie, delta_x = make_translating_blob_movie(n_frames=3, dimension=24, width=10.0, sigma=2.5,
                                                 v_x=0.2, v_y=0.1)
    return movie * 100.0, delta_x


def test_batched_sweep_matches_jax(movie):
    m, delta_x = movie
    grid = (np.array([200.0, 1000.0]), np.array([500.0, 1500.0]))
    ours = sweeps.vary_regularisation(m, *grid, delta_x=delta_x, **F64)
    theirs = jsweeps.vary_regularisation(m, *grid, delta_x=delta_x)
    assert sorted(ours) == sorted(theirs)
    np.testing.assert_array_equal(ours["speed_alpha_values"], theirs["speed_alpha_values"])
    np.testing.assert_array_equal(ours["converged"], theirs["converged"])
    assert ours["converged"].all()
    for key in KEYS:
        assert ours[key].shape == (2, 2)
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, err_msg=key)


def test_batched_sweep_chunk_invariance(movie):
    m, _ = movie
    a_s, a_r = np.logspace(1, 3, 2), np.logspace(1, 3, 3)
    observability.reset()
    whole = sweeps.vary_regularisation(m, a_s, a_r, batch_chunk=1000, **F64)
    chunked = sweeps.vary_regularisation(m, a_s, a_r, batch_chunk=3, **F64)
    # one chunk of 6 cells, then 6 chunks of one cell (3 // 2 pairs)
    assert len(observability.values()["sweep/chunk_max_iterations"]) == 7
    for key in KEYS + ("converged",):
        np.testing.assert_allclose(chunked[key], whole[key], rtol=1e-10, atol=1e-12, err_msg=key)


def test_batched_sweep_matches_serial(movie):
    m, delta_x = movie
    kw = dict(delta_x=delta_x, solver=SolverConfig(rtol=1e-10), **F64)
    batched = sweeps.vary_regularisation(m, np.array([200.0, 1000.0]), np.array([500.0]), **kw)
    serial = sweeps.vary_regularisation(m, np.array([200.0, 1000.0]), np.array([500.0]),
                                        batched=False, warm_start="cold", **kw)
    np.testing.assert_allclose(batched["speed_means"], serial["speed_means"], rtol=1e-4)
    np.testing.assert_allclose(batched["remodelling_means"], serial["remodelling_means"],
                               rtol=1e-3, atol=1e-8)
    # the serial path sums the result's 'speed_functional', which in compat
    # mode holds the remodelling functional (the reference's key defect)
    np.testing.assert_allclose(batched["functional_ref_compat"], serial["functional"],
                               rtol=1e-6)
    assert batched["converged"].all() and serial["converged"].all()
    assert "functional_ref_compat" not in serial


def test_batched_sweep_rejects_serial_only_kwargs(movie):
    m, _ = movie
    with pytest.raises(TypeError, match="does not support"):
        sweeps.vary_regularisation(m, [500.0], [500.0], warm_start="cold", device="cpu")


def test_sweep_saves_its_result(movie, tmp_path):
    m, delta_x = movie
    path = tmp_path / "sweep.npy"
    result = sweeps.vary_regularisation(m, [500.0, 1000.0], [500.0, 1000.0], delta_x=delta_x,
                                        filename=str(path), device="cpu")
    loaded = np.load(path, allow_pickle=True).item()
    assert sorted(loaded) == sorted(result)
    for key in KEYS:
        np.testing.assert_array_equal(loaded[key], result[key])


def test_tuner_with_the_direct_objective_matches_jax(movie):
    m, delta_x = movie
    kw = dict(delta_x=delta_x, bounds=[(2, 4), (2, 4)], use_direct_solver=True,
              shgo_kwargs={"n": 8, "iters": 1, "sampling_method": "sobol"})
    optimal, value, _ = tuning.optimize_regularisation_parameters(m[:2], device="cpu", **kw)
    j_optimal, j_value, _ = jtuning.optimize_regularisation_parameters(m[:2], **kw)
    assert optimal.shape == (2,) and 1e2 <= optimal[0] <= 1e4
    np.testing.assert_allclose(optimal, j_optimal, rtol=1e-6)
    np.testing.assert_allclose(value, j_value, rtol=1e-9)


def test_tuner_with_the_device_objective(movie):
    """The device objective (the Krylov solve, float32) on a tiny budget:
    its minimum is the direct functional at its optimum to rtol 1e-3 (a
    float32 solve to rtol 1e-6 against the float64 assembled one)."""
    m, delta_x = movie
    optimal, value, _ = tuning.optimize_regularisation_parameters(
        m[:2], delta_x=delta_x, bounds=[(2, 4), (2, 4)], use_direct_solver=False,
        shgo_kwargs={"n": 4, "iters": 1, "sampling_method": "sobol",
                     "minimizer_kwargs": {"options": {"maxiter": 2}}}, device="cpu")
    assert np.all((optimal >= 1e2) & (optimal <= 1e4))
    from opticalflow_tpu_torch import variational_optical_flow

    direct = variational_optical_flow(m[:2], delta_x=delta_x, speed_alpha=optimal[0],
                                      remodelling_alpha=optimal[1], use_direct_solver=True,
                                      dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(value, tuning.total_functional(direct), rtol=1e-3)
