"""Properties of the port's variational flow that the JAX package's tests
hold of its own, at those tests' sizes, on the CPU: the port alone, no
JAX compile.

* ``tests/test_variational.py:100``: cold = sequential warm start when
  converged (solver rtol 1e-12; fields to rtol 1e-4, atol 1e-7);
* ``:199``: two-pass = cold (v_x and remodelling to the same bounds), and
  pairs 1+ take no more iterations than the cold maximum;
* ``:109``: the low-alpha direct path (``use_direct_solver=True``) is
  finite;
* ``tests/test_physics.py:48``: a non-uniform remodelling ramp under
  uniform advection is recovered to that test's bounds.

The JAX tests run with x64 enabled (tests/conftest.py), so their solves
are float64; the port's here are too (``dtype=torch.float64``).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.core.synth import (make_remodelling_ramp_movie,
                                              make_translating_blob_movie)

CPU = dict(device="cpu", dtype=torch.float64)
INTERIOR = np.s_[8:-8, 8:-8]


@pytest.fixture(scope="module")
def small_movie():
    """tests/test_variational.py's movie: 3 frames of 24x24."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=24, width=10.0, sigma=2.5, v_x=0.2, v_y=0.1)
    return movie * 100.0, delta_x


@pytest.fixture(scope="module")
def tight(small_movie):
    movie, delta_x = small_movie
    kwargs = dict(delta_x=delta_x, speed_alpha=100.0, remodelling_alpha=100.0,
                  solver=SolverConfig(rtol=1e-12), **CPU)
    return {mode: variational_optical_flow(movie, warm_start=mode, **kwargs)
            for mode in ("sequential", "cold", "two-pass")}


def test_warm_start_cold_matches_sequential_when_converged(tight):
    assert tight["sequential"]["converged_all"].all() and tight["cold"]["converged_all"].all()
    np.testing.assert_allclose(tight["sequential"]["v_x"], tight["cold"]["v_x"], rtol=1e-4,
                               atol=1e-7)


def test_warm_start_two_pass_matches_cold_when_converged(tight):
    cold, two_pass = tight["cold"], tight["two-pass"]
    np.testing.assert_allclose(two_pass["v_x"], cold["v_x"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(two_pass["remodelling"], cold["remodelling"], rtol=1e-4,
                               atol=1e-7)
    assert two_pass["converged_all"].all()
    assert two_pass["iterations"].shape == cold["iterations"].shape
    # the broadcast warm start removes Krylov work from the batched pairs
    assert int(two_pass["iterations"][1:].max()) <= int(cold["iterations"].max())


def test_low_alpha_regime_uses_direct_solver(small_movie):
    movie, delta_x = small_movie
    res = variational_optical_flow(movie, delta_x=delta_x, speed_alpha=1.0,
                                   remodelling_alpha=10.0, use_direct_solver=True, **CPU)
    assert np.isfinite(res["v_x"]).all()


def test_recovers_nonuniform_remodelling_ramp():
    v_x, v_y, g_max = 0.3, 0.5, 5.0
    movie, delta_x, gamma_true = make_remodelling_ramp_movie(
        dimension=64, v_x=v_x, v_y=v_y, remodelling_max=g_max, background="texture")
    res = variational_optical_flow(movie, delta_x=delta_x, delta_t=1.0, speed_alpha=1e5,
                                   remodelling_alpha=30.0, dy_mode="fixed", **CPU)
    assert bool(res["converged"])
    m = INTERIOR
    gamma_mae = np.abs(res["remodelling"][0] - gamma_true)[m].mean()
    assert gamma_mae / g_max < 0.04
    assert abs(res["v_x"][0][m].mean() - v_x) < 0.05
    assert abs(res["v_y"][0][m].mean() - v_y) < 0.06
    # the ramp runs along axis 1: the recovered slope, not just the MAE
    g = res["remodelling"][0]
    slope_true = gamma_true[32, -9] - gamma_true[32, 8]
    slope_rec = g[32, -9] - g[32, 8]
    assert abs(slope_rec - slope_true) / slope_true < 0.1
