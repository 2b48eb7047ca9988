"""The slice as a whole: the port's ``variational_optical_flow`` against the
JAX package's on the same 5-frame 40x40 movie, in float32, and both
against the float64 assembled direct solve.

This file holds the shared check and the two-pass compat cases (with and
without ``smoothing_sigma``, one JAX compile); test_torch_flow_*.py run
the other warm-start / dy-mode cases, one JAX compile (~40 s) per file, so
that ``pytest-xdist --dist loadfile`` spreads them over its workers.

Tolerances (EPE = max over interior pixels of the flow endpoint error, px):
* each solve vs the float64 direct oracle: < 1e-3 px, the JAX package's
  own accuracy bar (tests/test_accuracy_gate.py);
* port vs JAX: < 1e-4 px.  Both refine the same float32 system to 0.1x
  the tolerance floor; measured, they agree to ~1e-5 px at this size;
* functionals: rtol 1e-4 (sums over the same solutions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.flow import variational as jvar
from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow import variational as pvar

ALPHAS = dict(speed_alpha=1000.0, remodelling_alpha=1000.0)
FUNCTIONALS = ("L1_functional", "remodelling_functional", "speed_functional")


def bench_movie(n_frames=5, dim=40):
    """The bench's blob movie (x100, rounded through float32)."""
    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=dim, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def epe(a, b):
    d = np.sqrt((a["v_x"] - b["v_x"]) ** 2 + (a["v_y"] - b["v_y"]) ** 2)
    return float(d[:, 1:-1, 1:-1].max())


def check_slice(warm_start, dy_mode, smoothing_sigma=None):
    movie = bench_movie()
    kw = dict(ALPHAS, warm_start=warm_start, dy_mode=dy_mode, smoothing_sigma=smoothing_sigma)
    ours = variational_optical_flow(movie, dtype=torch.float32, device="cpu", **kw)
    theirs = jvar.variational_optical_flow(movie, dtype=jnp.float32, **kw)
    oracle = variational_optical_flow(movie, dtype=torch.float64, use_direct_solver=True,
                                      device="cpu", **kw)

    assert sorted(ours.keys()) == sorted(theirs.keys())
    assert ours["converged_all"].all() and np.asarray(theirs["converged_all"]).all()
    assert ours["v_x"].shape == (4, 40, 40) and np.isfinite(ours["v_x"]).all()
    assert epe(ours, theirs) < 1e-4
    assert epe(ours, oracle) < 1e-3 and epe(theirs, oracle) < 1e-3
    keys = FUNCTIONALS + (("speed_functional_corrected",) if dy_mode == "compat" else ())
    for key in keys:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4)
    if dy_mode == "compat":
        # the reference's key duplication: 'speed_functional' holds the
        # remodelling functional
        assert ours["speed_functional"] == ours["remodelling_functional"]


@pytest.mark.parametrize("smoothing_sigma", [None, 1.5])
def test_two_pass_compat_matches_jax(smoothing_sigma):
    check_slice("two-pass", "compat", smoothing_sigma)


def test_port_raises_for_paths_not_ported():
    """Every path of the single-pair solve is ported: FGMRES, CG and the
    hybrid matvec run, and 'gspmd' selects the plain stencil, as in the JAX
    package (its _resolve_matvec_impl), so it equals 'xla' exactly."""
    movie = bench_movie(n_frames=2, dim=12)
    gspmd = variational_optical_flow(movie, solver=SolverConfig(matvec="gspmd"), device="cpu",
                                     **ALPHAS)
    xla = variational_optical_flow(movie, solver=SolverConfig(matvec="xla"), device="cpu",
                                   **ALPHAS)
    assert gspmd["converged_all"].all()
    for key in ("v_x", "v_y", "remodelling", "iterations"):
        np.testing.assert_array_equal(gspmd[key], xla[key])
    for cfg in (SolverConfig(method="gmres"), SolverConfig(method="cg"),
                SolverConfig(matvec="hybrid")):
        result = variational_optical_flow(movie, solver=cfg, device="cpu", **ALPHAS)
        assert np.isfinite(result["v_x"]).all()
    # 'auto' never falls back to BiCGStab where FGMRES is needed
    assert pvar.resolve_method("auto", 500, 7) == jvar.resolve_method("auto", 500, 7) == "gmres"
    assert pvar.resolve_method("auto", 499, 7) == "bicgstab"


def test_plain_matvec_and_block_jacobi_agree_with_the_default():
    """'xla' (plain stencil on precomputed planes) and the fused default
    solve the same system, for a batch of pairs (the multigrid setup
    probes it with a (B, 27, 3, m, n) stack); block-Jacobi reaches the same
    solution."""
    movie = bench_movie(n_frames=4, dim=24)
    kw = dict(ALPHAS, warm_start="cold")
    base = variational_optical_flow(movie, device="cpu", **kw)
    for cfg in (SolverConfig(matvec="xla"), SolverConfig(preconditioner="block_jacobi")):
        other = variational_optical_flow(movie, solver=cfg, device="cpu", **kw)
        assert other["converged_all"].all() and epe(base, other) < 1e-4
