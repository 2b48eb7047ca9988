"""The port's batched BiCGStab (solve.krylov) and multigrid
(solve.multigrid) against the JAX package on the same EL systems: the
port solves the batch at once, the JAX reference one pair at a time (its
own ``vmap`` for BiCGStab).

Tolerances: float64 throughout, so the two agree to rounding.  Transfers,
probing and the block inverses are the same arithmetic (rtol 1e-12); the
V-cycle adds a dense LU solve from another library (rtol 1e-9).  With the
multigrid preconditioner BiCGStab takes ~10 iterations, and the iteration
counts must agree exactly and the best iterates to 1e-8 of their norm.
With block-Jacobi it takes ~170, over which rounding differences shift
each pair's exit by a few iterations: counts agree within 5%, and both
iterates meet rtol 1e-9, so they agree to 1e-6 of their norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.solve import krylov as jkrylov
from opticalflow_tpu.solve import multigrid as jmg
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels, elop
from opticalflow_tpu_torch.solve import krylov, multigrid

ALPHAS = [(1000.0, 1000.0), (200.0, 2000.0), (5000.0, 500.0)]


def _systems(m, n, dy_mode="compat"):
    """Normalised frames, per-pair alphas and the port's / JAX's pair data."""
    movie, _ = make_translating_blob_movie(n_frames=4, dimension=max(m, n) + 2, width=10.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    movie = movie[:, : m + 2, : n + 2]
    prev, cur = movie[:-1], movie[1:]
    a_s = np.array([a for a, _ in ALPHAS]) / 1e4  # as if normalised by a scale of 100
    a_r = np.array([a for _, a in ALPHAS])
    ours = elop.compute_frame_pair_data(torch.from_numpy(prev), torch.from_numpy(cur),
                                        torch.from_numpy(a_s), torch.from_numpy(a_r), dy_mode)
    theirs = [jelop.compute_frame_pair_data(jnp.asarray(prev[b]), jnp.asarray(cur[b]),
                                            a_s[b], a_r[b], dy_mode) for b in range(len(ALPHAS))]
    return prev, a_s, a_r, ours, theirs


def _fused(prev, a_s, a_r, compat=True):
    I = torch.from_numpy(np.ascontiguousarray(prev))
    scalars = torch.from_numpy(np.stack([a_s, a_r], axis=-1))
    return lambda u: cuda_kernels.el_matvec_reduced_fused(I, scalars, u.contiguous(), compat)


def test_transfers_match_jax():
    c = np.random.default_rng(0).standard_normal((2, 3, 9, 6))
    fine = multigrid.prolong(torch.from_numpy(c), (17, 12)).numpy()
    back = multigrid.restrict(torch.from_numpy(fine), (9, 6)).numpy()
    for b in range(2):
        np.testing.assert_allclose(fine[b], np.asarray(jmg.prolong(jnp.asarray(c[b]), (17, 12))),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(back[b], np.asarray(jmg.restrict(jnp.asarray(fine[b]), (9, 6))),
                                   rtol=1e-12, atol=1e-15)


def test_probe_stencil_and_block_inverse_match_jax():
    m, n = 17, 22
    prev, a_s, a_r, ours, theirs = _systems(m, n)
    S = multigrid.probe_stencil(_fused(prev, a_s, a_r), 3, m, n, torch.float64, "cpu").numpy()
    binv = multigrid.invert_blocks(elop.diag_blocks(ours.coeffs)).numpy()
    for b, t in enumerate(theirs):
        S_j = jmg.probe_stencil(functools.partial(jelop.el_matvec_reduced, t.coeffs), m, n,
                                jnp.float64)
        np.testing.assert_allclose(S[b], np.asarray(S_j), rtol=1e-12, atol=1e-12)
        binv_j = jmg.invert_blocks(jelop.diag_blocks(t.coeffs))
        np.testing.assert_allclose(binv[b], np.asarray(binv_j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(21, 26), (8, 7)])
def test_setup_and_v_cycle_match_jax(shape):
    m, n = shape
    prev, a_s, a_r, ours, theirs = _systems(m, n)
    h = multigrid.setup(_fused(prev, a_s, a_r), elop.diag_blocks(ours.coeffs), m, n,
                        torch.float64)
    r = np.random.default_rng(1).standard_normal((3, 3, m, n))
    z = multigrid.v_cycle(h, torch.from_numpy(r)).numpy()

    @jax.jit
    def v_cycle_one(c, rb):
        mv = functools.partial(jelop.el_matvec_reduced, c)
        return jmg.v_cycle(jmg.setup(mv, jelop.diag_blocks(c), m, n, jnp.float64), rb)

    for b, t in enumerate(theirs):
        z_j = np.asarray(v_cycle_one(t.coeffs, jnp.asarray(r[b])))
        np.testing.assert_allclose(z[b], z_j, rtol=1e-9, atol=1e-9 * np.abs(z_j).max())
    # levels halve down to min(m, n) <= 8 (21x26 -> 11x13 -> 6x7; 8x7 alone)
    assert len(h.levels) == (3 if m > 8 else 1)


@pytest.mark.parametrize("preconditioner", ["block_jacobi", "multigrid"])
def test_batched_bicgstab_matches_vmapped_jax(preconditioner):
    m, n = 17, 15
    prev, a_s, a_r, ours, theirs = _systems(m, n, "fixed")
    b_red = ours.rhs[:, :, 1:-1, 1:-1].contiguous()
    matvec = _fused(prev, a_s, a_r, compat=False)
    if preconditioner == "multigrid":
        h = multigrid.setup(matvec, elop.diag_blocks(ours.coeffs), m, n, torch.float64)
        precond = functools.partial(multigrid.v_cycle, h)
    else:
        precond = functools.partial(elop.block_jacobi_inverse_apply_interior, ours.coeffs)
    kw = dict(rtol=1e-9, max_iterations=400, tol_floor_eps_multiple=0.0)
    res = krylov.bicgstab(matvec, b_red, precond=precond, **kw)

    coeffs_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[t.coeffs for t in theirs])

    def solve_one(c, b):
        mv = functools.partial(jelop.el_matvec_reduced, c)
        if preconditioner == "multigrid":
            pc = functools.partial(jmg.v_cycle, jmg.setup(mv, jelop.diag_blocks(c), m, n,
                                                          jnp.float64))
        else:
            pc = functools.partial(jelop.block_jacobi_inverse_apply_interior, c)
        return jkrylov.bicgstab(mv, b, precond=pc, **kw)

    res_j = jax.vmap(solve_one)(coeffs_j, jnp.asarray(b_red.numpy()))
    its, its_j = res.iterations.numpy(), np.asarray(res_j.iterations)
    assert len(set(its.tolist())) > 1  # pairs stop at different iterations
    assert res.converged.all() and np.asarray(res_j.converged).all()
    if preconditioner == "multigrid":
        np.testing.assert_array_equal(its, its_j)
        x_tol = 1e-8
    else:
        np.testing.assert_allclose(its, its_j, rtol=0.05)
        x_tol = 1e-6
    x_j = np.asarray(res_j.x)
    for b in range(3):
        assert np.abs(res.x[b].numpy() - x_j[b]).max() <= x_tol * np.abs(x_j[b]).max()
