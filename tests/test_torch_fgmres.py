"""The port's batched FGMRES and CG (solve.krylov) against the JAX
package's solvers under ``jax.vmap``: the port solves the batch at once
with per-pair freezing, the JAX reference vmaps its nested while_loops.

FGMRES runs on the reduced EL operator at 40x40 with the multigrid
preconditioner and short restarts, so that every pair restarts: restart 8,
where two of the three pairs end on the <1% stall stop, with and without
the truncation guard and with a ``max_iterations`` that ends a cycle in its
middle; and restart 12, where all three converge.  CG runs on a symmetric
positive definite operator (a shifted 5-point Laplacian per field, a
different shift per pair) with a Jacobi preconditioner.

Tolerances: float64 throughout, the same algorithms step for step, so the
iteration counts must agree exactly and the iterates to rounding, amplified
by the few tens of Krylov steps: 1e-10 of their norm.  The final residual
norms agree to 1e-6 relative, or to 1e-14 of ||b|| where a converged
residual is itself at the rounding level of its evaluation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.solve import krylov as jkrylov
from opticalflow_tpu.solve import multigrid as jmg
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.solve import krylov, multigrid
from opticalflow_tpu_torch.utils import observability
from test_torch_solve import _fused, _systems

X_TOL = 1e-10


def _assert_same(res, res_j, b):
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(res_j.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(res_j.converged))
    x, x_j = res.x.numpy(), np.asarray(res_j.x)
    for k in range(x.shape[0]):
        assert np.abs(x[k] - x_j[k]).max() <= X_TOL * np.abs(x_j[k]).max(), k
    # the final norms, evaluated apart, differ by rounding of ||b - A x||
    b_norm = np.sqrt((b.reshape(b.shape[0], -1) ** 2).sum(axis=1))
    np.testing.assert_allclose(res.residual_norm.numpy(), np.asarray(res_j.residual_norm),
                               rtol=1e-6, atol=1e-14 * b_norm.max())


@functools.partial(jax.jit, static_argnames=("restart", "truncation_guard"))
def _jax_fgmres(coeffs, b, max_iterations, restart, truncation_guard):
    """The JAX solver under vmap; ``max_iterations`` is traced, so that the
    cases that differ only in it share one compile."""
    m, n = b.shape[-2:]

    def solve_one(c, bb):
        mv = functools.partial(jelop.el_matvec_reduced, c)
        pc = functools.partial(jmg.v_cycle, jmg.setup(mv, jelop.diag_blocks(c), m, n,
                                                      jnp.float64))
        return jkrylov.fgmres(mv, bb, precond=pc, rtol=1e-9, max_iterations=max_iterations,
                              tol_floor_eps_multiple=0.0, restart=restart,
                              truncation_guard=truncation_guard)

    return jax.vmap(solve_one)(coeffs, b)


@pytest.mark.parametrize("restart,truncation_guard,max_iterations",
                         [(8, True, 400), (8, False, 400), (8, True, 13), (12, True, 400)])
def test_batched_fgmres_matches_vmapped_jax(restart, truncation_guard, max_iterations):
    m = n = 40
    prev, a_s, a_r, ours, theirs = _systems(m, n)
    b_red = ours.rhs[:, :, 1:-1, 1:-1].contiguous()
    matvec = _fused(prev, a_s, a_r)
    h = multigrid.setup(matvec, elop.diag_blocks(ours.coeffs), m, n, torch.float64)
    kw = dict(rtol=1e-9, max_iterations=max_iterations, tol_floor_eps_multiple=0.0,
              restart=restart, truncation_guard=truncation_guard)
    observability.reset()
    res = krylov.fgmres(matvec, b_red, precond=functools.partial(multigrid.v_cycle, h), **kw)
    assert observability.counts()["krylov/host_syncs"] > 0

    coeffs_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[t.coeffs for t in theirs])
    res_j = _jax_fgmres(coeffs_j, jnp.asarray(b_red.numpy()), jnp.int32(max_iterations),
                        restart=restart, truncation_guard=truncation_guard)
    _assert_same(res, res_j, b_red.numpy())
    its, conv = res.iterations.numpy(), res.converged.numpy()
    assert (its > restart).all()  # every pair restarted
    if max_iterations < 400:
        assert (its == max_iterations).all() and not conv.any()
    elif restart == 8:
        assert (~conv & (its < max_iterations)).sum() == 2 and conv.sum() == 1  # stall stop
    else:
        assert conv.all() and len(set(its.tolist())) == 3  # pairs stop apart


def _laplacian_shift(shifts, lib):
    """SPD operator per pair: (4 + s_b) u - (sum of the 4 neighbours), zero
    outside the grid, on (B, 3, m, n) fields."""
    if lib == "torch":
        def mv(u):
            p = F.pad(u, (1, 1, 1, 1))
            nb = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]
            return (4.0 + shifts[:, None, None, None]) * u - nb
        return mv

    def mv_one(s, u):
        p = jnp.pad(u, ((0, 0), (1, 1), (1, 1)))
        nb = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
        return (4.0 + s) * u - nb
    return mv_one


@pytest.mark.parametrize("max_iterations", [500, 7])
def test_batched_cg_matches_vmapped_jax(max_iterations):
    m, n = 24, 30
    shifts = np.array([0.05, 0.5, 0.005])
    b = np.random.default_rng(3).standard_normal((3, 3, m, n))
    kw = dict(rtol=1e-10, max_iterations=max_iterations, tol_floor_eps_multiple=0.0)
    s_t = torch.from_numpy(shifts)
    res = krylov.cg(_laplacian_shift(s_t, "torch"), torch.from_numpy(b),
                    precond=lambda r: r / (4.0 + s_t[:, None, None, None]), **kw)

    mv_one = _laplacian_shift(None, "jax")

    def solve_one(s, bb):
        return jkrylov.cg(functools.partial(mv_one, s), bb, precond=lambda r: r / (4.0 + s),
                          **kw)

    res_j = jax.jit(jax.vmap(solve_one))(jnp.asarray(shifts), jnp.asarray(b))
    _assert_same(res, res_j, b)
    its = res.iterations.numpy()
    if max_iterations < 500:
        assert (its == max_iterations).all()
    else:
        assert res.converged.all() and len(set(its.tolist())) > 1
