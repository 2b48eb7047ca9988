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

FGMRES's restart-time compaction (its ``subset`` argument: the columns'
operators narrowed to the pairs still going) is held against the same
solve without it, on four batches at 40x40 with restart 4: five pairs
that stop apart (down to one going pair), five whose two slowest are the
same system (down to two), three copies of one system (they stop
together) and one pair (never narrowed).  Its counters are held to what
the halving rule implies from each pair's own cycles (the pair solved
alone) and each cycle's columns.  The answers are bit for bit the solve's
without it: the narrowed operators are per pixel, and B7, the norms and
the least squares still run on the whole batch.  The same holds through
``flow.variational.solve_frame_pair``, which gives the provider of the
pairs' operators to its main FGMRES solve and to each correction solve.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.solve import krylov as jkrylov
from opticalflow_tpu.solve import multigrid as jmg
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
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


# (alpha_s, alpha_r) of each pair
COMPACTION_CASES = {
    "apart": [(30.0, 3.0), (300.0, 100.0), (3000.0, 1000.0), (3e4, 1e4), (1e5, 10.0)],
    "last_two_equal": [(1e5, 10.0), (30.0, 3.0), (300.0, 100.0), (3000.0, 1000.0),
                       (3000.0, 1000.0)],
    "together": [(3000.0, 1000.0)] * 3,
    "one": [(300.0, 100.0)],
}
COMPACTION_KW = dict(rtol=1e-9, max_iterations=400, tol_floor_eps_multiple=0.0, restart=4)


def _compaction_system(alphas):
    """b, the batch's matvec and multigrid preconditioner, and the
    operators of the pairs ``idx`` sliced from them as
    ``flow.variational.solve_frame_pair`` slices them for FGMRES."""
    m = n = 40
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=m + 2, width=10.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    prev, cur = np.repeat(movie[:1], len(alphas), 0), np.repeat(movie[1:], len(alphas), 0)
    a_s = np.array([a for a, _ in alphas]) / 1e4
    a_r = np.array([a for _, a in alphas])
    pair = elop.compute_frame_pair_data(*(torch.from_numpy(t) for t in (prev, cur, a_s, a_r)),
                                        "compat")
    matvec = _fused(prev, a_s, a_r)
    h = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), m, n, torch.float64)

    def operators_of(idx):
        i = idx.numpy()
        fine = _fused(prev[i], a_s[i], a_r[i])
        return fine, functools.partial(multigrid.v_cycle, multigrid.take(h, idx, fine, True))

    b = pair.rhs[:, :, 1:-1, 1:-1].contiguous()
    return b, (matvec, functools.partial(multigrid.v_cycle, h)), operators_of


def _recorded(operators, events):
    """The operators, each call appended to ``events`` as (``'M'`` or
    ``'P'``, batch size)."""
    matvec, precond = operators

    def mv(u):
        events.append(("M", u.shape[0]))
        return matvec(u)

    def pc(r):
        events.append(("P", r.shape[0]))
        return precond(r)

    return mv, pc


def _solve_recorded(b, operators, operators_of=None):
    """FGMRES with its operators' calls recorded; the result, the columns of
    each cycle (a column is one preconditioner call and one matvec call),
    the batch size of each column, the ``subset`` calls' indices and the
    counters."""
    events, subsets = [], []
    subset = None
    if operators_of is not None:
        def subset(idx):
            subsets.append(idx.tolist())
            return _recorded(operators_of(idx), events)
    observability.reset()
    mv, pc = _recorded(operators, events)
    res = krylov.fgmres(mv, b, precond=pc, subset=subset, **COMPACTION_KW)
    kinds = "".join(kind for kind, _ in events)
    columns = [len(run) // 2 for run in re.findall("(?:PM)+", kinds)]
    sizes = [size for kind, size in events if kind == "P"]
    return res, columns, sizes, subsets, observability.counts()


@pytest.mark.parametrize("case", sorted(COMPACTION_CASES))
def test_fgmres_compaction_narrows_to_going_pairs_and_keeps_each_answer(case):
    alphas = COMPACTION_CASES[case]
    b, operators, operators_of = _compaction_system(alphas)
    B = b.shape[0]
    plain, columns, plain_sizes, _, plain_counts = _solve_recorded(b, operators)
    res, columns_c, sizes, subsets, counts = _solve_recorded(b, operators, operators_of)

    # each pair alone: its cycles (a pair of one is never narrowed)
    cycles = []
    for p in range(B):
        alone, alone_columns, _, never, alone_counts = _solve_recorded(
            b[p : p + 1], operators_of(torch.tensor([p])), operators_of)
        assert not never and "krylov/compactions" not in alone_counts
        assert alone.iterations[0] == plain.iterations[p]
        cycles.append(len(alone_columns))

    # the halving rule on the going pairs after each restart
    batch, slot_columns, compactions, taken = B, 0, 0, []
    for c, cols in enumerate(columns):
        slot_columns += batch * cols
        going = [p for p in range(B) if cycles[p] > c + 1]
        if 1 <= len(going) <= batch // 2:
            batch, compactions = len(going), compactions + 1
            taken.append(going)
    assert columns_c == columns and len(columns) == max(cycles)
    assert plain_counts["krylov/slot_columns"] == B * sum(columns) == sum(plain_sizes)
    assert "krylov/compactions" not in plain_counts
    assert counts.get("krylov/compactions", 0) == compactions and subsets == taken
    assert counts["krylov/slot_columns"] == slot_columns == sum(sizes)
    assert counts["krylov/host_syncs"] == plain_counts["krylov/host_syncs"]
    if case in ("together", "one"):
        assert compactions == 0
    else:
        assert compactions >= 1 and len(set(cycles)) > 2 and slot_columns < B * sum(columns)
    assert min(sizes) == {"apart": 1, "last_two_equal": 2}.get(case, B)
    for field in krylov.KrylovResult._fields:
        assert torch.equal(getattr(res, field), getattr(plain, field)), field


def test_the_pair_solve_narrows_each_fgmres_solve_on_sliced_operators(monkeypatch):
    """Four pairs at their own alphas, ``method='gmres'`` at restart 4: the
    main solve and each correction solve of the refinement get the provider
    of their pairs' sliced operators, and the main solve narrows its
    columns; the flow and the info are those of the same call without any
    provider, bit for bit."""
    from opticalflow_tpu_torch.flow import variational

    movie, _ = make_translating_blob_movie(n_frames=2, dimension=40, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = torch.from_numpy((movie * 100.0).astype(np.float32))
    prev, cur = movie[:1].expand(4, 40, 40), movie[1:].expand(4, 40, 40)
    a_s = torch.tensor([100.0, 300.0, 3000.0, 1e5])
    a_r = torch.tensor([300.0, 1000.0, 100.0, 1e5])
    given, fgmres = [], krylov.fgmres

    def recorded(*args, subset=None, drop=False, **kw):
        before = observability.counts().get("krylov/compactions", 0)
        res = fgmres(*args, subset=None if drop else subset, **kw)
        given.append((subset is not None, observability.counts().get("krylov/compactions", 0)
                      - before))
        return res

    def solve(drop):
        given.clear()
        monkeypatch.setattr(krylov, "fgmres", functools.partial(recorded, drop=drop))
        observability.reset()
        return variational.solve_frame_pair(prev, cur, torch.zeros(3, 40, 40), a_s, a_r,
                                            method="gmres", gmres_restart=4)

    u, info = solve(drop=False)
    assert len(given) > 1 and all(provided for provided, _ in given) and given[0][1] >= 1
    u_w, info_w = solve(drop=True)
    assert not any(compactions for _, compactions in given)
    assert len(set(info["iterations"].tolist())) > 1
    assert torch.equal(u, u_w)
    for key in info:
        assert torch.equal(info[key], info_w[key]), key
