"""The multigrid V-cycle's stages (solve.multigrid), the plain versions of
kernels B5 and B6 (B6's fused stages included: the last pre-sweep with the
residual-and-restrict, the prolong-add with the first post-sweep; the
standalone transfers also at the probes' K = 27), against the JAX package
on the same numpy-seeded inputs, and the restructured V-cycle against
JAX's and against the op-by-op composition it replaced.

Tolerances: float64 for every comparison with JAX.  The stencil apply sums
its 27 terms in JAX's order, one at a time: it equals JAX's function run op
by op exactly (rtol 0), and under ``jax.jit``, whose fusion contracts
products and sums into fused multiply-adds, to ~1e-14 (rtol 1e-12).  The
transfers, sweeps and their compositions are the same arithmetic in the
same order (rtol 1e-12); the V-cycle adds a dense
LU solve from another library (rtol 1e-9, as
``test_torch_solve.py::test_setup_and_v_cycle_match_jax``).  Against the
op-by-op float32 composition the stages are compared bit for bit: they
must keep every operation's order, which is what kernels B5 and B6
reproduce on the card (``tests/test_torch_gpu.py``).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.solve import multigrid as jmg
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.solve import multigrid

ALPHAS = [(1000.0, 1000.0), (200.0, 2000.0)]


def _rng(seed):
    return np.random.default_rng(seed)


def _level(seed, B, m, n):
    """A random level: S (B, 3, 3, 3, 3, m, n) and the planar block
    inverse (B, 3, 3, m, n), float64."""
    rng = _rng(seed)
    return rng.standard_normal((B, 3, 3, 3, 3, m, n)), rng.standard_normal((B, 3, 3, m, n))


def _jax_binv(binv_b):
    """A planar (3, 3, m, n) block inverse in JAX's (m, n, 3, 3) layout."""
    return jnp.asarray(np.moveaxis(binv_b, (0, 1), (2, 3)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("K", [1, 27, 192])
def test_stencil_matvec_matches_jax_exactly(K):
    B, m, n = 2, 9, 9
    S, _ = _level(0, B, m, n)
    u = _rng(1).standard_normal((B, 3, m, n) if K == 1 else (B, K, 3, m, n))
    y = multigrid.stencil_matvec(_t(S), _t(u)).numpy()
    for b in range(B):
        mv = functools.partial(jmg.stencil_matvec, jnp.asarray(S[b]))
        for jit in (False, True):
            f = jax.jit(mv) if jit else mv
            y_j = np.asarray(f(u[b]) if K == 1 else jax.vmap(f)(jnp.asarray(u[b])))
            if jit:  # XLA's fusion contracts products and sums into FMAs
                np.testing.assert_allclose(y[b], y_j, rtol=1e-12, atol=1e-12)
            else:  # op by op: the same roundings in the same order
                np.testing.assert_array_equal(y[b], y_j)


@pytest.mark.parametrize("shape", [(17, 22), (24, 31), (9, 9), (2, 2)])
def test_residual_restrict_and_prolong_add_match_jax(shape):
    B, (m, n) = 2, shape
    mc, nc = multigrid.coarse_dims(m, n)
    S, _ = _level(2, B, m, n)
    rng = _rng(3)
    x, b, y = (rng.standard_normal((B, 3, m, n)) for _ in range(3))
    e = rng.standard_normal((B, 3, mc, nc))
    got = {
        "b - S x": multigrid.residual_restrict(_t(S), _t(x), _t(b), None, (mc, nc)),
        "b - y": multigrid.residual_restrict(None, None, _t(b), _t(y), (mc, nc)),
        "S x": multigrid.residual_restrict(_t(S), _t(x), None, None, (mc, nc)),
        "y": multigrid.residual_restrict(None, None, None, _t(y), (mc, nc)),
        "x + P e": multigrid.prolong_add(_t(x), _t(e), (m, n)),
        "P e": multigrid.prolong_add(None, _t(e), (m, n)),
    }
    @jax.jit
    @jax.vmap
    def transfers(S, x, b, y, e):
        Sx = jmg.stencil_matvec(S, x)
        return {"b - S x": jmg.restrict(b - Sx, (mc, nc)), "b - y": jmg.restrict(b - y, (mc, nc)),
                "S x": jmg.restrict(Sx, (mc, nc)), "y": jmg.restrict(y, (mc, nc)),
                "x + P e": x + jmg.prolong(e, (m, n)), "P e": jmg.prolong(e, (m, n))}

    want = transfers(S, x, b, y, e)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(61, 190), (2, 2), (1, 1)])
def test_fused_stages_match_jax(shape):
    """B6's fused stages' plain versions (``smooth_restrict``,
    ``prolong_smooth``), directly and through their wrappers on CPU
    tensors, against JAX's ``jacobi_sweep`` followed by ``restrict(b -
    matvec(x1))``, and ``x + prolong(e)`` followed by ``jacobi_sweep``."""
    B, (m, n), damp = 2, shape, 0.7
    mc, nc = multigrid.coarse_dims(m, n)
    S, binv = _level(9, B, m, n)
    rng = _rng(10)
    x, b = rng.standard_normal((B, 3, m, n)), rng.standard_normal((B, 3, m, n))
    e = rng.standard_normal((B, 3, mc, nc))
    x1, r_c = multigrid.smooth_restrict(_t(S), _t(binv), _t(x), _t(b), damp, (mc, nc))
    up = multigrid.prolong_smooth(_t(S), _t(binv), _t(x), _t(e), _t(b), damp)
    plain = ck.MGT_PLAIN_CALLS
    x1_w, r_w = ck.mg_smooth_restrict(_t(S), _t(binv), _t(x), _t(b), damp, (mc, nc))
    up_w = ck.mg_prolong_smooth(_t(S), _t(binv), _t(x), _t(e), _t(b), damp)
    assert ck.MGT_PLAIN_CALLS == plain + 2
    for got, want in ((x1_w, x1), (r_w, r_c), (up_w, up)):
        assert torch.equal(got, want)
    for k in range(B):
        mv = functools.partial(jmg.stencil_matvec, jnp.asarray(S[k]))
        bj = _jax_binv(binv[k])
        x1_j = jmg.jacobi_sweep(mv, bj, jnp.asarray(x[k]), b[k], damp, sweeps=1)
        r_j = jmg.restrict(b[k] - mv(x1_j), (mc, nc))
        up_j = jmg.jacobi_sweep(mv, bj, x[k] + jmg.prolong(jnp.asarray(e[k]), (m, n)), b[k],
                                damp, sweeps=1)
        for got, want in ((x1[k], x1_j), (r_c[k], r_j), (up[k], up_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(61, 190), (2, 2)])
def test_transfers_of_the_probes_match_jax(shape):
    """B6's standalone restrictions and prolongations at the probes' K = 27
    (S broadcast over K) against JAX's, vmapped over the probes."""
    B, K, (m, n) = 2, 27, shape
    mc, nc = multigrid.coarse_dims(m, n)
    S, _ = _level(11, B, m, n)
    rng = _rng(12)
    x, b, y = (rng.standard_normal((B, K, 3, m, n)) for _ in range(3))
    e = rng.standard_normal((B, K, 3, mc, nc))
    got = {
        "b - S x": multigrid.residual_restrict(_t(S), _t(x), _t(b), None, (mc, nc)),
        "S x": multigrid.residual_restrict(_t(S), _t(x), None, None, (mc, nc)),
        "y": multigrid.residual_restrict(None, None, None, _t(y), (mc, nc)),
        "b - y": multigrid.residual_restrict(None, None, _t(b), _t(y), (mc, nc)),
        "P e": multigrid.prolong_add(None, _t(e), (m, n)),
        "x + P e": multigrid.prolong_add(_t(x), _t(e), (m, n)),
    }

    @jax.jit
    @jax.vmap
    def transfers(S, x, b, y, e):
        def one(x, b, y, e):
            Sx = jmg.stencil_matvec(S, x)
            return {"b - S x": jmg.restrict(b - Sx, (mc, nc)), "S x": jmg.restrict(Sx, (mc, nc)),
                    "y": jmg.restrict(y, (mc, nc)), "b - y": jmg.restrict(b - y, (mc, nc)),
                    "P e": jmg.prolong(e, (m, n)), "x + P e": x + jmg.prolong(e, (m, n))}
        return jax.vmap(one)(x, b, y, e)

    want = transfers(S, x, b, y, e)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(17, 22), (24, 31)])
def test_smooth_level_and_smooth_fine_match_jacobi_sweep(shape):
    B, (m, n), damp = 2, shape, 0.7
    S, binv = _level(4, B, m, n)
    rng = _rng(5)
    x, b = rng.standard_normal((B, 3, m, n)), rng.standard_normal((B, 3, m, n))
    sweep = multigrid.smooth_level(_t(S), _t(binv), _t(x), _t(b), damp).numpy()
    zero = multigrid.smooth_level(None, _t(binv), None, _t(b), damp).numpy()
    y = multigrid.stencil_matvec(_t(S), _t(x))
    fine = multigrid.smooth_fine(_t(binv), _t(x), _t(b), y, damp).numpy()
    np.testing.assert_array_equal(multigrid.smooth_fine(_t(binv), None, _t(b), None, damp), zero)
    for k in range(B):
        mv = functools.partial(jmg.stencil_matvec, jnp.asarray(S[k]))
        bj = _jax_binv(binv[k])
        want = np.asarray(jmg.jacobi_sweep(mv, bj, jnp.asarray(x[k]), b[k], damp, sweeps=1))
        from_zero = jmg.jacobi_sweep(mv, bj, jnp.zeros((3, m, n)), b[k], damp, sweeps=1)
        np.testing.assert_allclose(sweep[k], want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(fine[k], want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(zero[k], np.asarray(from_zero), rtol=1e-12, atol=1e-12)


def _systems(m, n, dtype=np.float64):
    """Normalised frames and per-pair alphas of ALPHAS' pairs
    (test_torch_solve's systems) in ``dtype``, and the port's pair data."""
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=max(m, n) + 2, width=10.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    movie = movie[:, : m + 2, : n + 2].astype(dtype)
    prev, cur = movie[:-1], movie[1:]
    a_s = (np.array([a for a, _ in ALPHAS]) / 1e4).astype(dtype)
    a_r = np.array([a for _, a in ALPHAS]).astype(dtype)
    ours = elop.compute_frame_pair_data(_t(prev), _t(cur), _t(a_s), _t(a_r), "compat")
    return prev, cur, a_s, a_r, ours


def _fused(prev, a_s, a_r):
    I = _t(prev)
    scalars = _t(np.stack([a_s, a_r], axis=-1))
    return lambda u: ck.el_matvec_reduced_fused(I, scalars, u.contiguous(), True)


def _hierarchy(m, n, dtype=np.float64, route="kernels"):
    prev, _, a_s, a_r, ours = _systems(m, n, dtype)
    return multigrid.setup(_fused(prev, a_s, a_r), elop.diag_blocks(ours.coeffs), m, n,
                           ours.coeffs[0].dtype, route=route)


V_CYCLE_SHAPE = (21, 26)


@functools.lru_cache(maxsize=1)
def _jax_v_cycles():
    """JAX's V-cycles of the V_CYCLE_SHAPE systems on one seeded right-hand
    side, at 2 and 4 sweeps (one compile for both), by pair."""
    m, n = V_CYCLE_SHAPE
    prev, cur, a_s, a_r, _ = _systems(m, n)
    r = _rng(6).standard_normal((len(ALPHAS), 3, m, n))

    @jax.jit
    def v_cycles(c, rb):
        mv = functools.partial(jelop.el_matvec_reduced, c)
        h = jmg.setup(mv, jelop.diag_blocks(c), m, n, jnp.float64)
        return {sweeps: jmg.v_cycle(h, rb, sweeps=sweeps) for sweeps in (2, 4)}

    out = [v_cycles(jelop.compute_frame_pair_data(jnp.asarray(prev[b]), jnp.asarray(cur[b]),
                                                  a_s[b], a_r[b], "compat").coeffs,
                    jnp.asarray(r[b])) for b in range(len(ALPHAS))]
    return r, {sweeps: np.stack([np.asarray(o[sweeps]) for o in out]) for sweeps in (2, 4)}


@pytest.mark.parametrize("sweeps", [2, 4])
def test_v_cycle_matches_jax(sweeps):
    m, n = V_CYCLE_SHAPE
    r, z_j = _jax_v_cycles()
    z = multigrid.v_cycle(_hierarchy(m, n), _t(r), sweeps=sweeps).numpy()
    for b in range(len(ALPHAS)):
        np.testing.assert_allclose(z[b], z_j[sweeps][b], rtol=1e-9,
                                   atol=1e-9 * np.abs(z_j[sweeps][b]).max())
    # the 'torch' route is the same plain functions, called directly
    h_t = _hierarchy(m, n, route="torch")
    np.testing.assert_array_equal(multigrid.v_cycle(h_t, _t(r), sweeps=sweeps).numpy(), z)


def test_take_equals_the_full_hierarchy_rows():
    m, n = 21, 26
    h = _hierarchy(m, n, dtype=np.float32)
    prev, _, a_s, a_r, _ = _systems(m, n, np.float32)
    idx = torch.tensor([1])
    sub = multigrid.take(h, idx, _fused(prev[1:], a_s[1:], a_r[1:]))
    assert sub.route == h.route == "kernels"
    for full, part in zip(h.levels, sub.levels):
        assert torch.equal(part.binv, full.binv[1:])
        assert (part.stencil is None) == (full.stencil is None)
        if full.stencil is not None:
            assert torch.equal(part.stencil, full.stencil[1:])
    r = torch.from_numpy(_rng(7).standard_normal((2, 3, m, n)).astype(np.float32))
    assert torch.equal(multigrid.v_cycle(sub, r[1:]), multigrid.v_cycle(h, r)[1:])


def test_plain_versions_count_on_cpu_tensors():
    """On CPU tensors the kernel route runs every stage through the
    wrappers' plain versions: their counters move and the launch counters
    stay."""
    m, n = 21, 26
    launches = ck.MG_LAUNCHES, ck.MGT_LAUNCHES
    plain = ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    h = _hierarchy(m, n)
    setup_plain = ck.MG_PLAIN_CALLS - plain[0], ck.MGT_PLAIN_CALLS - plain[1]
    # a prolongation and a restriction (of S x from level 1 down) per probed
    # level, and the coarsest operator's stencil apply
    assert len(h.levels) == 3 and setup_plain == (1, 4)
    plain = ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    multigrid.v_cycle(h, torch.ones(2, 3, m, n, dtype=torch.float64), sweeps=2)
    probed = len(h.levels) - 2  # levels above the coarsest, level 0 excluded
    # level 0: 4 sweeps, 1 residual-and-restrict, 1 prolong-and-add; a probed
    # level: the zero guess and the last post-sweep, the sweep-residual-
    # restrict and the prolong-add-sweep
    assert (ck.MG_PLAIN_CALLS - plain[0], ck.MGT_PLAIN_CALLS - plain[1]) == (
        4 + 2 * probed, 2 + 2 * probed)
    assert (ck.MG_LAUNCHES, ck.MGT_LAUNCHES) == launches


def _v_cycle_op_by_op(h, b, sweeps, damp=0.7):
    """The V-cycle as the port ran it before its stages: every operation a
    torch op of its own, the stencil apply by multigrid.stencil_matvec."""

    def matvec(level, u):
        return level.matvec(u) if level.stencil is None else multigrid.stencil_matvec(
            level.stencil, u)

    def descend(lvl, b_l):
        if lvl == len(h.levels) - 1:
            return h.coarse_solve(b_l)
        level = h.levels[lvl]

        def smooth(x):
            for _ in range(sweeps):
                if x is None:
                    x = damp * multigrid.apply_blocks(level.binv, b_l)
                else:
                    x = x + damp * multigrid.apply_blocks(level.binv, b_l - matvec(level, x))
            return x

        x = smooth(None)
        r = b_l - matvec(level, x)
        e = descend(lvl + 1, multigrid.restrict(r, h.levels[lvl + 1].shape))
        x = x + multigrid.prolong(e, level.shape)
        return smooth(x)

    return descend(0, b)


@pytest.mark.parametrize("shape", [(21, 26), (24, 31)])
def test_v_cycle_stages_keep_the_op_by_op_order_in_float32(shape):
    m, n = shape
    h = _hierarchy(m, n, dtype=np.float32)
    assert len(h.levels) >= 3
    r = torch.from_numpy(_rng(8).standard_normal((2, 3, m, n)).astype(np.float32))
    z = multigrid.v_cycle(h, r, sweeps=2)
    assert z.dtype == torch.float32
    assert torch.equal(z.view(torch.int32), _v_cycle_op_by_op(h, r, 2).view(torch.int32))


@pytest.mark.parametrize("n_smooth,sweeps", [(1, 2), (1, 1), (2, 3)])
def test_fused_route_equals_the_torch_route_bit_for_bit(n_smooth, sweeps):
    """On CPU tensors the kernel route's V-cycle runs the fused stages'
    plain versions wherever a probed level's Jacobi sweeps allow them (one
    sweep-residual-restrict and one prolong-add-sweep a probed level), and
    equals the 'torch' route, the same stages called directly, bit for bit
    in float32."""
    m, n = 24, 31
    h = _hierarchy(m, n, dtype=np.float32)
    r = torch.from_numpy(_rng(13).standard_normal((2, 3, m, n)).astype(np.float32))
    plain = ck.MG_PLAIN_CALLS, ck.MGT_PLAIN_CALLS
    z = multigrid.v_cycle(h, r, n_smooth=n_smooth, sweeps=sweeps)
    probed = len(h.levels) - 2
    each_side = n_smooth * sweeps
    fused_down = each_side >= 2
    assert (ck.MG_PLAIN_CALLS - plain[0], ck.MGT_PLAIN_CALLS - plain[1]) == (
        2 * each_side + probed * (2 * each_side - 1 - fused_down), 2 + 2 * probed)
    z_t = multigrid.v_cycle(h._replace(route="torch"), r, n_smooth=n_smooth, sweeps=sweeps)
    assert torch.equal(z.view(torch.int32), z_t.view(torch.int32))
    assert torch.equal(z.view(torch.int32),
                       _v_cycle_op_by_op(h, r, n_smooth * sweeps).view(torch.int32))


@pytest.mark.parametrize("order", ["library", "partials"])
def test_exit_band_orders_are_the_same_stencil(order):
    """``utils.exit_band``'s other summation orders compute the stencil of
    ``stencil_matvec`` (float64, rtol 1e-12, K = 1 and 27), and its
    ``variant`` puts the multigrid's functions back after the block."""
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.utils import exit_band

    S, _ = _level(0, 2, 9, 9)
    for K in (1, 27):
        u = _t(_rng(1).standard_normal((2, 3, 9, 9) if K == 1 else (2, K, 3, 9, 9)))
        np.testing.assert_allclose(exit_band.ORDERS[order](_t(S), u).numpy(),
                                   multigrid.stencil_matvec(_t(S), u).numpy(),
                                   rtol=1e-12, atol=1e-12)
    saved = multigrid.stencil_matvec, multigrid.ROUTES["torch"], variational.mg_route
    with exit_band.variant(order, "torch"):
        assert multigrid.stencil_matvec is exit_band.ORDERS[order]
        assert multigrid.ROUTES["torch"].stencil_apply is exit_band.ORDERS[order]
        assert variational.mg_route("auto") == "torch"
    assert multigrid.stencil_matvec is saved[0] and variational.mg_route is saved[2]
    assert multigrid.ROUTES["torch"] is saved[1]
