"""The port's double-float arithmetic (ops.df32), df32 system data and
residual (ops.elop), and blur (ops.blur) against the JAX package and scipy.

Tolerances: the error-free transforms are exact, so on the same float32
inputs both packages must give bit-identical pairs.  The df32 system data
and residual are built from those transforms in the same order, so they
too are compared bit for bit; the residual's hi + lo sum is additionally
held against a float64 evaluation to ~eps_f32^2 relative (1e-10 of the
largest term).  The blur is float64, compared to rounding (rtol 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from opticalflow_tpu.ops import blur as jblur
from opticalflow_tpu.ops import df32 as jdf
from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import blur, df32, elop


def _same(ours, theirs):
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_error_free_transforms_match_jax():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    s = np.float32(3.7)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _same(df32.two_sum(ta, tb), jdf.two_sum(ja, jb))
    _same(df32.two_prod(ta, tb), jdf.two_prod(ja, jb))
    _same(df32.split(ta), jdf.split(ja))
    x, y = df32.two_prod(ta, tb), df32.two_sum(tb, ta)
    jx, jy = jdf.two_prod(ja, jb), jdf.two_sum(jb, ja)
    _same(df32.df_add(x, y), jdf.df_add(jx, jy))
    _same(df32.df_mul(x, y), jdf.df_mul(jx, jy))
    _same(df32.df_div(x, torch.tensor(s)), jdf.df_div(jx, jnp.asarray(s)))
    _same(df32.df_div_f(ta, torch.tensor(s)), jdf.df_div_f(ja, jnp.asarray(s)))
    _same(df32.df_mul_f(x, tb), jdf.df_mul_f(jx, jb))
    _same(df32.df_add_pf(x, tb), jdf.df_add_pf(jx, jb))
    # a*b is captured exactly: hi + lo equals the float64 product
    p, e = df32.two_prod(ta, tb)
    np.testing.assert_array_equal(p.double() + e.double(), ta.double() * tb.double())


@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_df32_system_data_and_residual_match_jax(dy_mode):
    m, n = 18, 23
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=25, width=10.0, sigma=3.0,
                                           v_x=0.2, v_y=0.1)
    movie = (movie[:, : m + 2, : n + 2] * 100.0).astype(np.float32)
    prev, cur = movie[:-1], movie[1:]
    scale = prev.reshape(2, -1).max(axis=1)
    alphas = [(1000.0, 1000.0), (300.0, 2000.0)]
    rng = np.random.default_rng(1)
    x_hi = rng.standard_normal((2, 3, m, n)).astype(np.float32)
    x_lo = (x_hi * 1e-8 * rng.standard_normal(x_hi.shape)).astype(np.float32)

    ours = elop.compute_frame_pair_data_df(
        torch.from_numpy(prev), torch.from_numpy(cur),
        torch.tensor([a for a, _ in alphas]), torch.tensor([a for _, a in alphas]),
        dy_mode, torch.from_numpy(scale))
    r = elop.el_residual_df(ours, torch.from_numpy(x_hi), torch.from_numpy(x_lo)).numpy()
    mv = elop.el_matvec_df(ours, torch.from_numpy(x_hi)).numpy()
    for b, (a_s, a_r) in enumerate(alphas):
        theirs = jelop.compute_frame_pair_data_df(
            jnp.asarray(prev[b]), jnp.asarray(cur[b]), np.float32(a_s), np.float32(a_r),
            dy_mode, jnp.asarray(scale[b]))
        for name in jelop.ELPairDataDF._fields[:16]:
            # the port's per-pair scalars are (B, 1, 1) pairs, JAX's 0-d
            want = getattr(theirs, name)
            _same([np.asarray(p[b]).reshape(np.shape(w)) for p, w in zip(getattr(ours, name), want)],
                  want)
        _same((ours.rhs_hi[b], ours.rhs_lo[b]), (theirs.rhs_hi, theirs.rhs_lo))
        r_j = jelop.el_residual_df(theirs, jnp.asarray(x_hi[b]), jnp.asarray(x_lo[b]))
        np.testing.assert_array_equal(r[b], np.asarray(r_j))
        np.testing.assert_array_equal(mv[b], np.asarray(jelop.el_matvec_df(theirs, jnp.asarray(x_hi[b]))))

    # float64 reference: the normalised system built in f64, applied to x_hi + x_lo
    p64 = elop.compute_frame_pair_data(
        torch.from_numpy(prev.astype(np.float64) / scale[:, None, None]),
        torch.from_numpy(cur.astype(np.float64) / scale[:, None, None]),
        torch.tensor([a / s**2 for (a, _), s in zip(alphas, scale.astype(np.float64))]),
        torch.tensor([a for _, a in alphas], dtype=torch.float64), dy_mode)
    x64 = torch.from_numpy(x_hi.astype(np.float64) + x_lo.astype(np.float64))
    r64 = (p64.rhs[:, :, 1:-1, 1:-1] - elop.el_matvec_reduced(p64.coeffs, x64)).numpy()
    terms = np.abs(elop.el_matvec_reduced(p64.coeffs, x64.abs()).numpy()).max()
    assert np.abs(r - r64).max() <= 1e-10 * terms + 1e-7 * np.abs(r64).max()


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_blur_matches_jax_and_scipy(sigma):
    movie = np.random.default_rng(3).random((3, 20, 27)) * 100.0
    ours = blur.blur_movie(torch.from_numpy(movie), sigma).numpy()
    np.testing.assert_allclose(ours, np.asarray(jblur.blur_movie(jnp.asarray(movie), sigma)),
                               rtol=1e-12, atol=1e-12)
    for t in range(3):
        ref = scipy.ndimage.gaussian_filter(movie[t], sigma, mode="nearest", truncate=4.0)
        np.testing.assert_allclose(ours[t], ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(blur.gaussian_kernel_1d(sigma), jblur.gaussian_kernel_1d(sigma))
