"""The hybrid matvec of the port (ops.cuda_kernels.el_matvec_hybrid: the
plain-stencil kernel plus the boundary ring of ops.elop.ring_apply) against
the JAX package's ``pallas_kernels.make_hybrid_ops`` and ``elop`` ring
helpers.

On the CPU the plain-stencil wrapper runs its plain version, which these
tests hold against the Pallas kernel in interpret mode, the way
tests/test_pallas.py runs it.  The CUDA kernel itself is compared with the
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: the ring helpers in float64 run the same formulas in the same
order, so they agree to rounding (1e-12 relative).  The hybrid operator in
float32 is held to the JAX package's own bar for the Pallas operators
(``rtol=1e-6, atol=1e-2``, tests/test_pallas.py:76, on outputs of ~1e5);
the plain stencil, on the same inputs as the Pallas core, to a few ulps of
the largest term (``max|a - b| <= 1e-5 * max|b|`` per field).  A stack of
K probes runs the same elementwise arithmetic as K single calls, so the two
agree exactly.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.ops import pallas_kernels as pk
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop

ALPHAS = [(800.0, 900.0), (50.0, 3000.0)]  # per pair (alpha_s, alpha_r)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


def _inputs(m, n, dtype, K=None, seed=1):
    movie, _ = make_translating_blob_movie(
        n_frames=len(ALPHAS) + 1, dimension=max(m, n) + 2, width=10.0, sigma=3.0, v_x=0.2,
        v_y=0.1)
    frames = (movie[:-1, : m + 2, : n + 2] * 100.0).astype(dtype)
    shape = (len(ALPHAS), 3, m, n) if K is None else (len(ALPHAS), K, 3, m, n)
    u = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    return frames, np.asarray(ALPHAS, dtype), u


def _hybrid(frames, scalars, u, dy_mode="compat"):
    I, sc, u_t = torch.from_numpy(frames), torch.from_numpy(scalars), torch.from_numpy(u)
    coeffs = elop.compute_coefficients(I, sc[:, 0], sc[:, 1], dy_mode)
    ring = elop.ring_coeffs(coeffs if u.ndim == 4 else elop.with_probe_axis(coeffs))
    return ck.el_matvec_hybrid(I, sc, u_t, dy_mode == "compat", ring).numpy()


@pytest.mark.parametrize("shape", [(3, 3), (30, 40), (62, 62)])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_ring_apply_matches_jax(shape, dy_mode):
    m, n = shape
    frames, scalars, u = _inputs(m, n, np.float64)
    coeffs = elop.compute_coefficients(torch.from_numpy(frames), torch.from_numpy(scalars[:, 0]),
                                       torch.from_numpy(scalars[:, 1]), dy_mode)
    strips = elop.ring_apply(elop.ring_coeffs(coeffs), torch.from_numpy(u))
    for b, (a_s, a_r) in enumerate(ALPHAS):
        pair = jelop.compute_frame_pair_data(jnp.asarray(frames[b]), jnp.asarray(frames[b]),
                                             a_s, a_r, dy_mode)
        strips_j = jelop.ring_apply(jelop.ring_coeffs(pair.coeffs), jnp.asarray(u[b]))
        for ours, theirs in zip(strips, strips_j):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(ours[b].numpy(), theirs, rtol=1e-12,
                                       atol=1e-12 * np.abs(theirs).max())


def test_ring_apply_broadcasts_over_probes():
    m, n, K = 9, 7, 4
    frames, scalars, u = _inputs(m, n, np.float64, K=K)
    coeffs = elop.compute_coefficients(torch.from_numpy(frames), torch.from_numpy(scalars[:, 0]),
                                       torch.from_numpy(scalars[:, 1]), "compat")
    stacked = elop.ring_apply(elop.ring_coeffs(elop.with_probe_axis(coeffs)), torch.from_numpy(u))
    for k in range(K):
        single = elop.ring_apply(elop.ring_coeffs(coeffs), torch.from_numpy(u[:, k]))
        for a, b in zip(stacked, single):
            torch.testing.assert_close(a[:, k], b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(30, 40), (128, 254)])
def test_hybrid_matvec_matches_jax_make_hybrid_ops(shape):
    m, n = shape
    frames, scalars, u = _inputs(m, n, np.float32)
    plain = ck.CORE_PLAIN_CALLS
    y = _hybrid(frames, scalars, u)
    assert ck.CORE_PLAIN_CALLS == plain + 1  # the CPU wrapper ran the plain version
    for b, (a_s, a_r) in enumerate(ALPHAS):
        ops = pk.make_hybrid_ops(jnp.asarray(frames[b]), np.float32(a_s), np.float32(a_r),
                                 "compat")
        y_j = np.asarray(ops.slice_field(ops.matvec(ops.pad_field(jnp.asarray(u[b])))))
        np.testing.assert_allclose(y[b], y_j, rtol=1e-6, atol=1e-2)


def test_hybrid_matvec_of_a_probe_stack_equals_single_calls():
    m, n, K = 30, 40, 27
    frames, scalars, u = _inputs(m, n, np.float32, K=K)
    y = _hybrid(frames, scalars, u, "fixed")
    assert y.shape == u.shape
    for k in range(K):
        np.testing.assert_array_equal(y[:, k], _hybrid(frames, scalars, u[:, k], "fixed"))


@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_plain_stencil_is_the_zero_extended_stencil(dy_mode):
    """B2's plain version equals the JAX stencil of the zero-padded field
    on every pixel, and the Pallas plain core (interpret mode) away from the
    ring, where the TPU kernel's output is defined."""
    m, n = 30, 40
    frames, scalars, u = _inputs(m, n, np.float32)
    y = ck.el_matvec_plain_core_ref(torch.from_numpy(frames), torch.from_numpy(scalars),
                                    torch.from_numpy(u), dy_mode == "compat").numpy()
    compat = 1 if dy_mode == "compat" else 0
    NW = pk._round_up(n, pk._LANE)
    mp = pk._round_up(m, pk._pick_bm(NW))
    NI = pk._round_up(n + 2, pk._LANE)
    for b, (a_s, a_r) in enumerate(ALPHAS):
        coeffs = jelop.compute_frame_pair_data(jnp.asarray(frames[b]), jnp.asarray(frames[b]),
                                               a_s, a_r, dy_mode).coeffs
        y_zero = np.asarray(jelop.interior_apply(coeffs, jnp.pad(jnp.asarray(u[b]),
                                                                 ((0, 0), (1, 1), (1, 1)))))
        i_cont = jnp.pad(jnp.asarray(frames[b]), ((0, mp + 8 - (m + 2)), (0, NI - (n + 2))))
        u_cont = jnp.pad(jnp.asarray(u[b]), ((0, 0), (0, mp - m), (0, NW - n)))
        core = pk._plain_matvec(i_cont, jnp.asarray([a_s, a_r], jnp.float32),
                                jnp.asarray([m, n, compat], jnp.int32), u_cont)
        core = np.asarray(core)[:, 1 : m - 1, 1 : n - 1]
        for q in range(3):
            assert np.abs(y[b, q] - y_zero[q]).max() <= 1e-5 * np.abs(y_zero[q]).max()
            inner = y[b, q, 1:-1, 1:-1]
            assert np.abs(inner - core[q]).max() <= 1e-5 * np.abs(core[q]).max()
