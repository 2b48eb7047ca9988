"""The port's EL operator (ops.elop, float32 and float64) and direct solver
(solve.direct) against the JAX package, on a batch of pairs with per-pair
alphas; each JAX reference runs one pair at a time.

Tolerances: the same formulas in the same order, so float64 agrees to
rounding (rtol 1e-12) and float32 to a few ulps of the largest term
(``max|a - b| <= 1e-5 * max|b|`` per plane).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import elop as jelop
from opticalflow_tpu.solve import direct as jdirect
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.solve import direct

ALPHAS = [(800.0, 900.0), (1000.0, 1000.0), (50.0, 3000.0)]


def _close(a, b, dtype):
    a, b = np.asarray(a), np.asarray(b)
    if dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
    else:
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def _batch(m, n, dtype):
    movie, _ = make_translating_blob_movie(n_frames=4, dimension=max(m, n) + 2, width=10.0,
                                           sigma=3.0, v_x=0.2, v_y=0.1)
    movie = (movie[:, : m + 2, : n + 2] * 100.0).astype(dtype)
    prev, cur = movie[:-1], movie[1:]
    u = np.random.default_rng(2).standard_normal((3, 3, m, n)).astype(dtype)
    return prev, cur, u


def _port_pairs(prev, cur, dy_mode):
    a_s = torch.tensor([a for a, _ in ALPHAS], dtype=torch.from_numpy(prev).dtype)
    a_r = torch.tensor([a for _, a in ALPHAS], dtype=a_s.dtype)
    return elop.compute_frame_pair_data(torch.from_numpy(prev), torch.from_numpy(cur),
                                        a_s, a_r, dy_mode)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_pair_data_and_operators_match_jax(dtype, dy_mode):
    m, n = 21, 26
    prev, cur, u = _batch(m, n, dtype)
    ours = _port_pairs(prev, cur, dy_mode)
    u_t = torch.from_numpy(u)
    y = elop.el_matvec_reduced(ours.coeffs, u_t)
    bj = elop.block_jacobi_inverse_apply_interior(ours.coeffs, u_t)
    blocks = elop.diag_blocks(ours.coeffs)
    for b, (a_s, a_r) in enumerate(ALPHAS):
        theirs = jelop.compute_frame_pair_data(jnp.asarray(prev[b]), jnp.asarray(cur[b]),
                                               jnp.asarray(a_s, dtype), jnp.asarray(a_r, dtype),
                                               dy_mode)
        for name in elop.ELCoefficients._fields[:13]:
            _close(getattr(ours.coeffs, name)[b], getattr(theirs.coeffs, name), dtype)
        for name in ("rhs", "dIdt", "I_interior"):
            _close(getattr(ours, name)[b], getattr(theirs, name), dtype)
        uj = jnp.asarray(u[b])
        _close(y[b], jelop.el_matvec_reduced(theirs.coeffs, uj), dtype)
        _close(bj[b], jelop.block_jacobi_inverse_apply_interior(theirs.coeffs, uj), dtype)
        _close(blocks[b], jelop.diag_blocks(theirs.coeffs), dtype)


def test_extension_and_embedding_match_jax():
    u = np.random.default_rng(4).standard_normal((2, 3, 7, 9))
    ext = elop.extend_interior(torch.from_numpy(u)).numpy()
    emb = elop.embed_interior(torch.from_numpy(u)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(ext[b], np.asarray(jelop.extend_interior(jnp.asarray(u[b]))))
        np.testing.assert_array_equal(emb[b], np.asarray(jelop.embed_interior(jnp.asarray(u[b]))))
    # corners: doubled in the reduced system's extension, single in the embedding
    assert ext[0, 0, 0, 0] == 2 * u[0, 0, 1, 1] and emb[0, 0, 0, 0] == u[0, 0, 1, 1]


def test_direct_assembly_and_solve_match_jax():
    m, n = 12, 15
    prev, cur, _ = _batch(m, n, np.float64)
    ours = _port_pairs(prev, cur, "fixed")
    theirs = jelop.compute_frame_pair_data(jnp.asarray(prev[0]), jnp.asarray(cur[0]),
                                           800.0, 900.0, "fixed")
    coeffs0 = elop.ELCoefficients(*[f[0] for f in ours.coeffs])
    a = direct.assemble_el_matrix(coeffs0, m + 2, n + 2)
    b = jdirect.assemble_el_matrix(theirs.coeffs, m + 2, n + 2)
    assert abs(a - b).max() <= 1e-12 * abs(b).max()
    u_ours, ok = direct.direct_solve(coeffs0, ours.rhs[0].numpy())
    u_theirs, _ = jdirect.direct_solve(theirs.coeffs, np.asarray(theirs.rhs))
    assert ok
    np.testing.assert_allclose(u_ours, u_theirs, rtol=1e-9, atol=1e-12)
    # and the reduced operator reproduces the assembled system on the interior
    x = torch.from_numpy(np.ascontiguousarray(u_ours[:, 1:-1, 1:-1]))[None]
    r = elop.el_matvec_reduced(elop.ELCoefficients(*[f[:1] for f in ours.coeffs]), x)
    np.testing.assert_allclose(r[0].numpy(), ours.rhs[0, :, 1:-1, 1:-1].numpy(),
                               rtol=0, atol=1e-9 * np.abs(ours.rhs.numpy()).max())
