"""The port's fused EL matvec (ops.cuda_kernels) against the JAX package's
Pallas kernel it replaces.

On the CPU the wrapper runs the kernel's plain version, which these tests
hold against ``pallas_kernels.make_aligned_ops`` in interpret mode, the
way tests/test_pallas.py runs it.  The CUDA kernel itself is compared with
the plain version on the card by tests/test_torch_gpu.py and by
chip_smoke.py.

Tolerance: both sides are float32 with the same term order; they differ
only by rounding (XLA's fusion and multiply-add contraction against
PyTorch's one-op-at-a-time evaluation), a few ulps of the largest term.
Each output field is compared by ``max|a - b| <= 1e-5 * max|b|``.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import pallas_kernels as pk
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck

REL_TOL = 1e-5
ALPHAS = [(800.0, 900.0), (1000.0, 1000.0), (50.0, 3000.0)]  # per pair (alpha_s, alpha_r)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


def _frames(m, n, batch):
    movie, _ = make_translating_blob_movie(
        n_frames=batch, dimension=max(m, n) + 2, width=10.0, sigma=3.0, v_x=0.2, v_y=0.1)
    return (movie[:, : m + 2, : n + 2] * 100.0).astype(np.float32)


def _assert_fields_close(actual, expected):
    for q in range(3):
        a, b = actual[..., q, :, :], expected[..., q, :, :]
        err = np.abs(a - b).max()
        assert err <= REL_TOL * np.abs(b).max(), (q, err, np.abs(b).max())


def _jax_aligned(frame, a_s, a_r, dy_mode, u):
    """JAX v4 kernel (interpret mode) on one pair: u (3, m, n) or (K, 3, m, n)."""
    ops = pk.make_aligned_ops(jnp.asarray(frame), a_s, a_r, dy_mode)

    def one(v):
        return ops.slice_field(ops.matvec(ops.pad_field(v)))

    u = jnp.asarray(u)
    return np.asarray(jax.vmap(one)(u) if u.ndim == 4 else one(u))


@pytest.mark.parametrize("shape", [(30, 40), (62, 62)])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
@pytest.mark.parametrize("K", [1, 27])
def test_plain_version_matches_pallas_kernel(shape, dy_mode, K):
    m, n = shape
    B = len(ALPHAS)
    frames = _frames(m, n, B)
    rng = np.random.default_rng(m * n + K)
    u = rng.standard_normal((B, K, 3, m, n)).astype(np.float32)
    scalars = np.asarray(ALPHAS, np.float32)

    u_t = torch.from_numpy(u if K > 1 else u[:, 0])
    y = ck.el_matvec_reduced_fused_ref(
        torch.from_numpy(frames), torch.from_numpy(scalars), u_t, dy_mode == "compat").numpy()
    if K == 1:
        y = y[:, None]
    for b, (a_s, a_r) in enumerate(ALPHAS):
        y_ref = _jax_aligned(frames[b], np.float32(a_s), np.float32(a_r), dy_mode,
                             u[b] if K > 1 else u[b, 0])
        _assert_fields_close(y[b], y_ref.reshape(y[b].shape))


def test_wrapper_on_cpu_runs_the_plain_version():
    m, n = 20, 17
    frames = torch.from_numpy(_frames(m, n, 2))
    scalars = torch.tensor([[0.1, 1000.0], [0.2, 500.0]])
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, m, n)).astype(np.float32))
    launches, plain = ck.LAUNCHES, ck.PLAIN_CALLS
    y = ck.el_matvec_reduced_fused(frames, scalars, u, True)
    assert ck.LAUNCHES == launches and ck.PLAIN_CALLS == plain + 1
    torch.testing.assert_close(y, ck.el_matvec_reduced_fused_ref(frames, scalars, u, True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["frame_shape", "scalars_shape", "field_axis", "tiny"])
def test_wrapper_rejects_bad_shapes(bad):
    m, n = 10, 12
    I = torch.zeros(2, m + 2, n + 2)
    scalars = torch.zeros(2, 2)
    u = torch.zeros(2, 3, m, n)
    if bad == "frame_shape":
        I = torch.zeros(2, m + 1, n + 2)
    elif bad == "scalars_shape":
        scalars = torch.zeros(2, 3)
    elif bad == "field_axis":
        u = torch.zeros(2, 4, m, n)
    else:
        I, u = torch.zeros(2, 4, 4), torch.zeros(2, 3, 2, 2)
    with pytest.raises(ValueError):
        ck.el_matvec_reduced_fused(I, scalars, u, True)
