"""The port's stencil on pre-extended blocks (kernel B3,
``ops.cuda_kernels.el_matvec_extended``) against the JAX package's Pallas
kernel it replaces, ``pallas_kernels._el_matvec_kernel``.

On the CPU the wrapper runs the kernel's plain version.  Fed the reduced
system's extension of an interior field, ``elop.extend_interior(u)``, and
the whole frame, it is the reduced matvec, which these tests hold against
``pallas_kernels.el_matvec_reduced_pallas`` (the v2 kernel on the padded
layouts) in interpret mode, the way tests/test_pallas.py runs it.  The CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_gpu.py and by chip_smoke.py.

Tolerance: both sides are float32 with the same term order; they differ
only by rounding (XLA's fusion and multiply-add contraction against
PyTorch's one-op-at-a-time evaluation), a few ulps of the largest term.
Each output field is compared by ``max|a - b| <= 1e-5 * max|b|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.ops import pallas_kernels as pk
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.ops import elop

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

    u_ext = elop.extend_interior(torch.from_numpy(u if K > 1 else u[:, 0]))
    y = ck.el_matvec_extended_ref(torch.from_numpy(frames), torch.from_numpy(scalars),
                                  u_ext.contiguous(), dy_mode == "compat").numpy()
    if K == 1:
        y = y[:, None]
    for b, (a_s, a_r) in enumerate(ALPHAS):
        def one(v, b=b, a_s=a_s, a_r=a_r):
            return pk.el_matvec_reduced_pallas(jnp.asarray(frames[b]), np.float32(a_s),
                                               np.float32(a_r), v, dy_mode)

        y_ref = np.asarray(jax.vmap(one)(jnp.asarray(u[b])))  # (K, 3, m, n)
        _assert_fields_close(y[b], y_ref)


def test_wrapper_on_cpu_runs_the_plain_version():
    m, n = 20, 17
    frames = torch.from_numpy(_frames(m, n, 2))
    scalars = torch.tensor([[0.1, 1000.0], [0.2, 500.0]])
    u = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 4, 3, m + 2, n + 2)).astype(np.float32))
    launches, plain = ck.EXT_LAUNCHES, ck.EXT_PLAIN_CALLS
    y = ck.el_matvec_extended(frames, scalars, u, False)
    assert y.shape == (2, 4, 3, m, n)
    assert ck.EXT_LAUNCHES == launches and ck.EXT_PLAIN_CALLS == plain + 1
    torch.testing.assert_close(y, ck.el_matvec_extended_ref(frames, scalars, u, False),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["frame_shape", "scalars_shape", "field_axis", "interior_field",
                                 "empty"])
def test_wrapper_rejects_bad_shapes(bad):
    m, n = 10, 12
    I = torch.zeros(2, m + 2, n + 2)
    scalars = torch.zeros(2, 2)
    u = torch.zeros(2, 3, m + 2, n + 2)
    if bad == "frame_shape":
        I = torch.zeros(2, m + 1, n + 2)
    elif bad == "scalars_shape":
        scalars = torch.zeros(2, 3)
    elif bad == "field_axis":
        u = torch.zeros(2, 4, m + 2, n + 2)
    elif bad == "interior_field":  # an interior (m, n) field where the block is (m+2, n+2)
        u = torch.zeros(2, 3, m, n)
    else:
        I, u = torch.zeros(2, 2, 2), torch.zeros(2, 3, 2, 2)
    with pytest.raises(ValueError):
        ck.el_matvec_extended(I, scalars, u, True)
