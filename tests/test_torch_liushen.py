"""The port's Liu-Shen path (``opticalflow_tpu_torch.flow.liushen``) against
the JAX package's and the loop oracle of tests/test_liushen.py, on the CPU.

Tolerances: float64 sweeps of the same arithmetic, to rtol 1e-10, atol
1e-12 (the JAX package's own bound against the oracle); float32 against
JAX's float32 to 1e-4 of the largest velocity (3 sweeps of a 2x2 solve
whose matrix is dominated by the alpha term); the reference's regression
constant to 5%, as the JAX package holds it.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.flow import liushen as jliushen
from opticalflow_tpu_torch.core.synth import make_fake_data_frame
from opticalflow_tpu_torch.flow import liushen
from test_liushen import liu_shen_oracle


def _movie(shape, seed):
    return np.random.default_rng(seed).random(shape) * 50.0


def test_liu_shen_matches_jax_and_the_loop_oracle():
    movie = _movie((3, 8, 9), 5)
    init_vx, init_vy = np.full((8, 9), 0.01), np.full((8, 9), -0.02)
    v_x, v_y = liushen.liu_shen_movie(torch.from_numpy(movie), init_vx, init_vy, alpha=5.0,
                                      iterations=3)
    j_vx, j_vy = jliushen.liu_shen_movie(jnp.asarray(movie), jnp.asarray(init_vx),
                                         jnp.asarray(init_vy), alpha=5.0, iterations=3)
    o_vx, o_vy = liu_shen_oracle(movie, 5.0, init_vx, init_vy, 3)
    for got, want in ((v_x, j_vx), (v_y, j_vy), (v_x, o_vx), (v_y, o_vy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_liu_shen_float32_matches_jax():
    movie = _movie((3, 12, 10), 8).astype(np.float32)
    init = np.zeros((12, 10), np.float32)
    v_x, v_y = liushen.liu_shen_movie(torch.from_numpy(movie), init, init, alpha=5.0,
                                      iterations=3)
    assert v_x.dtype == torch.float32
    j_vx, j_vy = jliushen.liu_shen_movie(jnp.asarray(movie), jnp.asarray(init),
                                         jnp.asarray(init), alpha=5.0, iterations=3)
    scale = float(np.abs(np.asarray(j_vx)).max())
    np.testing.assert_allclose(v_x.numpy(), np.asarray(j_vx), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(v_y.numpy(), np.asarray(j_vy), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("return_iterations", [False, True])
def test_deprecated_flow_matches_jax(return_iterations):
    movie = _movie((3, 10, 11), 6)
    kw = dict(delta_x=0.5, delta_t=2.0, speed_alpha=2.0, max_iterations=6, iteration_stepsize=2,
              return_iterations=return_iterations, use_liu_shen=True, v_x_guess=0.01,
              v_y_guess=-0.02, remodelling_guess=0.3, smoothing_sigma=1.0)
    ours = liushen.conduct_variational_optical_flow_deprecated(movie, dtype=torch.float64,
                                                               device="cpu", **kw)
    theirs = jliushen.conduct_variational_optical_flow_deprecated(movie, dtype=jnp.float64, **kw)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        want = theirs[key]
        if isinstance(want, (int, float)):
            assert ours[key] == want, key
        else:
            np.testing.assert_allclose(ours[key], np.asarray(want), rtol=1e-10, atol=1e-12,
                                       err_msg=key)
    if return_iterations:
        assert ours["v_x_steps"].shape == (2, 4, 10, 11)
        plain = liushen.conduct_variational_optical_flow_deprecated(
            movie, dtype=torch.float64, device="cpu", **dict(kw, return_iterations=False))
        np.testing.assert_allclose(ours["v_x"], plain["v_x"], rtol=1e-12)
    with pytest.raises(ValueError, match="Liu-Shen"):
        liushen.conduct_variational_optical_flow_deprecated(movie, device="cpu")


def test_reference_golden_regression_value():
    """The reference's one regression constant: the mean speed after 1000
    sweeps on the 50x50 synthetic pair, float64."""
    first, _ = make_fake_data_frame(2.5, 2.5, sigma=3, width=5, dimension=50)
    second, _ = make_fake_data_frame(2.51, 2.51, sigma=3, width=5, dimension=50)
    movie = np.stack([first / first.max() * 255, second / second.max() * 255])
    result = liushen.conduct_variational_optical_flow_deprecated(
        movie, speed_alpha=1.0, v_x_guess=0.003, v_y_guess=0.003, remodelling_guess=0.05,
        max_iterations=1000, include_remodelling=False, use_liu_shen=True,
        dtype=torch.float64, device="cpu")
    mean_speed = float(np.mean(result["speed"]))
    assert abs(mean_speed - 0.08600834591294404) / 0.08600834591294404 < 0.05
