"""The port's preprocessing (area resize, adaptive threshold, CLAHE) and
flow statistics against the JAX package's, on the CPU.

The movie is the JAX package's own preprocessing fixture
(tests/test_preprocessing.py): 3 frames of 64x80, noise plus smooth
structure.

Tolerances:
* area resize: float64 to rtol 1e-12 (the same weights, two matrix
  products); float32 to 1e-6 of the largest value;
* adaptive threshold: equal.  A pixel can flip only where its local mean
  (an average of integers) lies within rounding of a half-integer, since
  the rounded mean decides the threshold; any mismatch is reported with its
  mean's distance from the nearest half-integer and must be within 1e-9
  (float64) or 1e-4 (float32) of it;
* CLAHE: 0.05 (of 65535) per pixel: the same bins and tiles; the CDF
  sums and the interpolation run in another order and, in the JAX package
  under x64, with float64 weights;
* statistics: host numpy on the same flow result, equal to rtol 1e-12;
  the illumination correction float64 to rtol 1e-12.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import numpy as np
import pytest
import torch

from opticalflow_tpu.analysis import statistics as jstats
from opticalflow_tpu.ops import clahe as jclahe
from opticalflow_tpu.ops import resize as jresize
from opticalflow_tpu.ops import threshold as jthreshold
from opticalflow_tpu_torch import conduct_optical_flow
from opticalflow_tpu_torch.analysis import statistics
from opticalflow_tpu_torch.ops import clahe, resize, threshold


@pytest.fixture(scope="module")
def movie():
    rng = np.random.default_rng(11)
    base = rng.random((3, 64, 80)) * 200.0
    x = np.linspace(0, 3 * np.pi, 64)[:, None]
    y = np.linspace(0, 2 * np.pi, 80)[None, :]
    return base + 300.0 * np.abs(np.sin(x) * np.cos(y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_area_resize_matches_jax(movie, dtype):
    m = movie.astype(dtype)
    cases = [(lambda mod, **kw: mod.area_resize_movie(m, 32, 40, **kw)),
             (lambda mod, **kw: mod.area_resize_movie(m, 23, 31, **kw)),
             (lambda mod, **kw: mod.downsample_movie(m, 0.4, **kw))]
    for case in cases:
        ours = case(resize, device="cpu").numpy()
        theirs = np.asarray(case(jresize))
        assert ours.shape == theirs.shape and ours.dtype == dtype
        if dtype == np.float64:
            np.testing.assert_allclose(ours, theirs, rtol=1e-12)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * np.abs(theirs).max())
    with pytest.raises(ValueError, match="downsampling"):
        resize.area_resize_movie(m, 65, 80, device="cpu")


def _mean_distance_from_half(m, window):
    """|local mean - nearest half-integer| of the uint8 image, float64."""
    scaled = np.floor(m / m.max() * 255.0)
    mean = threshold._local_mean_replicate(torch.from_numpy(scaled), window).numpy()
    return np.abs(mean - np.floor(mean) - 0.5)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-4)])
@pytest.mark.parametrize("window,c", [(15, 2.0), (51, 0.0), (5, -3.0)])
def test_adaptive_threshold_matches_jax(movie, dtype, tol, window, c):
    m = movie.astype(dtype)
    ours = threshold.apply_adaptive_threshold(m, window_size=window, threshold=c,
                                              device="cpu").numpy()
    theirs = np.asarray(jthreshold.apply_adaptive_threshold(m, window_size=window, threshold=c))
    assert ours.dtype == bool and ours.shape == m.shape
    flips = ours != theirs
    if flips.any():
        distance = _mean_distance_from_half(m.astype(np.float64), window)[flips]
        print(f"{int(flips.sum())} threshold mismatches, local mean within "
              f"{distance.max():.3e} of a half-integer")
        assert distance.max() <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kw", [dict(clipLimit=4.0, tile_number=4),
                                dict(clipLimit=40.0, tile_number=3, n_bins=256),
                                dict()])
def test_clahe_matches_jax(movie, dtype, kw):
    m = (movie * 50.0).astype(dtype)
    ours = clahe.apply_clahe(m, device="cpu", **kw).numpy()
    theirs = np.asarray(jclahe.apply_clahe(m, **kw))
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=0.05)


def test_statistics_match_jax(movie):
    m = movie[:, :40, :40]
    res = conduct_optical_flow(m, boxsize=9, delta_x=0.5, dtype=torch.float64, device="cpu")
    other = conduct_optical_flow(m[::-1].copy(), boxsize=7, delta_x=0.5, dtype=torch.float64,
                                 device="cpu")
    pairs = [
        (statistics.velocity_angles(res), jstats.velocity_angles(res)),
        (statistics.angles_between(res, other), jstats.angles_between(res, other)),
        (statistics.speed_pairs(res, other, threshold=0.05),
         jstats.speed_pairs(res, other, threshold=0.05)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours, theirs, rtol=1e-12)
    mask = np.isfinite(res["v_x"])
    for fn, args in ((statistics.ground_truth_error_statistics, (res, 0.2, 0.1)),
                     (statistics.ground_truth_error_statistics, (res, 0.2, 0.1, mask)),
                     (statistics.endpoint_error, (res, other))):
        ours, theirs = fn(*args), getattr(jstats, fn.__name__)(*args)
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12, err_msg=key)


def test_intensity_correction_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.random((40, 40)) * 50.0
    movie = np.stack([base, base + 20.0, base * 1.1 + 5.0])
    ours = statistics.correct_intensity_change(movie, smoothing_sigma=2.0, correction_sigma=5.0,
                                               device="cpu")
    theirs = jstats.correct_intensity_change(movie, smoothing_sigma=2.0, correction_sigma=5.0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)
    drift = np.mean(ours[1]) - np.mean(ours[0])
    assert abs(drift) < 0.1 * 20.0
