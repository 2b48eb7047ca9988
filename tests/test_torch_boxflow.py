"""The port's box sums, box-method flow and box-size / blur-size sweeps
against the JAX package's (and the loop oracle of tests/oracles.py), on
the CPU.

Tolerances:
* box sums: float64 to 1e-12 of the largest |x| times the window size
  (the same windowed sums in another order); float32 to 1e-5 of it;
* box flow, float64: port vs JAX and port vs the loop oracle to rtol 1e-9,
  atol 1e-11 (the JAX package's own bound against the oracle), NaN
  positions equal;
* the sweeps: float64 to rtol 1e-9; float32 to rtol 1e-5 (means) and 2e-3
  (standard deviations and local speeds, whose 2x2 solves cancel), the
  JAX package's own bound for its sweep against the serial flow.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.analysis import hyperparams as jhyper
from opticalflow_tpu.flow import boxflow as jboxflow
from opticalflow_tpu.ops import boxsum as jboxsum
from opticalflow_tpu_torch import conduct_optical_flow
from opticalflow_tpu_torch.analysis import hyperparams
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import boxsum
from tests.oracles import box_flow_oracle

TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(scope="module")
def blob_movie():
    """tests/test_boxflow.py's movie: 3 frames of 48x48."""
    return make_translating_blob_movie(n_frames=3, dimension=48, width=10.0, sigma=2.0,
                                       v_x=0.15, v_y=0.1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("box", [3, 7, 8, 15])
def test_box_sums_match_jax(dtype, box):
    x = np.random.default_rng(0).standard_normal((5, 33, 47)).astype(dtype)
    tol = (1e-12 if dtype == np.float64 else 1e-5) * (box + 1) ** 2
    got = boxsum.box_sum(torch.from_numpy(x), box).numpy()
    np.testing.assert_allclose(got, np.asarray(jboxsum.box_sum(jnp.asarray(x), box)), atol=tol)
    got = boxsum.box_sum_dynamic(torch.from_numpy(x), box // 2, 9).numpy()
    want = np.asarray(jboxsum.box_sum_dynamic(jnp.asarray(x), box // 2, 9))
    np.testing.assert_allclose(got, want, atol=tol)
    assert boxsum.effective_window(box) == jboxsum.effective_window(box)


def test_box_sum_dynamic_batches_over_half_widths():
    x = np.random.default_rng(1).standard_normal((2, 20, 17))
    halves = torch.tensor([0, 2, 5, 9])
    got = boxsum.box_sum_dynamic(torch.from_numpy(x), halves[:, None], 9).numpy()
    assert got.shape == (4, 2, 20, 17)
    for k, half in enumerate(halves.tolist()):
        want = np.asarray(jboxsum.box_sum(jnp.asarray(x), 2 * half + 1))
        np.testing.assert_allclose(got[k], want, atol=1e-12 * (2 * half + 2) ** 2)


def _assert_flow_close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("boxsize", [7, 8])
@pytest.mark.parametrize("include_remodelling", [False, True])
def test_box_flow_matches_jax_and_the_loop_oracle(blob_movie, boxsize, include_remodelling):
    movie, delta_x = blob_movie
    kw = dict(boxsize=boxsize, delta_x=delta_x, delta_t=1.0,
              include_remodelling=include_remodelling)
    ours = conduct_optical_flow(movie, dtype=torch.float64, device="cpu", **kw)
    theirs = jboxflow.conduct_optical_flow(movie, dtype=np.float64, **kw)
    oracle = box_flow_oracle(movie, boxsize, delta_x=delta_x, delta_t=1.0,
                             include_remodelling=include_remodelling)
    assert sorted(ours) == sorted(theirs)
    keys = ("v_x", "v_y", "speed") + (("net_remodelling",) if include_remodelling else ())
    for key, want in zip(keys, oracle):
        _assert_flow_close(ours[key], np.asarray(theirs[key]))
        _assert_flow_close(ours[key], want)


def test_box_flow_float32_matches_jax(blob_movie):
    """float32 on the same frames: the 2x2 solve divides differences of
    box sums, so the bound is relative to the speed scale: 1e-3 of the
    largest speed (measured ~1e-5)."""
    movie, delta_x = blob_movie
    ours = conduct_optical_flow(movie * 100.0, boxsize=9, delta_x=delta_x, device="cpu")
    theirs = jboxflow.conduct_optical_flow(movie * 100.0, boxsize=9, delta_x=delta_x)
    assert ours["v_x"].dtype == np.float32
    scale = np.nanmax(np.abs(theirs["speed"]))
    for key in ("v_x", "v_y", "speed"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-3 * scale)


def test_background_subtraction_and_smoothing_match_jax(blob_movie):
    movie, delta_x = blob_movie
    kw = dict(boxsize=7, delta_x=delta_x, smoothing_sigma=1.5, background=0.01)
    ours = conduct_optical_flow(movie, dtype=torch.float64, device="cpu", **kw)
    theirs = jboxflow.conduct_optical_flow(movie, dtype=np.float64, **kw)
    np.testing.assert_allclose(ours["blurred_data"], theirs["blurred_data"], rtol=1e-12,
                               atol=1e-14)
    for key in ("v_x", "v_y", "speed"):
        _assert_flow_close(ours[key], np.asarray(theirs[key]))


def _sweep_movie():
    """tests/test_hyperparams.py's movie: 6 frames of 48x48, x100."""
    movie, _ = make_translating_blob_movie(n_frames=6, dimension=48, width=10.0, sigma=2.0,
                                           v_x=0.2, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def _assert_sweep_close(ours, theirs, dtype):
    rtol = {"mean_speeds": 1e-9, "speed_stds": 1e-9, "local_speeds": 1e-9}
    if dtype == np.float32:
        rtol = {"mean_speeds": 1e-5, "speed_stds": 2e-3, "local_speeds": 2e-3}
    assert sorted(ours) == sorted(theirs)
    for key, tol in rtol.items():
        assert ours[key].shape == np.shape(theirs[key]), key
        np.testing.assert_allclose(ours[key], theirs[key], rtol=tol, err_msg=key)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_boxsize_sweep_matches_jax(dtype):
    kw = dict(boxsizes=np.array([5, 8, 9, 15]), frame_index=2, delta_x=0.1, delta_t=0.5,
              smoothing_sigma=1.3)
    ours = hyperparams.vary_boxsize(_sweep_movie(), dtype=TORCH[dtype], device="cpu", **kw)
    theirs = jhyper.vary_boxsize(_sweep_movie(), dtype=dtype, **kw)
    _assert_sweep_close(ours, theirs, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blursize_sweep_matches_jax(dtype):
    kw = dict(blur_sizes=np.array([0.8, 1.3, 2.5]), boxsize=9, frame_index=2, delta_x=0.1,
              delta_t=0.5)
    ours = hyperparams.vary_blursize(_sweep_movie(), dtype=TORCH[dtype], device="cpu", **kw)
    theirs = jhyper.vary_blursize(_sweep_movie(), dtype=dtype, **kw)
    _assert_sweep_close(ours, theirs, dtype)


def test_sweeps_match_the_serial_box_flow():
    """Each sweep value is the box-method flow at that size or sigma
    (float64, rtol 1e-9): the batched sweeps are the serial runs."""
    movie = _sweep_movie()
    box = hyperparams.vary_boxsize(movie, boxsizes=np.array([5, 9]), frame_index=2,
                                   delta_x=0.1, delta_t=0.5, dtype=torch.float64, device="cpu")
    blur = hyperparams.vary_blursize(movie, blur_sizes=np.array([0.8, 2.5]), boxsize=9,
                                     frame_index=2, delta_x=0.1, delta_t=0.5,
                                     dtype=torch.float64, device="cpu")
    for k, size in enumerate((5, 9)):
        ref = conduct_optical_flow(movie[2:4], boxsize=size, delta_x=0.1, delta_t=0.5,
                                   smoothing_sigma=1.3, dtype=torch.float64, device="cpu")
        np.testing.assert_allclose(box["mean_speeds"][k], np.mean(ref["speed"]), rtol=1e-9)
        np.testing.assert_allclose(box["speed_stds"][k], np.std(ref["speed"]), rtol=1e-9)
    for k, sigma in enumerate((0.8, 2.5)):
        ref = conduct_optical_flow(movie[2:4], boxsize=9, delta_x=0.1, delta_t=0.5,
                                   smoothing_sigma=sigma, dtype=torch.float64, device="cpu")
        np.testing.assert_allclose(blur["mean_speeds"][k], np.mean(ref["speed"]), rtol=1e-9)


def test_traced_gaussian_matches_jax_and_blur_movie():
    from opticalflow_tpu_torch.ops.blur import blur_movie

    movie = torch.from_numpy(_sweep_movie()[:2].astype(np.float64))
    sigmas = torch.tensor([0.7, 1.9, 3.2], dtype=torch.float64)
    max_radius = int(4.0 * 3.2 + 0.5)
    got = hyperparams._gaussian_blur_traced(movie, sigmas, max_radius)
    assert got.shape == (3, 2, 48, 48)
    for k, sigma in enumerate(sigmas.tolist()):
        want = jhyper._gaussian_blur_traced(jnp.asarray(movie.numpy()), sigma, max_radius)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(got[k].numpy(), blur_movie(movie, sigma).numpy(), rtol=1e-12,
                                   atol=1e-10)


@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
def test_sharded_box_flow_matches_jax_and_box_flow(blob_movie, tiles):
    """``sharded_box_flow`` on a CPU mesh: the box flow of the whole movie,
    float64, against the JAX package's on its (1, tx, ty) mesh of virtual
    CPU devices (rtol 1e-9, as the box flow itself) and equal to
    ``box_flow`` on the same tensor."""
    import jax

    from opticalflow_tpu.parallel import batch as jbatch
    from opticalflow_tpu.parallel import mesh as jmesh
    from opticalflow_tpu_torch.flow.boxflow import box_flow
    from opticalflow_tpu_torch.parallel import mesh as pmesh
    from opticalflow_tpu_torch.parallel.batch import sharded_box_flow

    movie, delta_x = blob_movie
    tx, ty = tiles
    cpu = torch.device("cpu")
    mesh = pmesh.make_mesh([cpu] * (tx * ty), frames=1, tx=tx, ty=ty)
    ours = sharded_box_flow(movie, 7, mesh=mesh, delta_x=delta_x, dtype=torch.float64)
    theirs = jbatch.sharded_box_flow(
        movie, 7, mesh=jmesh.make_mesh(jax.devices()[: tx * ty], frames=1, tx=tx, ty=ty),
        delta_x=delta_x, dtype=jnp.float64)
    direct = box_flow(torch.from_numpy(movie), 7, delta_x, 1.0)
    for got, want, same in zip(ours, theirs, direct):
        assert got.device == cpu and got.shape == (2, 48, 48)
        _assert_flow_close(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), same.numpy())
    # over distinct devices (two CPU indices) the pairs split over them and
    # the result is the same; devices of two types make no mesh
    split = sharded_box_flow(movie, 7, mesh=pmesh.make_mesh(
        [torch.device("cpu", 0), torch.device("cpu", 1)], frames=2), delta_x=delta_x,
        dtype=torch.float64)
    for got, same in zip(split, direct):
        np.testing.assert_array_equal(got.numpy(), same.numpy())
    with pytest.raises(ValueError, match="one type"):
        pmesh.make_mesh([cpu, torch.device("meta")], frames=1, tx=2, ty=1)
