"""The port's command line on the CPU: the synthetic experiments and the
box-size / blur-size sweeps.  Each subcommand writes the JAX CLI's files
under the same names, and its saved result equals the port's function
called directly on the same movie, exactly (the same CPU arithmetic).
Small sizes: ``--dimension 24`` (32 for the vortex pair, with alpha 5000,
where the solve converges in a few dozen iterations on the CPU).
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import os

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch import FlowResult, conduct_optical_flow, variational_optical_flow
from opticalflow_tpu_torch.analysis import drivers
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie, make_vortex_pair_movie

CPU = ["--device", "cpu"]
FLOW_KEYS = ("v_x", "v_y", "speed", "remodelling", "iterations", "converged_all")


def _saved(out, name):
    return FlowResult.load(os.path.join(out, name))


def _assert_equal(got, want, keys=FLOW_KEYS):
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _movie_written(out, stem):
    made = os.listdir(out)
    assert f"{stem}.mp4" in made or f"{stem}.gif" in made, made


@pytest.mark.parametrize("name,start,speed_alpha", [
    ("synthetic-boundary", (2.0, 10.0), 1e4), ("synthetic-big", (10.0, 10.0), 1e4)])
def test_synthetic_variational_clis(tmp_path, name, start, speed_alpha):
    out = str(tmp_path)
    drivers.main(CPU + [name, "--output-dir", out, "--dimension", "24"])
    stem = name.replace("-", "_")
    assert sorted(os.listdir(out)) == sorted([f"{stem}_result.npy", f"{stem}.gif"]) or \
        sorted(os.listdir(out)) == sorted([f"{stem}_result.npy", f"{stem}.mp4"])
    movie, delta_x = make_translating_blob_movie(n_frames=3, dimension=24, width=20.0, sigma=5.0,
                                                 v_x=0.2, v_y=0.0, start=start)
    want = variational_optical_flow(movie * 255.0, delta_x=delta_x, speed_alpha=speed_alpha,
                                    remodelling_alpha=1e4, device="cpu")
    _assert_equal(_saved(out, f"{stem}_result.npy"), want)


@pytest.mark.parametrize("include_noise", [False, True])
def test_synthetic_box_error_cli(tmp_path, include_noise):
    out = str(tmp_path)
    result, stats = drivers.main(CPU + ["synthetic-box-error", "--output-dir", out,
                                        "--dimension", "24"]
                                 + (["--include-noise"] if include_noise else []))
    suffix = "_with_noise" if include_noise else "_without_noise"
    assert sorted(os.listdir(out)) == [f"fake_flow_result{suffix}.npy",
                                       f"fake_v_histogram{suffix}.pdf"]
    movie, delta_x = make_translating_blob_movie(n_frames=5, dimension=24, width=20.0, sigma=1.0,
                                                 v_x=0.05, v_y=0.1, start=(5.0, 3.0),
                                                 include_noise=include_noise)
    want = conduct_optical_flow(movie, boxsize=15, delta_x=delta_x, delta_t=0.5,
                                dtype=torch.float64, device="cpu")
    saved = _saved(out, f"fake_flow_result{suffix}.npy")
    assert saved["v_x"].dtype == np.float64
    _assert_equal(saved, want, ("v_x", "v_y", "speed"))
    assert set(stats) >= {"median_v_x", "median_v_y", "rmse", "epe_mean"}


def test_vortex_pair_cli(tmp_path):
    out = str(tmp_path)
    args = ["--dimension", "32", "--speed-alpha", "5000", "--remodelling-alpha", "5000"]
    result, cos = drivers.main(CPU + ["vortex-pair", "--output-dir", out] + args)
    assert "vortex_pair_result.npy" in os.listdir(out)
    assert "vortex_pair_comparison.pdf" in os.listdir(out)
    _movie_written(out, "vortex_pair_overlay")
    movie, tx, ty = make_vortex_pair_movie(n_frames=3, dimension=32, peak_speed=0.5)
    want = variational_optical_flow(movie, speed_alpha=5000.0, remodelling_alpha=5000.0,
                                    dy_mode="fixed", device="cpu")
    _assert_equal(_saved(out, "vortex_pair_result.npy"), want)
    vx, vy = want["v_x"][0], want["v_y"][0]
    assert cos == pytest.approx(float(np.sum(vx * tx + vy * ty) / np.sqrt(
        np.sum(vx**2 + vy**2) * np.sum(tx**2 + ty**2))), rel=1e-12)


@pytest.fixture(scope="module")
def tiny_tiff(tmp_path_factory):
    from PIL import Image

    movie, _ = make_translating_blob_movie(n_frames=5, dimension=32, width=10.0, sigma=2.0,
                                           v_x=0.2, v_y=0.1)
    movie = (movie * 200.0).astype(np.float32)
    path = str(tmp_path_factory.mktemp("movies") / "tiny.tif")
    frames = [Image.fromarray(frame, mode="F") for frame in movie]
    frames[0].save(path, save_all=True, append_images=frames[1:])
    return path, movie.astype(np.float64)


@pytest.mark.parametrize("name", ["boxsize-sweep", "blursize-sweep"])
def test_parameter_sweep_clis(tiny_tiff, tmp_path, name):
    from opticalflow_tpu_torch.analysis.hyperparams import vary_blursize, vary_boxsize

    path, movie = tiny_tiff
    out = str(tmp_path)
    common = ["--delta-x", "0.25", "--frame-index", "2"]
    if name == "boxsize-sweep":
        drivers.main(CPU + [name, path, "--output-dir", out, "--boxsizes", "5:12:4",
                            "--smoothing-sigma", "1.0"] + common)
        want = vary_boxsize(movie, boxsizes=np.arange(5, 12, 4), frame_index=2, delta_x=0.25,
                            smoothing_sigma=1.0, device="cpu")
        stem, key = "boxsize", "boxsizes"
    else:
        drivers.main(CPU + [name, path, "--output-dir", out, "--blur-sizes", "0.8:2.2:0.6",
                            "--boxsize", "7"] + common)
        want = vary_blursize(movie, blur_sizes=np.arange(0.8, 2.2, 0.6), boxsize=7,
                             frame_index=2, delta_x=0.25, device="cpu")
        stem, key = "blursize", "blur_sizes"
    assert sorted(os.listdir(out)) == sorted([f"{stem}_sweep.npy", f"{stem}_velocities.pdf",
                                              f"{stem}_local_velocities.pdf"])
    saved = np.load(os.path.join(out, f"{stem}_sweep.npy"), allow_pickle=True).item()
    assert set(saved) == set(want)
    for k in (key, "mean_speeds", "speed_stds", "local_speeds", "test_locations"):
        np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
