"""The port's command line (``analysis.drivers``) on the CPU: every
subcommand the docstring names is registered, the file-based experiments
(``variational``, ``downsampled``, ``box``, ``sweep``, ``tune``) write the
JAX CLI's files under the same names, and each saved result equals the
port's function called directly, exactly (the same CPU arithmetic on the
same inputs).  One CLI-against-CLI check: ``box`` on the same TIFF against
the JAX package's ``run_box`` (the JAX CLI's own ``box`` subcommand raises,
see test_box_cli_matches_the_jax_run_box), both float32, the port held to
the JAX run's accuracy against the float64 flow.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import os
import re

import numpy as np
import pytest
import torch

from opticalflow_tpu.analysis import drivers as jdrivers
from opticalflow_tpu_torch import FlowResult, conduct_optical_flow, variational_optical_flow
from opticalflow_tpu_torch.analysis import drivers
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

CPU = ["--device", "cpu"]
NAMES = re.findall(r"^\* ``([a-z-]+)``", drivers.__doc__, re.M)


@pytest.fixture(scope="module")
def tiny_tiff(tmp_path_factory):
    """4 frames of 32x32 as a float32 multi-page TIFF (the JAX workflow
    tests' kind of file), and the movie written."""
    from PIL import Image

    movie, _ = make_translating_blob_movie(n_frames=4, dimension=32, width=10.0, sigma=2.0,
                                           v_x=0.2, v_y=0.1)
    movie = (movie * 200.0).astype(np.float32)
    path = str(tmp_path_factory.mktemp("movies") / "tiny.tif")
    frames = [Image.fromarray(frame, mode="F") for frame in movie]
    frames[0].save(path, save_all=True, append_images=frames[1:])
    return path, movie.astype(np.float64)


def _assert_saved_equal(path, want, keys):
    saved = FlowResult.load(path)
    for key in keys:
        np.testing.assert_array_equal(saved[key], want[key], err_msg=key)


def _movie_written(out, stem):
    made = os.listdir(out)
    assert f"{stem}.mp4" in made or f"{stem}.gif" in made, made


def test_the_docstring_names_the_seventeen_subcommands_of_the_jax_cli():
    assert len(NAMES) == 17
    assert set(NAMES) == set(drivers.EXPERIMENTS)
    assert set(NAMES) == set(re.findall(r"^\* ``([a-z-]+)``", jdrivers.__doc__, re.M))


@pytest.mark.parametrize("name", NAMES)
def test_every_advertised_subcommand_is_registered(name, capsys):
    with pytest.raises(SystemExit) as exit_info:
        drivers.main([name, "--help"])
    assert exit_info.value.code == 0
    assert f"usage: opticalflow_tpu_torch.analysis.drivers {name}" in capsys.readouterr().out


def test_without_device_the_cli_runs_on_the_card_or_raises(tiny_tiff, tmp_path):
    path, _ = tiny_tiff
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default runs there (tests/test_torch_gpu.py)")
    for argv in (["box", path], ["synthetic-box-error", "--dimension", "24"],
                 ["coexpression", path, path]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drivers.main(argv + ["--output-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_variational_cli_and_its_compute_step(tiny_tiff, tmp_path):
    path, movie = tiny_tiff
    out = str(tmp_path / "out")
    args = ["--frames", "0:3", "--speed-alpha", "500", "--remodelling-alpha", "500",
            "--delta-x", "0.5"]
    result = drivers.main(CPU + ["variational", path, "--output-dir", out] + args)
    assert sorted(os.listdir(out))[-1] == "variational_result.npy"
    _movie_written(out, "variational_joint")
    want = variational_optical_flow(movie[0:3], delta_x=0.5, speed_alpha=500.0,
                                    remodelling_alpha=500.0, device="cpu")
    keys = ("v_x", "v_y", "speed", "remodelling", "iterations", "converged_all")
    _assert_saved_equal(os.path.join(out, "variational_result.npy"), want, keys)
    assert result["converged_all"].all()
    # the compute-and-save step alone draws nothing
    only = str(tmp_path / "compute")
    drivers.compute_variational(path, only, delta_x=0.5, speed_alpha=500.0,
                                remodelling_alpha=500.0, frames="0:3", device="cpu")
    assert os.listdir(only) == ["variational_result.npy"]
    _assert_saved_equal(os.path.join(only, "variational_result.npy"), want, keys)


def test_downsampled_cli(tiny_tiff, tmp_path):
    from opticalflow_tpu_torch.ops.resize import downsample_movie

    path, movie = tiny_tiff
    out = str(tmp_path / "out")
    drivers.main(CPU + ["downsampled", path, "--output-dir", out, "--frames", "0:3",
                        "--factor", "0.5"])
    _movie_written(out, "variational_joint")
    small = downsample_movie(movie[0:3], 0.5, device="cpu").numpy()
    want = variational_optical_flow(small, delta_x=2.0, device="cpu", speed_alpha=1000.0,
                                    remodelling_alpha=1000.0)
    _assert_saved_equal(os.path.join(out, "variational_result.npy"), want,
                        ("v_x", "v_y", "remodelling"))
    assert FlowResult.load(os.path.join(out, "variational_result.npy"))["v_x"].shape == (2, 16, 16)


def test_box_cli_matches_the_jax_run_box(tiny_tiff, tmp_path):
    path, movie = tiny_tiff
    out, prof = str(tmp_path / "out"), str(tmp_path / "profile")
    args = ["--boxsize", "7", "--smoothing-sigma", "1.0", "--delta-x", "0.25"]
    ours = drivers.main(CPU + ["--profile", prof, "box", path, "--output-dir", out] + args)
    assert os.listdir(out) == ["box_flow_result.npy"]
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    want = conduct_optical_flow(movie, boxsize=7, smoothing_sigma=1.0, delta_x=0.25,
                                device="cpu")
    _assert_saved_equal(os.path.join(out, "box_flow_result.npy"), want, ("v_x", "v_y", "speed"))
    # the JAX CLI registers --frames for box but its run_box takes no frames,
    # so its box subcommand raises; its run_box is what the subcommand calls
    with pytest.raises(TypeError, match="frames"):
        jdrivers.main(["box", path, "--output-dir", str(tmp_path / "jax_cli")] + args)
    jdrivers.run_box(path, str(tmp_path / "jax"), boxsize=7, smoothing_sigma=1.0, delta_x=0.25,
                     delta_t=1.0)
    theirs = FlowResult.load(str(tmp_path / "jax" / "box_flow_result.npy"))
    # both CLIs run float32 box flow, whose closed-form 2x2 solve keeps ~1e-3
    # of the largest speed (PERF.md, PR 4); the two differ by ~7e-5 of it
    # here, not 1e-5.  So the port is held to the JAX CLI's own accuracy
    # against the float64 flow of the same movie, as chip_smoke's phase 8
    # holds the card to the CPU's, and to the float32 parity bound of
    # tests/test_torch_boxflow.py (1e-3 of the largest speed)
    ref = conduct_optical_flow(movie, boxsize=7, smoothing_sigma=1.0, delta_x=0.25,
                               dtype=torch.float64, device="cpu")
    scale = np.nanmax(np.abs(ref["speed"]))
    for key in ("v_x", "v_y", "speed"):
        np.testing.assert_array_equal(np.isnan(ours[key]), np.isnan(theirs[key]))
        ok = np.isfinite(ref[key])
        our_err = np.abs(ours[key][ok] - ref[key][ok]).max() / scale
        their_err = np.abs(theirs[key][ok] - ref[key][ok]).max() / scale
        assert our_err <= 2.0 * their_err + 1e-6, (key, our_err, their_err)
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-3 * scale, err_msg=key)
    # the port's --frames slices the movie
    sliced = drivers.main(CPU + ["box", path, "--output-dir", out, "--frames", "1:3"] + args)
    np.testing.assert_array_equal(sliced["v_x"], ours["v_x"][1:2])


def test_sweep_cli(tiny_tiff, tmp_path):
    from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation

    path, movie = tiny_tiff
    out = str(tmp_path / "out")
    drivers.main(CPU + ["sweep", path, "--output-dir", out, "--frames", "0:2", "--alphas",
                        "500,1500", "--remodelling-alphas", "700,2000", "--log-axes"])
    assert sorted(os.listdir(out)) == ["regularisation_sweep.npy", "regularisation_sweep.pdf"]
    saved = np.load(os.path.join(out, "regularisation_sweep.npy"), allow_pickle=True).item()
    want = vary_regularisation(movie[0:2], np.array([500.0, 1500.0]), np.array([700.0, 2000.0]),
                               device="cpu")
    assert set(saved) == set(want)
    for key in want:
        np.testing.assert_array_equal(saved[key], want[key], err_msg=key)


def test_tune_cli(tiny_tiff, tmp_path):
    from opticalflow_tpu_torch.analysis.tuning import optimize_regularisation_parameters
    from opticalflow_tpu_torch.ops.resize import area_resize_movie

    path, movie = tiny_tiff
    out = str(tmp_path / "out")
    optimal, value = drivers.main(CPU + ["tune", path, "--output-dir", out, "--resolution", "24",
                                         "--frames", "0:2"])
    saved = np.load(os.path.join(out, "optimal_regularisation.npy"), allow_pickle=True).item()
    small = area_resize_movie(movie[0:2], 24, 24, device="cpu").numpy()
    want, want_value, opt = optimize_regularisation_parameters(
        small, delta_x=32 / 24, smoothing_sigma=1.0, initial_v_x=0.07, initial_v_y=0.07,
        initial_remodelling=10.0, use_direct_solver=True, device="cpu")
    np.testing.assert_array_equal(saved["optimal"], want)
    assert saved["functional"] == want_value == value and saved["nfev"] == opt.nfev
    np.testing.assert_array_equal(optimal, want)
