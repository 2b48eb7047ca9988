"""The port's composed workflows and host-side flows against the JAX package
and the port's own direct calls, on the CPU.

The CLI subcommands built on the workflows (``dual-channel``,
``piv-compare``, ``ground-truth``) and the plotting ones
(``intensity-histograms``, ``threshold-movies``, ``coexpression``) write
the JAX CLI's files under the same names, and their results equal the
port's functions called directly, exactly.  ``conduct_opencv_flow``
(cv2 on the host) and the ground-truth comparison equal the JAX package's
exactly on the same movie and flow (the same cv2 / numpy calls on the same
arrays).  The cache resumes: a second workflow run computes no flow.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import os

import numpy as np
import pandas as pd
import pytest
import scipy.io
import torch

from opticalflow_tpu.analysis import groundtruth as jgroundtruth
from opticalflow_tpu.flow import farneback as jfarneback
from opticalflow_tpu_torch import FlowResult, conduct_optical_flow
from opticalflow_tpu_torch.analysis import drivers, groundtruth, workflows
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow.farneback import conduct_opencv_flow
from opticalflow_tpu_torch.ops.blur import blur_to_host

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 4-frame 32x32 float32 TIFF, a PIVlab-style .mat of its 3 pairs and a
    measurement sheet (csv: no xlsx engine is needed)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("inputs")
    movie, _ = make_translating_blob_movie(n_frames=4, dimension=32, width=10.0, sigma=2.0,
                                           v_x=0.2, v_y=0.1)
    movie = (movie * 200.0).astype(np.float32)
    tiff = str(root / "tiny.tif")
    frames = [Image.fromarray(frame, mode="F") for frame in movie]
    frames[0].save(tiff, save_all=True, append_images=frames[1:])
    gx, gy = np.meshgrid(np.arange(4, 32, 8), np.arange(4, 32, 8), indexing="ij")
    cells = {}
    for key, value in (("x", gx.astype(float)), ("y", gy.astype(float)),
                       ("u_original", np.full(gx.shape, 0.2)),
                       ("v_original", np.full(gx.shape, 0.1))):
        cells[key] = np.empty((3, 1), dtype=object)
        for k in range(3):
            cells[key][k, 0] = value
    mat = str(root / "piv.mat")
    scipy.io.savemat(mat, cells)
    sheet = str(root / "measurements.csv")
    pd.DataFrame({"x-position start": [10, 20], "x-position end": [12, 21],
                  "y-position start": [15, 25], "y-position end": [16, 25]}).to_csv(
        sheet, index=False)
    return {"tiff": tiff, "movie": movie.astype(np.float64), "mat": mat, "sheet": sheet}


def _movie_written(out, stem):
    made = os.listdir(out)
    assert f"{stem}.mp4" in made or f"{stem}.gif" in made, made


def test_dual_channel_cli(inputs, tmp_path):
    out = str(tmp_path)
    drivers.main(CPU + ["dual-channel", inputs["tiff"], inputs["tiff"], "--output-dir", out,
                        "--boxsize", "7", "--smoothing-sigma", "1.0", "--delta-x", "0.25"])
    made = os.listdir(out)
    for artefact in ("actin_flow_result.npy", "rho_flow_result.npy", "joint_speed_histograms.pdf",
                     "angle_value_histograms.pdf", "weighted_angle_value_histograms.pdf",
                     "speed_correlation.png", "cache"):
        assert artefact in made, artefact
    for stem in ("joint_overlay", "actin_velocities", "rho_velocities"):
        _movie_written(out, stem)
    want = conduct_optical_flow(inputs["movie"], boxsize=7, smoothing_sigma=1.0, delta_x=0.25,
                                delta_t=10.0, device="cpu")
    for name in ("actin_flow_result.npy", "rho_flow_result.npy"):
        saved = FlowResult.load(os.path.join(out, name))
        for key in ("v_x", "v_y", "speed"):
            np.testing.assert_array_equal(saved[key], want[key], err_msg=key)


def test_workflow_cache_resumes_without_computing(inputs, tmp_path, monkeypatch):
    calls = []
    compute = workflows._compute_flow
    monkeypatch.setattr(workflows, "_compute_flow",
                        lambda *a, **k: calls.append(a[1]) or compute(*a, **k))
    kw = dict(method="box", boxsize=7, smoothing_sigma=1.0, delta_x=0.25, delta_t=1.0,
              device="cpu", arrow_boxsize=8)
    movie = inputs["movie"][:3]
    first = workflows.run_dual_channel_comparison(movie, movie * 2.0, str(tmp_path), **kw)
    assert calls == ["box", "box"]
    cache_dir = tmp_path / "cache"
    mtimes = {e: os.path.getmtime(cache_dir / e) for e in os.listdir(cache_dir)}
    assert len(mtimes) == 2
    again = workflows.run_dual_channel_comparison(movie, movie * 2.0, str(tmp_path), **kw)
    assert calls == ["box", "box"]  # nothing computed the second time
    assert {e: os.path.getmtime(cache_dir / e) for e in os.listdir(cache_dir)} == mtimes
    for label in ("Actin", "Rho"):
        np.testing.assert_array_equal(again[label]["v_x"], first[label]["v_x"])


def test_piv_compare_cli(inputs, tmp_path):
    from opticalflow_tpu_torch.io.interop import convert_PIV_result, filter_PIV_flow_result, load_mat

    out = str(tmp_path)
    drivers.main(CPU + ["piv-compare", inputs["mat"], inputs["tiff"], "--output-dir", out,
                        "--intensity-threshold", "1.0"])
    made = os.listdir(out)
    for artefact in ("PIV_optical_flow_result.npy", "farneback_flow_result.npy",
                     "PIV_speed_correlation.png", "PIV_angle_histogram.pdf",
                     "PIV_polar_angle_histogram.pdf", "cache"):
        assert artefact in made, artefact
    _movie_written(out, "PIV_joint_flow")
    piv = convert_PIV_result(load_mat(inputs["mat"]), inputs["movie"])
    filter_PIV_flow_result(piv, intensity_threshold=1.0, device="cpu")
    saved = FlowResult.load(os.path.join(out, "PIV_optical_flow_result.npy"))
    for key in ("v_x", "v_y", "speed", "PIV_v_x"):
        np.testing.assert_array_equal(saved[key], piv[key], err_msg=key)
    saved = FlowResult.load(os.path.join(out, "farneback_flow_result.npy"))
    want = conduct_opencv_flow(inputs["movie"], device="cpu")
    for key in ("v_x", "v_y", "speed"):
        np.testing.assert_array_equal(saved[key], want[key], err_msg=key)


def test_ground_truth_cli(inputs, tmp_path):
    out = str(tmp_path)
    comparison = drivers.main(CPU + ["ground-truth", inputs["tiff"], inputs["sheet"],
                                     "--output-dir", out, "--frame", "2"])
    assert sorted(os.listdir(out)) == ["cache", "ground_truth_comparison.npy",
                                       "velocity_validation.pdf"]
    want = groundtruth.compare_ground_truth_displacement(
        conduct_opencv_flow(inputs["movie"], device="cpu"),
        groundtruth.load_displacement_measurements(inputs["sheet"]), frame=2)
    saved = np.load(os.path.join(out, "ground_truth_comparison.npy"), allow_pickle=True).item()
    assert set(saved) == set(want) == set(comparison)
    for key in want:
        np.testing.assert_array_equal(saved[key], want[key], err_msg=key)


def test_intensity_histograms_cli(inputs, tmp_path):
    out = str(tmp_path)
    blurred = drivers.main(CPU + ["intensity-histograms", inputs["tiff"], inputs["tiff"],
                                  "--output-dir", out, "--threshold-a", "20",
                                  "--threshold-b", "25"])
    assert sorted(os.listdir(out)) == ["both_intensity_histograms.pdf",
                                       "both_intensity_histograms_blurred.pdf"]
    for got, sigma in zip(blurred, (1.3, 1.0)):
        np.testing.assert_array_equal(got, blur_to_host(inputs["movie"], sigma, "cpu"))


@pytest.mark.parametrize("extra", [[], ["--adaptive", "--clahe", "100"]])
def test_threshold_movies_cli(inputs, tmp_path, extra):
    out = str(tmp_path)
    masks = drivers.main(CPU + ["threshold-movies", inputs["tiff"], "--output-dir", out,
                                "--threshold", "30"] + extra)
    made = os.listdir(out)
    clahe = "_w_clahe" if extra else ""
    _movie_written(out, f"joint_movie_thresholded_threshold_30.00_sigmas_1.30_1.00{clahe}")
    assert f"both_intensity_histograms_blurred{clahe}.pdf" in made
    assert len(masks) == 1 and masks[0].shape == inputs["movie"].shape
    if not extra:  # fixed-threshold masks on the raw movie, as the reference
        np.testing.assert_array_equal(masks[0], inputs["movie"] < 30.0)


def test_coexpression_cli(inputs, tmp_path):
    out = str(tmp_path / "out")
    result_path = str(tmp_path / "flow.npy")
    conduct_optical_flow(inputs["movie"][:3], boxsize=7, device="cpu").save(result_path)
    drivers.main(CPU + ["coexpression", inputs["tiff"], inputs["tiff"], "--output-dir", out,
                        "--normalised", "--flow-result-path", result_path])
    made = os.listdir(out)
    _movie_written(out, "coexpression_normalised")
    for artefact in ("speed_histograms.csv", "actin_global_speed_histogram.pdf",
                     "actin_speed_histogram_frame_00.png", "actin_speed_histogram_frame_01.png"):
        assert artefact in made, artefact


def test_farneback_and_ground_truth_match_jax(inputs):
    movie = inputs["movie"]
    ours = conduct_opencv_flow(movie, delta_x=0.5, delta_t=2.0, device="cpu", iterations=10)
    theirs = jfarneback.conduct_opencv_flow(movie, delta_x=0.5, delta_t=2.0, iterations=10)
    assert set(ours) == set(theirs)
    for key in ("v_x", "v_y", "speed", "original_data"):
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]), err_msg=key)
    # with a blur the port keeps the blurred movie under original_data
    blurred = conduct_opencv_flow(torch.from_numpy(movie), smoothing_sigma=1.5, device="cpu",
                                  iterations=10)
    np.testing.assert_array_equal(blurred["original_data"], blur_to_host(movie, 1.5, "cpu"))

    measurements = groundtruth.load_displacement_measurements(inputs["sheet"])
    jmeasurements = jgroundtruth.load_displacement_measurements(inputs["sheet"])
    for key in measurements:
        np.testing.assert_array_equal(measurements[key], jmeasurements[key])
    flow = FlowResult(v_x=torch.from_numpy(ours["v_x"]), v_y=torch.from_numpy(ours["v_y"]))
    got = groundtruth.compare_ground_truth_displacement(flow, measurements, frame=1)
    want = jgroundtruth.compare_ground_truth_displacement(theirs, jmeasurements, frame=1)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_new_entry_points_run_on_the_card_or_raise(inputs, tmp_path):
    """No device given means CUDA: without a card each new entry point
    raises instead of running on the CPU."""
    import opticalflow_tpu_torch as port
    from opticalflow_tpu_torch.io import interop
    from opticalflow_tpu_torch.parallel.batch import sharded_box_flow

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the defaults run there (tests/test_torch_gpu.py)")
    movie = inputs["movie"][:3]
    piv = conduct_optical_flow(movie, boxsize=7, device="cpu")
    calls = [
        lambda: port.VariationalConfig().run(movie),
        lambda: port.BoxFlowConfig().run(movie),
        lambda: conduct_opencv_flow(movie),
        lambda: blur_to_host(movie, 1.0),
        lambda: interop.filter_PIV_flow_result(piv),
        lambda: interop.threshold_PIV_vectors(np.ones((1, 2, 2)), np.ones((1, 2, 2)),
                                              *np.ones((3, 1, 2, 2)), movie, 1.0),
        lambda: sharded_box_flow(movie, 7),
        lambda: workflows.run_dual_channel_comparison(movie, movie, str(tmp_path / "w"),
                                                      boxsize=7),
        lambda: drivers.run_box(inputs["tiff"], str(tmp_path / "b")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
