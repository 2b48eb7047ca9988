"""Analysis drivers: the port's command line.

Counterpart of ``opticalflow_tpu.analysis.drivers``: each experiment of the
reference's scripts is a parameterised function plus one argparse CLI,

    python -m opticalflow_tpu_torch.analysis.drivers [--device DEV] [--profile LOGDIR] \\
        <experiment> ...

with the JAX package's subcommands, arguments, defaults and output files:

* ``synthetic-boundary``   — blob translating through the domain (data on the boundary)
* ``synthetic-big``        — large fake-data variational run, size configurable
* ``synthetic-box-error``  — box-method accuracy against known velocities
* ``variational``          — variational run on a TIFF stack or image folder
* ``box``                  — production box-method run
* ``sweep``                — regularisation sweep + heatmaps
* ``tune``                 — shgo regularisation optimisation
* ``downsampled``          — INTER_AREA-downsampled variational run
* ``boxsize-sweep``        — box-size sensitivity sweep
* ``blursize-sweep``       — blur-size sensitivity sweep
* ``dual-channel``         — joint Rho / actin comparison
* ``piv-compare``          — PIV vs flow comparison
* ``ground-truth``         — hand-clicked displacement validation
* ``intensity-histograms`` — raw + blurred intensity histograms with thresholds
* ``threshold-movies``     — thresholded / CLAHE channel overlay movies
* ``coexpression``         — red / green coexpression movie + speed histograms
* ``vortex-pair``          — figure-producing vortex-pair experiment

``variational``, ``piv-compare`` and ``ground-truth`` accept
``--correct-intensity`` to apply the global illumination-change correction
before solving.

``--device`` is where every computation runs: by default the CUDA device
(without one the command raises); ``--device cpu`` runs on the CPU.
``--profile LOGDIR`` writes a ``torch.profiler`` trace of the experiment to
``LOGDIR/trace.json`` and prints the span statistics.  Every ``run_*``
takes ``device=None`` (the CUDA device).

A ``run_*`` whose experiment computes a flow or a sweep and then plots is
two steps, called in the JAX package's order: ``compute_*`` (load, flow,
save) and ``plot_*`` (matplotlib, imported only there), so the compute step
runs where matplotlib is not installed.  Loading, saving and plotting are
recorded as the spans ``drivers/load``, ``drivers/save`` and
``drivers/plot`` (utils.observability).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from opticalflow_tpu_torch.analysis.statistics import ground_truth_error_statistics
from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation
from opticalflow_tpu_torch.analysis.tuning import optimize_regularisation_parameters
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.flow.boxflow import conduct_optical_flow
from opticalflow_tpu_torch.flow.variational import variational_optical_flow
from opticalflow_tpu_torch.ops.blur import blur_to_host
from opticalflow_tpu_torch.ops.resize import downsample_movie
from opticalflow_tpu_torch.utils.device import resolve_device
from opticalflow_tpu_torch.utils.observability import span


def _load_movie(path: str, dtype=np.float64) -> np.ndarray:
    from opticalflow_tpu_torch.io.sequences import read_image_sequence_as_movie, read_tiff_movie

    with span("drivers/load"):
        if os.path.isdir(path):
            return read_image_sequence_as_movie(path, dtype=dtype)
        return read_tiff_movie(path, dtype=dtype)


def _frame_slice(movie, frames: Optional[str]):
    """``movie[start:stop]`` for a ``'start:stop'`` string, else ``movie``."""
    if not frames:
        return movie
    start, stop = (int(x) for x in frames.split(":"))
    return movie[start:stop]


def _save(result: FlowResult, path: str) -> None:
    with span("drivers/save"):
        result.save(path)


def compute_synthetic_boundary(output_dir: str, dimension: int = 100,
                               speed_alpha: float = 1e4, remodelling_alpha: float = 1e4,
                               device=None) -> FlowResult:
    """Blob translating through the domain (data touching the boundary):
    variational solve, saved."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=dimension, width=20.0, sigma=5.0, v_x=0.2, v_y=0.0,
        start=(2.0, 10.0),
    )
    result = variational_optical_flow(
        movie * 255.0, delta_x=delta_x, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha, device=device,
    )
    os.makedirs(output_dir, exist_ok=True)
    _save(result, os.path.join(output_dir, "synthetic_boundary_result.npy"))
    return result


def plot_synthetic_boundary(result: FlowResult, output_dir: str, dimension: int = 100) -> None:
    from opticalflow_tpu_torch.viz.plots import make_joint_overlay_movie

    with span("drivers/plot"):
        make_joint_overlay_movie(
            result, os.path.join(output_dir, "synthetic_boundary.mp4"),
            autoscale=True, arrow_boxsize=max(4, dimension // 25), dpi=150,
        )


def run_synthetic_boundary(output_dir: str, dimension: int = 100,
                           speed_alpha: float = 1e4, remodelling_alpha: float = 1e4,
                           device=None):
    """Blob translating through the domain, variational solve + overlay
    movie."""
    result = compute_synthetic_boundary(output_dir, dimension, speed_alpha, remodelling_alpha,
                                        device)
    plot_synthetic_boundary(result, output_dir, dimension)
    return result


_BOX_ERROR_VELOCITY = (0.1, 0.2)  # (v_x, v_y) of synthetic-box-error


def compute_synthetic_box_error(output_dir: str, include_noise: bool = False,
                                dimension: int = 256, device=None):
    """Box-method flow (float64) of a blob moving at known velocities, its
    error statistics, saved; returns ``(result, stats)``."""
    (x_velocity, y_velocity), delta_t = _BOX_ERROR_VELOCITY, 0.5
    movie, delta_x = make_translating_blob_movie(
        n_frames=5, dimension=dimension, width=20.0, sigma=1.0,
        v_x=x_velocity * delta_t, v_y=y_velocity * delta_t, start=(5.0, 3.0),
        include_noise=include_noise,
    )
    result = conduct_optical_flow(movie, boxsize=15, delta_x=delta_x, delta_t=delta_t,
                                  dtype=torch.float64, device=device)
    stats = ground_truth_error_statistics(result, x_velocity, y_velocity)
    os.makedirs(output_dir, exist_ok=True)
    suffix = "_with_noise" if include_noise else "_without_noise"
    _save(result, os.path.join(output_dir, f"fake_flow_result{suffix}.npy"))
    return result, stats


def plot_synthetic_box_error(result: FlowResult, output_dir: str,
                             include_noise: bool = False) -> None:
    """Histograms of v_x and v_y with the true values marked."""
    import matplotlib.pyplot as plt

    suffix = "_with_noise" if include_noise else "_without_noise"
    with span("drivers/plot"):
        plt.figure(figsize=(4.5, 2.5))
        for k, (key, truth) in enumerate(zip(("v_x", "v_y"), _BOX_ERROR_VELOCITY)):
            plt.subplot(1, 2, k + 1)
            finite = np.asarray(result[key])
            finite = finite[np.isfinite(finite)]
            plt.hist(finite.ravel(), bins=100)
            plt.axvline(truth, color="red", lw=0.2)
            plt.xlabel(f"$\\mathrm{{{key}}}$ values")
            plt.ylabel("Number of Pixels")
        plt.tight_layout()
        plt.savefig(os.path.join(output_dir, f"fake_v_histogram{suffix}.pdf"))
        plt.close()


def run_synthetic_box_error(output_dir: str, include_noise: bool = False,
                            dimension: int = 256, device=None):
    """Box-method accuracy against known velocities (v_x=0.1, v_y=0.2),
    with histograms."""
    result, stats = compute_synthetic_box_error(output_dir, include_noise, dimension, device)
    plot_synthetic_box_error(result, output_dir, include_noise)
    print("ground-truth error statistics:", stats)
    return result, stats


def compute_variational(movie_path: str, output_dir: str, delta_x: float = 1.0,
                        delta_t: float = 1.0, speed_alpha: float = 1000.0,
                        remodelling_alpha: float = 1000.0,
                        smoothing_sigma: Optional[float] = None,
                        frames: Optional[str] = None, downsample: Optional[float] = None,
                        correct_intensity: bool = False, device=None) -> FlowResult:
    """Load the movie, optionally slice, correct and downsample it, solve,
    and save ``variational_result.npy``."""
    movie = _frame_slice(_load_movie(movie_path), frames)
    if correct_intensity:
        from opticalflow_tpu_torch.analysis.statistics import correct_intensity_change

        movie = correct_intensity_change(movie, device=device)
    if downsample:
        movie = downsample_movie(movie, downsample, device=device).cpu().numpy()
        delta_x = delta_x / downsample
    result = variational_optical_flow(
        movie, delta_x=delta_x, delta_t=delta_t, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha, smoothing_sigma=smoothing_sigma, device=device,
    )
    os.makedirs(output_dir, exist_ok=True)
    _save(result, os.path.join(output_dir, "variational_result.npy"))
    return result


def plot_variational(result: FlowResult, output_dir: str) -> None:
    from opticalflow_tpu_torch.viz.plots import make_joint_overlay_movie

    with span("drivers/plot"):
        make_joint_overlay_movie(result, os.path.join(output_dir, "variational_joint.mp4"),
                                 autoscale=True, dpi=150)


def run_variational(movie_path: str, output_dir: str, delta_x: float = 1.0,
                    delta_t: float = 1.0, speed_alpha: float = 1000.0,
                    remodelling_alpha: float = 1000.0,
                    smoothing_sigma: Optional[float] = None,
                    frames: Optional[str] = None, downsample: Optional[float] = None,
                    correct_intensity: bool = False, device=None):
    """Full variational run on a movie file / folder, with optional
    INTER_AREA downsampling; ``correct_intensity`` applies the global
    illumination-change correction before solving."""
    result = compute_variational(
        movie_path, output_dir, delta_x=delta_x, delta_t=delta_t, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha, smoothing_sigma=smoothing_sigma, frames=frames,
        downsample=downsample, correct_intensity=correct_intensity, device=device)
    plot_variational(result, output_dir)
    return result


def run_box(movie_path: str, output_dir: str, delta_x: float = 0.0913,
            delta_t: float = 10.0, boxsize: int = 31, smoothing_sigma: float = 3.0,
            include_remodelling: bool = False, frames: Optional[str] = None, device=None):
    """Production box-method run (the reference's boxsize 31, sigma 3 and
    actin / Rho pixel geometry).  ``frames`` slices the movie, as the CLI's
    ``--frames`` option says (the JAX package registers that option for
    ``box`` but its ``run_box`` takes no ``frames``, so its ``box``
    subcommand raises ``TypeError``)."""
    movie = _frame_slice(_load_movie(movie_path), frames)
    result = conduct_optical_flow(
        movie, boxsize=boxsize, delta_x=delta_x, delta_t=delta_t,
        smoothing_sigma=smoothing_sigma, include_remodelling=include_remodelling,
        device=device,
    )
    os.makedirs(output_dir, exist_ok=True)
    _save(result, os.path.join(output_dir, "box_flow_result.npy"))
    return result


def compute_sweep(movie_path: str, output_dir: str, delta_x: float = 1.0,
                  delta_t: float = 1.0, alphas: str = "500,1000,1500",
                  remodelling_alphas: Optional[str] = None,
                  frames: Optional[str] = None, device=None):
    """The regularisation sweep over the comma-separated alphas, saved as
    ``regularisation_sweep.npy``."""
    movie = _frame_slice(_load_movie(movie_path), frames)
    speed_values = np.array([float(x) for x in alphas.split(",")])
    rem_values = (
        np.array([float(x) for x in remodelling_alphas.split(",")])
        if remodelling_alphas else speed_values
    )
    os.makedirs(output_dir, exist_ok=True)
    return vary_regularisation(
        movie, speed_values, rem_values, delta_x=delta_x, delta_t=delta_t,
        filename=os.path.join(output_dir, "regularisation_sweep.npy"), device=device,
    )


def plot_sweep(result, output_dir: str, log_axes: bool = False) -> None:
    from opticalflow_tpu_torch.viz.plots import plot_regularisation_variation

    with span("drivers/plot"):
        plot_regularisation_variation(
            result, os.path.join(output_dir, "regularisation_sweep.pdf"),
            use_log_axes=log_axes, use_log_colorbar=log_axes,
        )


def run_sweep(movie_path: str, output_dir: str, delta_x: float = 1.0,
              delta_t: float = 1.0, alphas: str = "500,1000,1500",
              remodelling_alphas: Optional[str] = None, log_axes: bool = False,
              frames: Optional[str] = None, device=None):
    """Regularisation sweep + heatmaps."""
    result = compute_sweep(movie_path, output_dir, delta_x=delta_x, delta_t=delta_t,
                           alphas=alphas, remodelling_alphas=remodelling_alphas,
                           frames=frames, device=device)
    plot_sweep(result, output_dir, log_axes)
    return result


def run_tune(movie_path: str, output_dir: str, delta_x: float = 1.0,
             delta_t: float = 1.0, resolution: int = 150,
             smoothing_sigma: float = 1.0, frames: Optional[str] = None, device=None):
    """shgo regularisation tuning on a downsampled movie (INTER_AREA
    downsample to ``resolution``, direct solver, log10 bounds)."""
    from opticalflow_tpu_torch.ops.resize import area_resize_movie

    movie = _frame_slice(_load_movie(movie_path), frames)
    scaled_delta_x = movie.shape[1] / resolution * delta_x
    movie_small = area_resize_movie(movie, resolution, resolution, device=device).cpu().numpy()
    optimal, value, opt = optimize_regularisation_parameters(
        movie_small, delta_x=scaled_delta_x, delta_t=delta_t,
        smoothing_sigma=smoothing_sigma, initial_v_x=0.07, initial_v_y=0.07,
        initial_remodelling=10.0, use_direct_solver=True, verbose=True, device=device,
    )
    print("Optimal regularisation:", optimal)
    print("Minimum value:", value)
    print("Number of function evaluations:", opt.nfev)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, "optimal_regularisation.npy"),
            {"optimal": optimal, "functional": value, "nfev": opt.nfev})
    return optimal, value


def compute_synthetic_big(output_dir: str, dimension: int = 1000,
                          speed_alpha: float = 1e4, remodelling_alpha: float = 1e4,
                          device=None) -> FlowResult:
    """Large fake-data variational solve, saved, with summary statistics
    printed."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=dimension, width=20.0, sigma=5.0, v_x=0.2, v_y=0.0,
        start=(10.0, 10.0),
    )
    result = variational_optical_flow(
        movie * 255.0, delta_x=delta_x, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha, device=device,
    )
    os.makedirs(output_dir, exist_ok=True)
    _save(result, os.path.join(output_dir, "synthetic_big_result.npy"))
    print("mean speed:", float(np.nanmean(result["speed"])),
          "max speed:", float(np.nanmax(result["speed"])),
          "converged:", result["converged"])
    return result


def plot_synthetic_big(result: FlowResult, output_dir: str, dimension: int = 1000) -> None:
    from opticalflow_tpu_torch.viz.plots import make_joint_overlay_movie

    with span("drivers/plot"):
        make_joint_overlay_movie(
            result, os.path.join(output_dir, "synthetic_big.mp4"),
            autoscale=True, arrow_boxsize=max(4, dimension // 25), dpi=100,
        )


def run_synthetic_big(output_dir: str, dimension: int = 1000,
                      speed_alpha: float = 1e4, remodelling_alpha: float = 1e4, device=None):
    """Large fake-data variational run (a 1000^2 blob movie by default):
    full solve, summary statistics, overlay movie."""
    result = compute_synthetic_big(output_dir, dimension, speed_alpha, remodelling_alpha,
                                   device)
    plot_synthetic_big(result, output_dir, dimension)
    return result


def compute_boxsize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                          delta_t: float = 10.0, boxsizes: str = "5:150:2",
                          smoothing_sigma: float = 1.3, frame_index: int = 3, device=None):
    """The box-size sweep (one batched computation), saved as
    ``boxsize_sweep.npy``."""
    from opticalflow_tpu_torch.analysis.hyperparams import vary_boxsize

    movie = _load_movie(movie_path)
    start, stop, step = (int(x) for x in boxsizes.split(":"))
    os.makedirs(output_dir, exist_ok=True)
    return vary_boxsize(
        movie, boxsizes=np.arange(start, stop, step), frame_index=frame_index,
        delta_x=delta_x, delta_t=delta_t, smoothing_sigma=smoothing_sigma,
        filename=os.path.join(output_dir, "boxsize_sweep.npy"), device=device,
    )


def compute_blursize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                           delta_t: float = 10.0, blur_sizes: str = "0.5:15:0.1",
                           boxsize: int = 21, frame_index: int = 3, device=None):
    """The blur-size sweep (one batched computation), saved as
    ``blursize_sweep.npy``."""
    from opticalflow_tpu_torch.analysis.hyperparams import vary_blursize

    movie = _load_movie(movie_path)
    start, stop, step = (float(x) for x in blur_sizes.split(":"))
    os.makedirs(output_dir, exist_ok=True)
    return vary_blursize(
        movie, blur_sizes=np.arange(start, stop, step), boxsize=boxsize,
        frame_index=frame_index, delta_x=delta_x, delta_t=delta_t,
        filename=os.path.join(output_dir, "blursize_sweep.npy"), device=device,
    )


def plot_parameter_sweep(sweep, output_dir: str, name: str, parameter_key: str) -> None:
    """The summary figures of a box-size (``name='boxsize'``) or blur-size
    (``'blursize'``) sweep."""
    from opticalflow_tpu_torch.viz.plots import plot_parameter_sweep_summary

    with span("drivers/plot"):
        plot_parameter_sweep_summary(sweep, os.path.join(output_dir, name), parameter_key)


def run_boxsize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                      delta_t: float = 10.0, boxsizes: str = "5:150:2",
                      smoothing_sigma: float = 1.3, frame_index: int = 3, device=None):
    """Box-size sensitivity sweep, batched on the device, + its figures."""
    sweep = compute_boxsize_sweep(movie_path, output_dir, delta_x, delta_t, boxsizes,
                                  smoothing_sigma, frame_index, device)
    plot_parameter_sweep(sweep, output_dir, "boxsize", "boxsizes")
    return sweep


def run_blursize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                       delta_t: float = 10.0, blur_sizes: str = "0.5:15:0.1",
                       boxsize: int = 21, frame_index: int = 3, device=None):
    """Blur-size sensitivity sweep, batched on the device, + its figures."""
    sweep = compute_blursize_sweep(movie_path, output_dir, delta_x, delta_t, blur_sizes,
                                   boxsize, frame_index, device)
    plot_parameter_sweep(sweep, output_dir, "blursize", "blur_sizes")
    return sweep


def run_dual_channel(movie_path_a: str, movie_path_b: str, output_dir: str,
                     delta_x: float = 0.0913, delta_t: float = 10.0,
                     boxsize: int = 31, smoothing_sigma: float = 3.0,
                     label_a: str = "Actin", label_b: str = "Rho",
                     method: str = "box", device=None):
    """Dual-channel comparison workflow (analysis.workflows)."""
    from opticalflow_tpu_torch.analysis.workflows import run_dual_channel_comparison

    return run_dual_channel_comparison(
        _load_movie(movie_path_a), _load_movie(movie_path_b), output_dir,
        label_a=label_a, label_b=label_b, method=method, boxsize=boxsize,
        smoothing_sigma=smoothing_sigma, delta_x=delta_x, delta_t=delta_t, device=device,
    )


def _load_corrected(movie_path: str, correct_intensity: bool, device) -> np.ndarray:
    movie = _load_movie(movie_path)
    if correct_intensity:
        from opticalflow_tpu_torch.analysis.statistics import correct_intensity_change

        movie = correct_intensity_change(movie, device=device)
    return movie


def run_piv_compare(piv_mat_path: str, movie_path: str, output_dir: str,
                    method: str = "farneback", intensity_threshold: float = 10.0,
                    correct_intensity: bool = False, device=None):
    """PIV-vs-flow comparison workflow (analysis.workflows)."""
    from opticalflow_tpu_torch.analysis.workflows import run_piv_comparison

    return run_piv_comparison(
        piv_mat_path, _load_corrected(movie_path, correct_intensity, device), output_dir,
        method=method, intensity_threshold=intensity_threshold, device=device,
    )


def run_ground_truth(movie_path: str, measurements_path: str, output_dir: str,
                     method: str = "farneback", frame: int = 8,
                     correct_intensity: bool = False, device=None):
    """Hand-clicked displacement validation workflow (analysis.workflows)."""
    from opticalflow_tpu_torch.analysis.workflows import run_ground_truth_validation

    return run_ground_truth_validation(
        _load_corrected(movie_path, correct_intensity, device), measurements_path, output_dir,
        method=method, frame=frame, device=device,
    )


def run_downsampled(movie_path: str, output_dir: str, delta_x: float = 1.0,
                    delta_t: float = 1.0, factor: float = 0.5,
                    speed_alpha: float = 1000.0, remodelling_alpha: float = 1000.0,
                    smoothing_sigma: Optional[float] = None,
                    frames: Optional[str] = None, device=None):
    """INTER_AREA-downsampled variational run."""
    return run_variational(
        movie_path, output_dir, delta_x=delta_x, delta_t=delta_t,
        speed_alpha=speed_alpha, remodelling_alpha=remodelling_alpha,
        smoothing_sigma=smoothing_sigma, frames=frames, downsample=factor, device=device,
    )


def _channels(movie_path_a, movie_path_b, label_a, label_b, *per_channel):
    """The loaded movies, labels and per-channel values of one or two
    channels."""
    movies, labels = [_load_movie(movie_path_a)], [label_a]
    values = [[a] for a, _ in per_channel]
    if movie_path_b is not None:
        movies.append(_load_movie(movie_path_b))
        labels.append(label_b)
        for column, (_, b) in zip(values, per_channel):
            column.append(b)
    return movies, labels, values


def run_intensity_analysis(movie_path_a: str, movie_path_b: Optional[str] = None,
                           output_dir: str = "output", sigma_a: float = 1.3,
                           sigma_b: float = 1.0, threshold_a: float = 17.0,
                           threshold_b: float = 18.0, label_a: str = "Actin",
                           label_b: str = "Rho", device=None):
    """Raw + blurred per-channel intensity histograms with the
    mode-separating thresholds; the blurs run on ``device``."""
    from opticalflow_tpu_torch.viz.plots import plot_intensity_histograms

    movies, labels, (sigmas, thresholds) = _channels(
        movie_path_a, movie_path_b, label_a, label_b, (sigma_a, sigma_b),
        (threshold_a, threshold_b))
    os.makedirs(output_dir, exist_ok=True)
    plot_intensity_histograms(
        movies, labels,
        os.path.join(output_dir, "both_intensity_histograms.pdf"),
        xlim=(-2, 120),
    )
    blurred = [blur_to_host(m, s, device) for m, s in zip(movies, sigmas)]
    plot_intensity_histograms(
        blurred, labels,
        os.path.join(output_dir, "both_intensity_histograms_blurred.pdf"),
        thresholds=thresholds, xlim=(0, 100),
    )
    for movie, label in zip(movies, labels):
        print(f"{label}: {len(np.unique(np.asarray(movie)))} unique "
              f"intensity values")
    return blurred


def run_threshold_movies(movie_path_a: str, movie_path_b: Optional[str] = None,
                         output_dir: str = "output", threshold: float = 17.5,
                         sigma_a: float = 1.3, sigma_b: float = 1.0,
                         label_a: str = "Actin", label_b: str = "Rho",
                         clahe: Optional[float] = None, adaptive: bool = False,
                         delta_x: float = 0.0913, device=None):
    """Thresholded channel overlay movie: below-threshold pixels render
    grayscale, the rest green; optional CLAHE pre-normalisation and adaptive
    (mean-C) thresholding, on ``device``; plus the blurred histograms."""
    from opticalflow_tpu_torch.ops.threshold import apply_adaptive_threshold
    from opticalflow_tpu_torch.viz.plots import (
        make_channel_movie, plot_intensity_histograms, tint_below_mask,
    )

    movies, labels, (sigmas,) = _channels(movie_path_a, movie_path_b, label_a, label_b,
                                          (sigma_a, sigma_b))
    clahe_string = ""
    if clahe is not None:
        from opticalflow_tpu_torch.ops.clahe import apply_clahe

        movies = [apply_clahe(m, clipLimit=clahe, device=device).cpu().numpy() for m in movies]
        movies = [m / np.max(m) * 255.0 for m in movies]
        clahe_string = "_w_clahe"

    blurred = [blur_to_host(m, s, device) for m, s in zip(movies, sigmas)]
    if adaptive:
        masks = [apply_adaptive_threshold(b, window_size=151, threshold=-5,
                                          device=device).cpu().numpy()
                 for b in blurred]
    else:
        # fixed threshold masks on the raw movie, as the reference
        masks = [np.asarray(m) < threshold for m in movies]

    rgb = [tint_below_mask(m, mask) for m, mask in zip(movies, masks)]
    os.makedirs(output_dir, exist_ok=True)
    name = (f"joint_movie_thresholded_threshold_{threshold:.2f}"
            f"_sigmas_{sigma_a:.2f}_{sigma_b:.2f}{clahe_string}.mp4")
    make_channel_movie(rgb, labels, delta_x, os.path.join(output_dir, name))
    plot_intensity_histograms(
        blurred, labels,
        os.path.join(output_dir,
                     f"both_intensity_histograms_blurred{clahe_string}.pdf"),
        thresholds=[threshold] * len(blurred),
    )
    return masks


def run_coexpression(movie_path_a: str, movie_path_b: str,
                     output_dir: str = "output", normalised: bool = False,
                     flow_result_path: Optional[str] = None,
                     label: str = "Actin", device=None):
    """Joint red / green coexpression movie of the two channels, plus, when
    a saved flow result is given, global and per-frame speed histograms with
    the binned table exported.  Host only: ``device`` is accepted for the
    CLI's uniform signature and not used."""
    from opticalflow_tpu_torch.viz.plots import (
        make_coexpression_movie, plot_speed_histograms,
    )

    movie_a = _load_movie(movie_path_a)
    movie_b = _load_movie(movie_path_b)
    os.makedirs(output_dir, exist_ok=True)
    suffix = "normalised" if normalised else "unnormalised"
    make_coexpression_movie(
        movie_a, movie_b,
        os.path.join(output_dir, f"coexpression_{suffix}.mp4"),
        normalised=normalised,
    )
    if flow_result_path is not None:
        result = FlowResult.load(flow_result_path)
        plot_speed_histograms(result, output_dir, label=label)
    return None


def compute_vortex_pair(output_dir: str = "output", dimension: int = 128,
                        peak_speed: float = 0.5, speed_alpha: float = 500.0,
                        remodelling_alpha: float = 500.0, device=None):
    """The analytic vortex-pair movie solved (dy_mode 'fixed'), saved;
    returns ``(result, true_v_x, true_v_y, cosine)``, the last the
    flow-alignment cosine of the inferred and the true field on pair 0."""
    from opticalflow_tpu_torch.core.synth import make_vortex_pair_movie

    movie, v_true_x, v_true_y = make_vortex_pair_movie(
        n_frames=3, dimension=dimension, peak_speed=peak_speed,
    )
    result = variational_optical_flow(
        movie, speed_alpha=speed_alpha, remodelling_alpha=remodelling_alpha,
        dy_mode="fixed", device=device,
    )
    os.makedirs(output_dir, exist_ok=True)
    _save(result, os.path.join(output_dir, "vortex_pair_result.npy"))
    vx, vy = result["v_x"][0], result["v_y"][0]
    tx, ty = np.asarray(v_true_x), np.asarray(v_true_y)
    cos = float(
        np.sum(vx * tx + vy * ty)
        / max(np.sqrt(np.sum(vx**2 + vy**2) * np.sum(tx**2 + ty**2)), 1e-30)
    )
    return result, tx, ty, cos


def plot_vortex_pair(result: FlowResult, true_v_x, true_v_y, cos: float, output_dir: str,
                     dimension: int = 128) -> None:
    """The overlay movie and the inferred-vs-true |v| figure."""
    import matplotlib.pyplot as plt

    from opticalflow_tpu_torch.viz.plots import make_velocity_overlay_movie

    with span("drivers/plot"):
        make_velocity_overlay_movie(
            result, os.path.join(output_dir, "vortex_pair_overlay.mp4"),
            arrow_boxsize=max(4, dimension // 16), autoscale=True, dpi=150,
        )
        vx, vy = result["v_x"][0], result["v_y"][0]
        plt.figure(figsize=(4.5, 2.5), constrained_layout=True)
        for k, (field, title) in enumerate([((vx, vy), "inferred"),
                                            ((true_v_x, true_v_y), "true")]):
            plt.subplot(1, 2, k + 1)
            plt.imshow(np.sqrt(field[0] ** 2 + field[1] ** 2), cmap="viridis")
            step = max(1, dimension // 16)
            sl = (slice(step // 2, None, step),) * 2
            plt.quiver(*np.meshgrid(*(np.arange(dimension)[s] for s in sl),
                                    indexing="xy"),
                       field[1][sl], -field[0][sl], color="magenta")
            plt.title(f"{title} |v|")
        plt.suptitle(f"flow-alignment cosine: {cos:.4f}")
        plt.savefig(os.path.join(output_dir, "vortex_pair_comparison.pdf"))
        plt.close()


def run_vortex_pair(output_dir: str = "output", dimension: int = 128,
                    peak_speed: float = 0.5, speed_alpha: float = 500.0,
                    remodelling_alpha: float = 500.0, device=None):
    """Figure-producing vortex-pair experiment (the movie rebuilt
    analytically)."""
    result, tx, ty, cos = compute_vortex_pair(output_dir, dimension, peak_speed, speed_alpha,
                                              remodelling_alpha, device)
    plot_vortex_pair(result, tx, ty, cos, output_dir, dimension)
    print(f"vortex-pair alignment cosine: {cos:.4f}")
    return result, cos


EXPERIMENTS = {
    "synthetic-boundary": run_synthetic_boundary,
    "synthetic-big": run_synthetic_big,
    "synthetic-box-error": run_synthetic_box_error,
    "variational": run_variational,
    "box": run_box,
    "sweep": run_sweep,
    "tune": run_tune,
    "boxsize-sweep": run_boxsize_sweep,
    "blursize-sweep": run_blursize_sweep,
    "dual-channel": run_dual_channel,
    "piv-compare": run_piv_compare,
    "ground-truth": run_ground_truth,
    "downsampled": run_downsampled,
    "intensity-histograms": run_intensity_analysis,
    "threshold-movies": run_threshold_movies,
    "coexpression": run_coexpression,
    "vortex-pair": run_vortex_pair,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="opticalflow_tpu_torch.analysis.drivers")
    parser.add_argument(
        "--device", default=None,
        help="where the experiment computes: a torch device such as 'cuda', 'cuda:1' or "
        "'cpu' (default: the CUDA device; without one the command raises)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="capture a torch.profiler trace of the experiment into LOGDIR/trace.json "
        "(Chrome trace format) and print wall-clock span statistics at exit",
    )
    sub = parser.add_subparsers(dest="experiment", required=True)

    p = sub.add_parser("synthetic-boundary")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=100)

    p = sub.add_parser("synthetic-big")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=1000)
    p.add_argument("--speed-alpha", type=float, default=1e4)
    p.add_argument("--remodelling-alpha", type=float, default=1e4)

    p = sub.add_parser("synthetic-box-error")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--include-noise", action="store_true")
    p.add_argument("--dimension", type=int, default=256)

    p = sub.add_parser("boxsize-sweep")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--boxsizes", default="5:150:2", help="start:stop:step")
    p.add_argument("--smoothing-sigma", type=float, default=1.3)
    p.add_argument("--frame-index", type=int, default=3)

    p = sub.add_parser("blursize-sweep")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--blur-sizes", default="0.5:15:0.1", help="start:stop:step")
    p.add_argument("--boxsize", type=int, default=21)
    p.add_argument("--frame-index", type=int, default=3)

    p = sub.add_parser("dual-channel")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--boxsize", type=int, default=31)
    p.add_argument("--smoothing-sigma", type=float, default=3.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")
    p.add_argument("--method", default="box", choices=("box", "variational", "farneback"))

    p = sub.add_parser("piv-compare")
    p.add_argument("piv_mat_path")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--method", default="farneback",
                   choices=("box", "variational", "farneback"))
    p.add_argument("--intensity-threshold", type=float, default=10.0)
    p.add_argument("--correct-intensity", action="store_true")

    p = sub.add_parser("ground-truth")
    p.add_argument("movie_path")
    p.add_argument("measurements_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--method", default="farneback",
                   choices=("box", "variational", "farneback"))
    p.add_argument("--frame", type=int, default=8)
    p.add_argument("--correct-intensity", action="store_true")

    p = sub.add_parser("intensity-histograms")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b", nargs="?", default=None)
    p.add_argument("--output-dir", default="output")
    p.add_argument("--sigma-a", type=float, default=1.3)
    p.add_argument("--sigma-b", type=float, default=1.0)
    p.add_argument("--threshold-a", type=float, default=17.0)
    p.add_argument("--threshold-b", type=float, default=18.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")

    p = sub.add_parser("threshold-movies")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b", nargs="?", default=None)
    p.add_argument("--output-dir", default="output")
    p.add_argument("--threshold", type=float, default=17.5)
    p.add_argument("--sigma-a", type=float, default=1.3)
    p.add_argument("--sigma-b", type=float, default=1.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")
    p.add_argument("--clahe", type=float, default=None)
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--delta-x", type=float, default=0.0913)

    p = sub.add_parser("coexpression")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--normalised", action="store_true")
    p.add_argument("--flow-result-path", default=None)
    p.add_argument("--label", default="Actin")

    p = sub.add_parser("vortex-pair")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--peak-speed", type=float, default=0.5)
    p.add_argument("--speed-alpha", type=float, default=500.0)
    p.add_argument("--remodelling-alpha", type=float, default=500.0)

    p = sub.add_parser("downsampled")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=1.0)
    p.add_argument("--delta-t", type=float, default=1.0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--speed-alpha", type=float, default=1000.0)
    p.add_argument("--remodelling-alpha", type=float, default=1000.0)
    p.add_argument("--smoothing-sigma", type=float, default=None)
    p.add_argument("--frames", default=None, help="start:stop frame slice")

    for name in ("variational", "box", "sweep", "tune"):
        p = sub.add_parser(name)
        p.add_argument("movie_path")
        p.add_argument("--output-dir", default="output")
        p.add_argument("--delta-x", type=float, default=1.0)
        p.add_argument("--delta-t", type=float, default=1.0)
        p.add_argument("--frames", default=None, help="start:stop frame slice")
        if name == "variational":
            p.add_argument("--speed-alpha", type=float, default=1000.0)
            p.add_argument("--remodelling-alpha", type=float, default=1000.0)
            p.add_argument("--smoothing-sigma", type=float, default=None)
            p.add_argument("--downsample", type=float, default=None)
            p.add_argument("--correct-intensity", action="store_true")
        if name == "box":
            p.add_argument("--boxsize", type=int, default=31)
            p.add_argument("--smoothing-sigma", type=float, default=3.0)
            p.add_argument("--include-remodelling", action="store_true")
        if name == "sweep":
            p.add_argument("--alphas", default="500,1000,1500")
            p.add_argument("--remodelling-alphas", default=None)
            p.add_argument("--log-axes", action="store_true")
        if name == "tune":
            p.add_argument("--resolution", type=int, default=150)
            p.add_argument("--smoothing-sigma", type=float, default=1.0)
    return parser


def main(argv=None):
    args = vars(build_parser().parse_args(argv))
    fn = EXPERIMENTS[args.pop("experiment")]
    kwargs = {k.replace("-", "_"): v for k, v in args.items()}
    profile_dir = kwargs.pop("profile", None)
    kwargs["device"] = resolve_device(kwargs["device"])
    if profile_dir:
        from opticalflow_tpu_torch.utils.observability import profile_trace, span_statistics

        with profile_trace(profile_dir):
            out = fn(**kwargs)
        print(f"profiler trace written to {profile_dir}")
        print("span statistics:", span_statistics())
        return out
    return fn(**kwargs)


if __name__ == "__main__":
    main()
