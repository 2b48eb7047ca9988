"""Composed end-to-end analysis workflows.

Counterpart of ``opticalflow_tpu.analysis.workflows``: the reference's
multi-step recipes composed from the port's primitives (flow solves,
interop loaders, statistics, plots):

* the dual-channel (Rho + actin) comparison: flows of both channels, the
  joint overlay movie, joint speed / angle histograms, angle-between
  histograms, the speed correlation;
* the PIV-vs-flow comparison: PIVlab vectors upsampled to the pixel grid
  and thresholded, the side-by-side movie, speed correlation and angle
  histograms;
* the hand-clicked ground-truth validation: displacement endpoints against
  the inferred flow, relative errors, the validation quiver figure.

Every workflow caches its flows in a :class:`utils.cache.ResultCache` under
the JAX package's keys (movie content + parameters, not the device), so an
interrupted run resumes without solving again, and wraps its phases in
:func:`utils.observability.span` under the JAX package's names.  The flows
run on ``device`` (``None``: the CUDA device, which must exist; ``'cpu'``:
the CPU); the plots run on the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.utils.cache import ResultCache
from opticalflow_tpu_torch.utils.observability import span, span_statistics


def _compute_flow(movie, method: str, *, boxsize=31, smoothing_sigma=None,
                  delta_x=1.0, delta_t=1.0, speed_alpha=1000.0,
                  remodelling_alpha=1000.0, device=None, **extra) -> FlowResult:
    """Dispatch to one of the port's flow methods by name."""
    if method == "box":
        from opticalflow_tpu_torch.flow.boxflow import conduct_optical_flow

        return conduct_optical_flow(
            movie, boxsize=boxsize, delta_x=delta_x, delta_t=delta_t,
            smoothing_sigma=smoothing_sigma, device=device, **extra,
        )
    if method == "variational":
        from opticalflow_tpu_torch.flow.variational import variational_optical_flow

        return variational_optical_flow(
            movie, delta_x=delta_x, delta_t=delta_t, speed_alpha=speed_alpha,
            remodelling_alpha=remodelling_alpha, smoothing_sigma=smoothing_sigma,
            device=device, **extra,
        )
    if method == "farneback":
        from opticalflow_tpu_torch.flow.farneback import conduct_opencv_flow

        return conduct_opencv_flow(
            movie, delta_x=delta_x, delta_t=delta_t,
            smoothing_sigma=smoothing_sigma, device=device, **extra,
        )
    raise ValueError(f"unknown flow method {method!r}")


def run_dual_channel_comparison(
    movie_a,
    movie_b,
    output_dir: str,
    label_a: str = "Actin",
    label_b: str = "Rho",
    method: str = "box",
    boxsize: int = 31,
    smoothing_sigma: Optional[float] = 3.0,
    delta_x: float = 0.0913,
    delta_t: float = 10.0,
    arrow_boxsize: int = 15,
    cache_dir: Optional[str] = None,
    device=None,
    **flow_kwargs,
) -> Dict[str, FlowResult]:
    """Dual-channel workflow: flow on both channels, joint overlay movie,
    per-channel velocity movies, joint speed / angle histogram figure,
    angle-between histograms (plain + speed-weighted) and the cross-channel
    speed correlation."""
    os.makedirs(output_dir, exist_ok=True)
    cache = ResultCache(cache_dir or os.path.join(output_dir, "cache"))
    results = {}
    for label, movie in ((label_a, movie_a), (label_b, movie_b)):
        with span(f"flow:{label}"):
            results[label] = cache.get_or_compute(
                movie,
                lambda movie=movie: _compute_flow(
                    movie, method, boxsize=boxsize, smoothing_sigma=smoothing_sigma,
                    delta_x=delta_x, delta_t=delta_t, device=device, **flow_kwargs,
                ),
                method=method, boxsize=boxsize, smoothing_sigma=smoothing_sigma,
                delta_x=delta_x, delta_t=delta_t,
            )
            results[label].save(
                os.path.join(output_dir, f"{label.lower()}_flow_result.npy"))

    flow_a, flow_b = results[label_a], results[label_b]
    from opticalflow_tpu_torch.viz import plots

    with span("viz:dual-channel"):
        plots.make_two_channel_overlay_movie(
            flow_a, flow_b, os.path.join(output_dir, "joint_overlay.mp4"),
            label_a=label_a, label_b=label_b, arrow_boxsize=arrow_boxsize,
        )
        for label, res in results.items():
            plots.make_velocity_overlay_movie(
                res, os.path.join(output_dir, f"{label.lower()}_velocities.mp4"),
                arrow_boxsize=arrow_boxsize,
            )
        plots.plot_joint_speed_and_angle_histograms(
            flow_a, flow_b, os.path.join(output_dir, "joint_speed_histograms.pdf"),
            label_a=label_a, label_b=label_b,
        )
        plots.plot_angle_between_histogram(
            flow_a, flow_b, os.path.join(output_dir, "angle_value_histograms.pdf"))
        plots.plot_angle_between_histogram(
            flow_a, flow_b,
            os.path.join(output_dir, "weighted_angle_value_histograms.pdf"),
            weighted=True,
        )
        plots.plot_speed_correlation(
            flow_a, flow_b, os.path.join(output_dir, "speed_correlation.png"),
            label_a=f"{label_a} speed [µm/s]", label_b=f"{label_b} speed [µm/s]",
        )
    print("phase timings:", span_statistics())
    return results


def run_piv_comparison(
    piv_mat_path: str,
    movie,
    output_dir: str,
    method: str = "farneback",
    intensity_threshold: float = 10.0,
    arrow_boxsize: int = 15,
    cache_dir: Optional[str] = None,
    device=None,
    **flow_kwargs,
) -> Dict[str, FlowResult]:
    """PIV-vs-flow workflow: load PIVlab vectors, upsample them to the
    pixel grid, threshold, run the port's flow, and compare (side-by-side
    overlay movie, speed correlation, angle histograms)."""
    from opticalflow_tpu_torch.io.interop import (
        convert_PIV_result, filter_PIV_flow_result, load_mat)

    os.makedirs(output_dir, exist_ok=True)
    cache = ResultCache(cache_dir or os.path.join(output_dir, "cache"))
    movie = np.asarray(movie)

    with span("piv:load+upsample"):
        piv_flow = convert_PIV_result(load_mat(piv_mat_path), movie)
        filter_PIV_flow_result(piv_flow, intensity_threshold=intensity_threshold,
                               device=device)
        piv_flow.save(os.path.join(output_dir, "PIV_optical_flow_result.npy"))

    with span(f"flow:{method}"):
        own_flow = cache.get_or_compute(
            movie,
            lambda: _compute_flow(movie, method, device=device, **flow_kwargs),
            method=method, **{k: v for k, v in flow_kwargs.items()
                              if np.isscalar(v) or v is None},
        )
        own_flow.save(os.path.join(output_dir, f"{method}_flow_result.npy"))

    from opticalflow_tpu_torch.viz import plots

    with span("viz:piv-compare"):
        plots.make_two_channel_overlay_movie(
            piv_flow, own_flow, os.path.join(output_dir, "PIV_joint_flow.mp4"),
            label_a="PIV", label_b=method, arrow_boxsize=arrow_boxsize,
            shared_movie=movie,
        )
        plots.plot_speed_correlation(
            piv_flow, own_flow, os.path.join(output_dir, "PIV_speed_correlation.png"),
            label_a="PIV speed", label_b=f"{method} speed",
        )
        plots.plot_angle_between_histogram(
            piv_flow, own_flow, os.path.join(output_dir, "PIV_angle_histogram.pdf"))
        plots.plot_polar_angle_histogram(
            piv_flow, own_flow,
            os.path.join(output_dir, "PIV_polar_angle_histogram.pdf"),
            title=f"Angle PIV vs {method}",
        )
    print("phase timings:", span_statistics())
    return {"piv": piv_flow, method: own_flow}


def run_ground_truth_validation(
    movie,
    measurements_path: str,
    output_dir: str,
    method: str = "farneback",
    frame: int = 8,
    cache_dir: Optional[str] = None,
    device=None,
    **flow_kwargs,
) -> Dict[str, np.ndarray]:
    """Hand-clicked ground-truth workflow: compute the flow (delta_x =
    delta_t = 1, so the fields are displacements per frame), sample it at
    the measured start points, report relative errors and save the
    validation quiver figure."""
    from opticalflow_tpu_torch.analysis.groundtruth import (
        compare_ground_truth_displacement, load_displacement_measurements)

    os.makedirs(output_dir, exist_ok=True)
    cache = ResultCache(cache_dir or os.path.join(output_dir, "cache"))
    movie = np.asarray(movie)

    with span(f"flow:{method}"):
        flow = cache.get_or_compute(
            movie,
            lambda: _compute_flow(movie, method, delta_x=1.0, delta_t=1.0, device=device,
                                  **flow_kwargs),
            method=method, ground_truth=True,
        )

    with span("ground-truth:compare"):
        measurements = load_displacement_measurements(measurements_path)
        comparison = compare_ground_truth_displacement(flow, measurements, frame=frame)

    from opticalflow_tpu_torch.viz import plots

    with span("viz:ground-truth"):
        plots.plot_ground_truth_validation(
            flow, measurements, os.path.join(output_dir, "velocity_validation.pdf"),
            frame=frame,
        )
    np.save(os.path.join(output_dir, "ground_truth_comparison.npy"), comparison)
    print("relative errors:", comparison["relative_errors"])
    print("phase timings:", span_statistics())
    return comparison
