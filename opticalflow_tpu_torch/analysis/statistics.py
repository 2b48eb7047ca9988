"""Flow-field statistics and cross-channel / cross-method comparison.

Counterpart of ``opticalflow_tpu.analysis.statistics``: numpy on flow
results (angles to the y axis, angles between two channels' fields with
speed-product weights, paired speeds, error statistics against a known
velocity, endpoint error), and the illumination-change correction, whose
blurs run on a device through ``ops.blur``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.utils.device import resolve_device


def velocity_angles(flow_result) -> np.ndarray:
    """Signed angle of each velocity vector to the y axis
    (arccos(v_y/speed) * sign(v_x))."""
    v_x = np.asarray(flow_result["v_x"])
    v_y = np.asarray(flow_result["v_y"])
    speed = np.asarray(flow_result["speed"])
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.arccos(v_y / speed) * np.sign(v_x)


def angles_between(flow_a, flow_b) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel angle between two flow fields and the speed-product
    weights of the reference's weighted histogram."""
    dot = (
        np.asarray(flow_a["v_x"]) * np.asarray(flow_b["v_x"])
        + np.asarray(flow_a["v_y"]) * np.asarray(flow_b["v_y"])
    )
    speeds = np.asarray(flow_a["speed"]) * np.asarray(flow_b["speed"])
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arccos(dot / speeds)
    return theta, speeds


def speed_pairs(flow_a, flow_b, threshold: float = 0.01) -> Tuple[np.ndarray, np.ndarray]:
    """Paired speeds where channel b moves faster than ``threshold``, both
    finite (the inputs of the reference's speed-correlation histogram)."""
    a = np.asarray(flow_a["speed"])
    b = np.asarray(flow_b["speed"])
    mask = (b > threshold) & np.isfinite(a) & np.isfinite(b)
    return a[mask].ravel(), b[mask].ravel()


def ground_truth_error_statistics(flow_result, true_v_x: float, true_v_y: float,
                                  mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Error statistics against a known uniform velocity (infinite
    velocities count as 0, NaNs are skipped)."""
    v_x = np.array(flow_result["v_x"], dtype=float, copy=True)
    v_y = np.array(flow_result["v_y"], dtype=float, copy=True)
    v_x[np.isinf(v_x)] = 0.0
    v_y[np.isinf(v_y)] = 0.0
    if mask is not None:
        v_x = v_x[mask]
        v_y = v_y[mask]
    return {
        "mean_v_x": float(np.nanmean(v_x)),
        "mean_v_y": float(np.nanmean(v_y)),
        "median_v_x": float(np.nanmedian(v_x)),
        "median_v_y": float(np.nanmedian(v_y)),
        "bias_v_x": float(np.nanmean(v_x) - true_v_x),
        "bias_v_y": float(np.nanmean(v_y) - true_v_y),
        "rmse": float(
            np.sqrt(np.nanmean((v_x - true_v_x) ** 2 + (v_y - true_v_y) ** 2))
        ),
        "epe_mean": float(
            np.nanmean(np.sqrt((v_x - true_v_x) ** 2 + (v_y - true_v_y) ** 2))
        ),
    }


def endpoint_error(flow_a, flow_b) -> Dict[str, float]:
    """EPE statistics between two flow results."""
    d_x = np.asarray(flow_a["v_x"]) - np.asarray(flow_b["v_x"])
    d_y = np.asarray(flow_a["v_y"]) - np.asarray(flow_b["v_y"])
    epe = np.sqrt(d_x**2 + d_y**2)
    return {
        "epe_mean": float(np.nanmean(epe)),
        "epe_max": float(np.nanmax(epe)),
        "epe_median": float(np.nanmedian(epe)),
    }


def correct_intensity_change(movie, smoothing_sigma: float = 3.0,
                             correction_sigma: float = 5.0, device=None) -> np.ndarray:
    """Global illumination-change correction: subtract the
    ``correction_sigma``-blurred inter-frame difference from each frame, so
    slow global intensity drift does not pass for flow or remodelling.
    The blurs run on ``device`` (``None``: the CUDA device, which must
    exist; ``'cpu'``: the CPU) in the movie's floating dtype (float32 for
    integer input); returns a host array."""
    movie = torch.as_tensor(movie).to(resolve_device(device))
    blurred = blur_movie(movie, smoothing_sigma=smoothing_sigma)
    corrected = [blurred[0]]
    for k in range(1, blurred.shape[0]):
        difference = blurred[k] - corrected[k - 1]
        corrected.append(blurred[k] - blur_movie(difference[None], correction_sigma)[0])
    return torch.stack(corrected).cpu().numpy()
