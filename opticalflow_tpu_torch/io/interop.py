"""External-tool interop: PIVlab, Ncorr / muDIC (DIC), Liu-Shen MATLAB results.

Counterpart of ``opticalflow_tpu.io.interop``: .mat parsing and scipy
griddata on the host, converting external results into the ``FlowResult``
contract.  The blurs and the adaptive threshold run through the port's
``ops.blur`` and ``ops.threshold`` on ``device`` (``None``: the CUDA
device, which must exist; ``'cpu'``: the CPU), in the movie's floating
dtype; their results come back to the host, since these functions write
into numpy arrays in place.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.ops.blur import blur_movie, blur_to_host
from opticalflow_tpu_torch.utils.device import resolve_device


def load_mat(path: str) -> dict:
    """Load a MATLAB file, handling both classic (<=v7.2, scipy) and v7.3
    (HDF5) files; mat73 is optional and only needed for the latter."""
    import scipy.io

    try:
        return scipy.io.loadmat(path)
    except NotImplementedError:
        try:
            import mat73
        except ImportError as err:
            raise ImportError(
                f"{path} is a MATLAB v7.3 file; the mat73 package is required"
            ) from err
        return mat73.loadmat(path)


def _unwrap_cells(cell_array) -> np.ndarray:
    """PIVlab stores per-frame grids as object (cell) arrays; stack them."""
    n = len(cell_array)
    first = cell_array[0][0]
    out = np.zeros((n, first.shape[0], first.shape[1]))
    for k in range(n):
        out[k] = cell_array[k][0]
    return out


def convert_PIV_result(PIV_result, movie, delta_x: float = 1.0, delta_t: float = 1.0) -> FlowResult:
    """PIVlab .mat dict -> FlowResult with velocities cubic-upsampled to the
    pixel grid."""
    import scipy.interpolate

    movie = np.asarray(movie)
    x_loc = _unwrap_cells(PIV_result["x"] * delta_x)
    y_loc = _unwrap_cells(PIV_result["y"] * delta_x)
    v_x = _unwrap_cells(PIV_result["u_original"] * delta_x / delta_t)
    v_y = _unwrap_cells(PIV_result["v_original"] * delta_x / delta_t)

    X, Y = np.meshgrid(np.arange(movie.shape[1]), np.arange(movie.shape[2]))
    n_pairs = movie.shape[0] - 1
    vx_up = np.zeros((n_pairs, movie.shape[1], movie.shape[2]))
    vy_up = np.zeros_like(vx_up)
    for k in range(n_pairs):
        ok = np.logical_and(~np.isnan(v_x[k]), ~np.isnan(v_y[k]))
        points = (x_loc[k][ok].ravel(), y_loc[k][ok].ravel())
        vx_up[k] = scipy.interpolate.griddata(points, v_x[k][ok].ravel(), (X, Y), method="cubic")
        vy_up[k] = scipy.interpolate.griddata(points, v_y[k][ok].ravel(), (X, Y), method="cubic")

    result = FlowResult(
        v_x=vx_up,
        v_y=vy_up,
        speed=np.sqrt(vx_up**2 + vy_up**2),
        original_data=movie,
        delta_x=delta_x,
        delta_t=delta_t,
    )
    result["x_locations"] = x_loc
    result["y_locations"] = y_loc
    result["PIV_v_x"] = v_x
    result["PIV_v_y"] = v_y
    return result


def filter_PIV_flow_result(flow_result, intensity_threshold: float = 10,
                           speed_threshold: float = 7, device=None) -> None:
    """Zero out velocities at dim pixels / unrealistic speeds, in place (the
    reference hard-codes 7 for the speed cut whatever the argument; here,
    as in the JAX package, the argument is honoured)."""
    blurred = blur_to_host(flow_result["original_data"], 3, device)
    dim = blurred[:-1] < intensity_threshold
    flow_result["v_x"][dim] = 0.0
    flow_result["v_y"][dim] = 0.0
    fast = flow_result["speed"] > speed_threshold
    flow_result["v_x"][fast] = 0.0
    flow_result["v_y"][fast] = 0.0
    flow_result["speed"][fast] = 0.0


def threshold_PIV_vectors(x_locations, y_locations, v_x, v_y, speed, raw_movie,
                          delta_x: float, speed_band=(0.01, 0.08),
                          window_size: int = 151, threshold: float = -5, device=None) -> None:
    """Zero PIV vectors over background (inverse adaptive-threshold mask of
    the sigma-3 blurred movie) or outside a plausible speed band, in place."""
    from opticalflow_tpu_torch.ops.threshold import apply_adaptive_threshold

    blurred = blur_movie(torch.as_tensor(raw_movie).to(resolve_device(device)), 3.0)
    masks = np.logical_not(
        apply_adaptive_threshold(blurred, window_size=window_size, threshold=threshold,
                                 device=blurred.device).cpu().numpy()
    )
    for k in range(x_locations.shape[0]):
        xi = np.int64(x_locations[k] / delta_x)
        yi = np.int64(y_locations[k] / delta_x)
        # the reference indexes the mask [y, x] here
        background = masks[k, yi, xi]
        out_of_band = (speed[k] < speed_band[0]) | (speed[k] > speed_band[1])
        kill = background | out_of_band
        v_x[k][kill] = 0.0
        v_y[k][kill] = 0.0
        speed[k][kill] = 0.0


def convert_mudic_result(displacement_field, coordinates,
                         delta_x: float = 1.0, delta_t: float = 1.0) -> dict:
    """muDIC (digital image correlation) fields -> velocity / coordinate
    arrays in physical units.  ``displacement_field`` / ``coordinates`` are
    muDIC ``Fields.disp()`` / ``Fields.coords()`` arrays of shape (1, 2,
    n_elx, n_ely, n_frames); muDIC itself is not needed."""
    displacement_field = np.asarray(displacement_field)
    coordinates = np.asarray(coordinates)
    n_frames = displacement_field.shape[-1]
    scale = delta_x / delta_t
    v_x = np.moveaxis(displacement_field[0, 0], -1, 0) * scale
    v_y = np.moveaxis(displacement_field[0, 1], -1, 0) * scale
    x_coords = np.moveaxis(coordinates[0, 0], -1, 0) * delta_x
    y_coords = np.moveaxis(coordinates[0, 1], -1, 0) * delta_x
    return {
        "v_x": v_x,
        "v_y": v_y,
        "speed": np.sqrt(v_x**2 + v_y**2),
        "x_coords": x_coords,
        "y_coords": y_coords,
        "x_start_coords": coordinates[0, 0, :, :, 0] * delta_x,
        "y_start_coords": coordinates[0, 1, :, :, 0] * delta_x,
        "n_frames": n_frames,
        "delta_x": delta_x,
        "delta_t": delta_t,
    }


def convert_ncorr_result(ncorr_result, delta_x: float = 1.0, delta_t: float = 1.0,
                         corrcoef_threshold: float = 0.3):
    """Ncorr (digital image correlation) .mat -> (v_x, v_y) with
    low-correlation vectors zeroed."""
    displacements = ncorr_result["data_dic_save"]["displacements"]
    first = np.asarray(displacements[0]["plot_u_dic"])
    n = len(displacements)
    v_x = np.zeros((n,) + first.shape)
    v_y = np.zeros_like(v_x)
    scale = delta_x / delta_t
    for k, disp in enumerate(displacements):
        cc = np.asarray(disp["plot_corrcoef_dic"])
        vx = np.asarray(disp["plot_u_dic"]) * scale
        vy = np.asarray(disp["plot_v_dic"]) * scale
        vx[cc < corrcoef_threshold] = 0.0
        vy[cc < corrcoef_threshold] = 0.0
        v_x[k] = vx
        v_y[k] = vy
    return v_x, v_y


def convert_liu_result(liu_result, movie_shape=None, delta_x: float = 1.0,
                       delta_t: float = 1.0) -> FlowResult:
    """Liu-Shen MATLAB ``.mat`` result -> FlowResult: single-pair pixel
    displacements under ``'ux'`` / ``'uy'``, or per-frame cell arrays under
    ``'u_original'`` / ``'v_original'`` (PIVlab-style exports), scaled by
    ``delta_x / delta_t``.  ``movie_shape``: optional ``(frames, X, Y)`` of
    the source movie, checked against the field shape."""
    scale = delta_x / delta_t
    if "ux" in liu_result:
        v_x = np.asarray(liu_result["ux"], dtype=float)[None] * scale
        v_y = np.asarray(liu_result["uy"], dtype=float)[None] * scale
    elif "u_original" in liu_result:
        v_x = _unwrap_cells(liu_result["u_original"]) * scale
        v_y = _unwrap_cells(liu_result["v_original"]) * scale
    else:
        raise KeyError(
            "Liu-Shen result needs 'ux'/'uy' (single pair) or "
            "'u_original'/'v_original' (per-frame cells); got keys "
            f"{sorted(k for k in liu_result if not k.startswith('__'))}"
        )
    if movie_shape is not None and tuple(v_x.shape[1:]) != tuple(movie_shape[1:]):
        raise ValueError(
            f"Liu-Shen field shape {v_x.shape[1:]} does not match movie "
            f"frames {tuple(movie_shape[1:])}"
        )
    return FlowResult(
        v_x=v_x,
        v_y=v_y,
        speed=np.sqrt(v_x**2 + v_y**2),
        delta_x=delta_x,
        delta_t=delta_t,
    )
