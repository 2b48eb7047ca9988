"""Hyperparameter-sensitivity sweeps of the box-method flow.

Counterpart of ``opticalflow_tpu.analysis.hyperparams``: the reference's
box-size and blur-size analyses run one full box-method flow per value, one
after another.  Here each sweep is one batched computation over its values,
as the JAX package's ``vmap`` is:

* **box-size sweep**: the box sums use :func:`ops.boxsum.box_sum_dynamic`,
  a static-length masked kernel per half-width, so every size batches;
* **blur-size sweep**: the Gaussian is sampled at a static maximum radius,
  masked to scipy's ``int(4*sigma + 0.5)`` radius and renormalised, which
  gives ``scipy.ndimage``'s weights per sigma with one shape for all, so
  every sigma batches.

Per value the sweep records what the reference's figures plot: mean speed,
speed standard deviation, and the local speed at probe locations.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from opticalflow_tpu_torch.flow.boxflow import _flow_2x2, _products
from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.ops.boxsum import (box_sum, box_sum_dynamic, correlate_valid,
                                              replicate_pad)
from opticalflow_tpu_torch.utils.device import resolve_device


def _box_flow_fields_dynamic(prev, cur, half, max_half: int):
    """Box-method (2x2 branch) velocity fields of one (X, Y) frame pair for
    a (S,) tensor of box half-widths; returns (v_x, v_y), each (S, X, Y)."""
    half = torch.as_tensor(half, device=prev.device)
    return _flow_2x2(box_sum_dynamic(_products(prev, cur), half[..., None], max_half))


def _gaussian_blur_traced(movie, sigma, max_radius: int):
    """Edge-replicate separable Gaussian blur of a (T, X, Y) movie for a
    tensor of sigmas, each giving scipy's radius ``int(4*sigma + 0.5)``
    (at most ``max_radius``); returns ``sigma.shape + movie.shape``.

    The kernel is sampled on the static ``[-max_radius, max_radius]`` grid,
    masked to each sigma's radius and renormalised: scipy.ndimage's
    weights, with one shape for every sigma.
    """
    sigma = torch.as_tensor(sigma, dtype=movie.dtype, device=movie.device)[..., None]
    x = torch.arange(-max_radius, max_radius + 1, dtype=movie.dtype, device=movie.device)
    radius = torch.floor(4.0 * sigma + 0.5)
    phi = torch.exp(-0.5 * (x / sigma) ** 2)
    phi = torch.where(x.abs() <= radius, phi, torch.zeros_like(phi))
    taps = (phi / phi.sum(-1, keepdim=True)).reshape(
        sigma.shape[:-1] + (1,) * (movie.dim() - 2) + x.shape)

    def correlate(m):  # along the last axis; the taps are symmetric, so
        # correlation and convolution agree
        return correlate_valid(replicate_pad(m, max_radius, -1), taps)

    return correlate(correlate(movie.transpose(-1, -2)).transpose(-1, -2))


def _sweep_statistics(v_x, v_y, location_indices, scale):
    """Mean speed, its (population) standard deviation and the speed at the
    probe locations, per value of a (S, X, Y) sweep."""
    speed = torch.sqrt(v_x**2 + v_y**2) * scale
    local = speed[:, location_indices[:, 0], location_indices[:, 1]]
    return speed.mean((-2, -1)), speed.std((-2, -1), correction=0), local


DEFAULT_TEST_LOCATIONS = np.array([[12.5, 7.0], [20.0, 15.0], [22.0, 19.0], [30.0, 19.0]])


def _locations_to_indices(test_locations, delta_x, shape):
    """µm probe coordinates -> pixel indices (index = coordinate /
    delta_x, rounded and clipped into the frame)."""
    idx = np.asarray(test_locations, dtype=float) / float(delta_x)
    idx = np.round(idx).astype(np.int32)
    idx[:, 0] = np.clip(idx[:, 0], 0, shape[0] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, shape[1] - 1)
    return idx


def _pair(movie, frame_index, dtype, device):
    return torch.as_tensor(movie)[frame_index : frame_index + 2].to(
        device=resolve_device(device), dtype=dtype)


def _host(mean, std, local):
    return mean.cpu().numpy(), std.cpu().numpy(), local.cpu().numpy().T  # (locations, values)


def vary_boxsize(
    movie,
    boxsizes=np.arange(5, 150, 2),
    frame_index: int = 3,
    delta_x: float = 0.0913,
    delta_t: float = 10.0,
    smoothing_sigma: Optional[float] = 1.3,
    test_locations=DEFAULT_TEST_LOCATIONS,
    filename: Optional[str] = None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, np.ndarray]:
    """Box-size sensitivity sweep on the pair ``movie[frame_index :
    frame_index + 2]``: per size the mean speed, the speed standard
    deviation and the local speeds at µm probe locations, every size in one
    batched computation on ``device`` (``None``: the CUDA device, which must
    exist; ``'cpu'``: the CPU)."""
    boxsizes = np.asarray(boxsizes, dtype=int)
    pair = _pair(movie, frame_index, dtype, device)
    if smoothing_sigma is not None:
        pair = blur_movie(pair, smoothing_sigma=smoothing_sigma)
    halves = torch.as_tensor(boxsizes // 2, device=pair.device)
    loc_idx = torch.as_tensor(_locations_to_indices(test_locations, delta_x, pair.shape[1:]),
                              device=pair.device, dtype=torch.long)
    v_x, v_y = _box_flow_fields_dynamic(pair[0], pair[1], halves, int(boxsizes.max()) // 2)
    mean, std, local = _host(*_sweep_statistics(v_x, v_y, loc_idx, delta_x / delta_t))
    out = {
        "boxsizes": boxsizes,
        "mean_speeds": mean,
        "speed_stds": std,
        "local_speeds": local,  # (n_locations, n_boxsizes)
        "test_locations": np.asarray(test_locations),
        "delta_x": delta_x,
        "delta_t": delta_t,
    }
    if filename is not None:
        np.save(filename, out)
    return out


def vary_blursize(
    movie,
    blur_sizes=np.arange(0.5, 15, 0.1),
    boxsize: int = 21,
    frame_index: int = 3,
    delta_x: float = 0.0913,
    delta_t: float = 10.0,
    test_locations=DEFAULT_TEST_LOCATIONS,
    filename: Optional[str] = None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, np.ndarray]:
    """Blur-size sensitivity sweep on the pair ``movie[frame_index :
    frame_index + 2]``, every sigma in one batched computation on
    ``device`` (``None``: the CUDA device, which must exist; ``'cpu'``: the
    CPU)."""
    blur_sizes = np.asarray(blur_sizes, dtype=float)
    pair = _pair(movie, frame_index, dtype, device)
    max_radius = int(4.0 * float(blur_sizes.max()) + 0.5)
    loc_idx = torch.as_tensor(_locations_to_indices(test_locations, delta_x, pair.shape[1:]),
                              device=pair.device, dtype=torch.long)
    blurred = _gaussian_blur_traced(pair, torch.as_tensor(blur_sizes, dtype=dtype), max_radius)
    v_x, v_y = _flow_2x2(box_sum(_products(blurred[:, 0], blurred[:, 1]), int(boxsize)))
    mean, std, local = _host(*_sweep_statistics(v_x, v_y, loc_idx, delta_x / delta_t))
    out = {
        "blur_sizes": blur_sizes,
        "boxsize": int(boxsize),
        "mean_speeds": mean,
        "speed_stds": std,
        "local_speeds": local,
        "test_locations": np.asarray(test_locations),
        "delta_x": delta_x,
        "delta_t": delta_t,
    }
    if filename is not None:
        np.save(filename, out)
    return out
