"""Box-method optical flow (Vig et al. Biophysical Journal 2016).

Counterpart of ``opticalflow_tpu.flow.boxflow``: the box sums are
separable windowed sums (ops.boxsum) and the per-pixel 2x2 / 3x3 normal
equations are closed-form arithmetic on whole planes, batched over every
frame pair of the movie at once.

Deviations from the reference kept from the JAX package:
* speed is sqrt(v_x^2 + v_y^2) in the remodelling branch too (the
  reference leaves it zero there);
* the window is clipped with the right axis length on both axes (the
  reference clamps the y-window with the x length, right only for square
  images).

Quirks of the reference reproduced: the nominal ``box_size**2`` pixel count
in the 3x3 branch even where the window is clipped; NaN where its
determinant is 0; the unguarded division of the 2x2 branch (inf or NaN
where its determinant is 0); an even box size sums the ``box_size + 1``
window.
"""

from __future__ import annotations

from typing import Optional

import torch

from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.ops.boxsum import box_sum
from opticalflow_tpu_torch.utils.device import resolve_device


def _pair_gradients(prev: torch.Tensor, cur: torch.Tensor):
    """Frame-pair-averaged central-difference gradients of (..., X, Y)
    frames, zero on the border ring."""
    dIdx = torch.zeros_like(prev)
    dIdy = torch.zeros_like(prev)
    dIdx[..., 1:-1, 1:-1] = (cur[..., 2:, 1:-1] + prev[..., 2:, 1:-1]
                             - cur[..., :-2, 1:-1] - prev[..., :-2, 1:-1]) * 0.25
    dIdy[..., 1:-1, 1:-1] = (cur[..., 1:-1, 2:] + prev[..., 1:-1, 2:]
                             - cur[..., 1:-1, :-2] - prev[..., 1:-1, :-2]) * 0.25
    return dIdx, dIdy


def _products(prev, cur):
    """The five products the 2x2 branch sums, stacked along axis -3:
    (dI dIdx, dI dIdy, dIdx^2, dIdx dIdy, dIdy^2)."""
    dIdx, dIdy = _pair_gradients(prev, cur)
    delta_I = cur - prev
    return torch.stack([delta_I * dIdx, delta_I * dIdy, dIdx * dIdx, dIdx * dIdy, dIdy * dIdy],
                       dim=-3)


def _flow_2x2(sums):
    """(v_x, v_y) of the 2x2 normal equations from the box sums of
    :func:`_products` along axis -3 (unguarded division, as the
    reference)."""
    sum1, sum2, A, B, C = sums.unbind(-3)
    det = A * C - B * B
    return (-C * sum1 + B * sum2) / det, (-A * sum2 + B * sum1) / det


def _box_flow_pair(prev, cur, box_size: int, include_remodelling: bool):
    """(v_x, v_y, speed, gamma) of a batch of (..., X, Y) frame pairs, pixel
    units; all box sums of a branch in one batched call."""
    if not include_remodelling:
        v_x, v_y = _flow_2x2(box_sum(_products(prev, cur), box_size))
        gamma = torch.zeros_like(v_x)
    else:
        dIdx, dIdy = _pair_gradients(prev, cur)
        delta_I = cur - prev
        # coefficient names follow the reference's 3x3 closed form
        sum1, sum2, A, B, C, D, E, sum3 = box_sum(torch.stack(
            [delta_I * dIdx, delta_I * dIdy, dIdx * dIdx, dIdx * dIdy, dIdx, dIdy * dIdy,
             dIdy, delta_I]), box_size)
        # the reference's nominal box pixel count, even at clipped windows
        n = float(box_size * box_size)
        det = n * A * D - A * E * E - n * B * B - C * C * D + 2.0 * B * C * E
        safe = det != 0.0
        det_safe = torch.where(safe, det, torch.ones_like(det))
        v_x = ((E * E - n * D) * sum1 + (n * B - C * E) * sum2 + (C * D - B * E) * sum3) / det_safe
        v_y = ((n * B - C * E) * sum1 + (C * C - n * A) * sum2 + (A * E - B * C) * sum3) / det_safe
        gamma = -((B * E - C * D) * sum1 + (B * C - A * E) * sum2
                  + (A * D - B * B) * sum3) / det_safe
        nan = torch.full_like(v_x, float("nan"))
        v_x = torch.where(safe, v_x, nan)
        v_y = torch.where(safe, v_y, nan)
        gamma = torch.where(safe, gamma, nan)

    speed = torch.sqrt(v_x * v_x + v_y * v_y)
    return v_x, v_y, speed, gamma


def box_flow(movie: torch.Tensor, box_size: int, delta_x: float, delta_t: float,
             include_remodelling: bool = False):
    """Box-method flow on every consecutive frame pair of a (T, X, Y) movie
    tensor, where it lies; returns (v_x, v_y, speed, remodelling), each
    (T-1, X, Y), in physical units (delta_x / delta_t applied)."""
    v_x, v_y, speed, gamma = _box_flow_pair(movie[:-1], movie[1:], box_size,
                                            include_remodelling)
    scale = delta_x / delta_t
    return v_x * scale, v_y * scale, speed * scale, gamma


def conduct_optical_flow(
    movie,
    boxsize: int = 15,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    smoothing_sigma: Optional[float] = None,
    background: Optional[float] = None,
    include_remodelling: bool = False,
    dtype=torch.float32,
    device=None,
) -> FlowResult:
    """Same arguments and result as the JAX package's
    ``conduct_optical_flow``, plus ``device`` (``None``: the CUDA device,
    which must exist; ``'cpu'``: the CPU): optional background subtraction
    (a sigma-10 blur as the mask), optional Gaussian smoothing, then the
    box method.  Returns host arrays."""
    movie = torch.as_tensor(movie).to(device=resolve_device(device), dtype=dtype)

    if background is not None:
        # threshold on a sigma=10 blur, subtract the background level
        mask_movie = blur_movie(movie, smoothing_sigma=10)
        movie_to_analyse = torch.where(mask_movie > background, movie - background,
                                       torch.zeros_like(movie))
    else:
        movie_to_analyse = movie

    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie_to_analyse, smoothing_sigma=smoothing_sigma)

    v_x, v_y, speed, gamma = box_flow(movie_to_analyse, int(boxsize), float(delta_x),
                                      float(delta_t), include_remodelling)

    result = FlowResult(
        v_x=v_x.cpu().numpy(),
        v_y=v_y.cpu().numpy(),
        speed=speed.cpu().numpy(),
        original_data=movie.cpu().numpy(),
        blurred_data=movie_to_analyse.cpu().numpy(),
        delta_x=delta_x,
        delta_t=delta_t,
    )
    if include_remodelling:
        result["net_remodelling"] = gamma.cpu().numpy()
    return result
