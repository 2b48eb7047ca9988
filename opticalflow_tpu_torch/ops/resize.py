"""Area resize (downsampling).

Counterpart of ``opticalflow_tpu.ops.resize``: the reference shrinks large
movies with ``cv2.resize(..., interpolation=cv2.INTER_AREA)``.  INTER_AREA
is pixel-area-weighted averaging (exact average pooling for an integer
factor), here two separable 1-D resamples: host numpy weight matrices
applied with ``torch.matmul`` in full float32 (no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflow_tpu_torch.solve.krylov import full_f32_precision
from opticalflow_tpu_torch.utils.device import resolve_device


def _area_weights(n_in: int, n_out: int, scale=None) -> np.ndarray:
    """(n_out, n_in) row-stochastic area-overlap matrix for 1-D resize.

    ``scale`` defaults to n_in/n_out; cv2's fx/fy call path instead uses
    the reciprocal factor directly (windows of width 1/f clipped at the
    edge), which matters for fractional factors — pass it explicitly for
    that semantic."""
    if scale is None:
        scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for o in range(n_out):
        start = o * scale
        end = min((o + 1) * scale, n_in)
        i0 = int(np.floor(start))
        i1 = int(np.ceil(end))
        for i in range(i0, min(i1, n_in)):
            overlap = min(end, i + 1) - max(start, i)
            if overlap > 0:
                w[o, i] = overlap
        w[o] /= w[o].sum()
    return w


def area_resize_movie(movie, out_x: int, out_y: int, scale_x=None, scale_y=None, device=None):
    """Resize every frame of a (T, X, Y) movie to (out_x, out_y) with
    area-weighted averaging (cv2 INTER_AREA semantics for shrinking), on
    ``device`` (``None``: the CUDA device, which must exist; ``'cpu'``: the
    CPU); returns a tensor there, float32 for integer input."""
    movie = torch.as_tensor(movie).to(resolve_device(device))
    if not movie.is_floating_point():
        movie = movie.to(torch.float32)
    if out_x > movie.shape[1] or out_y > movie.shape[2]:
        raise ValueError("area_resize_movie only supports downsampling")
    wx = torch.as_tensor(_area_weights(movie.shape[1], out_x, scale_x)).to(movie)
    wy = torch.as_tensor(_area_weights(movie.shape[2], out_y, scale_y)).to(movie)
    with full_f32_precision():
        # (T, X, Y) -> (T, out_x, Y) -> (T, out_x, out_y)
        return torch.matmul(torch.matmul(wx, movie), wy.T)


def downsample_movie(movie, factor: float, device=None):
    """Shrink by a scale factor (e.g. 0.5), like the reference pipeline's
    ``cv2.resize(dsize=None, fx=f, fy=f, INTER_AREA)``."""
    shape = np.shape(movie)
    out_x = int(round(shape[1] * factor))
    out_y = int(round(shape[2] * factor))
    return area_resize_movie(movie, out_x, out_y, scale_x=1.0 / factor, scale_y=1.0 / factor,
                             device=device)
