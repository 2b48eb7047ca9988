"""Gaussian blur of a movie.

Counterpart of ``opticalflow_tpu.ops.blur``: the sampled Gaussian that
``scipy.ndimage.gaussian_filter(mode='nearest', truncate=4.0)`` uses, as a
separable correlation with edge-replicate padding over a ``(T, X, Y)``
stack.  Each pass is a sum of shifted slices times the taps: plain float
multiply-adds, so no convolution library and no TF32 path is involved.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0, dtype=np.float64) -> np.ndarray:
    """The exact sampled-Gaussian kernel scipy.ndimage uses."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / float(sigma)) ** 2)
    phi /= phi.sum()
    return phi.astype(dtype)


def _correlate_last_axis(movie: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    radius = taps.shape[0] // 2
    n = movie.shape[-1]
    padded = F.pad(movie[:, None], (radius, radius, 0, 0), mode="replicate")[:, 0]
    out = float(taps[0]) * padded[..., 0:n]
    for k in range(1, taps.shape[0]):
        out = out + float(taps[k]) * padded[..., k : k + n]
    return out


def blur_movie(movie: torch.Tensor, smoothing_sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Gaussian-blur every frame of a ``(T, X, Y)`` movie."""
    if not movie.is_floating_point():
        movie = movie.to(torch.float32)
    taps = gaussian_kernel_1d(smoothing_sigma, truncate)
    out = _correlate_last_axis(movie.transpose(-1, -2), taps).transpose(-1, -2)
    return _correlate_last_axis(out, taps).contiguous()
