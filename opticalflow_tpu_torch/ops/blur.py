"""Gaussian blur of a movie.

Counterpart of ``opticalflow_tpu.ops.blur``: the sampled Gaussian that
``scipy.ndimage.gaussian_filter(mode='nearest', truncate=4.0)`` uses, as a
separable correlation with edge-replicate padding over a ``(T, X, Y)``
stack.  Each pass is a sum of shifted slices times the taps: plain float
multiply-adds, so no convolution library and no TF32 path is involved.
``blur_movie`` takes an array or a tensor: a tensor is blurred where it
lies, an array on ``device`` (``None``: the card, by the entry points'
device rule); ``blur_frame`` blurs one ``(X, Y)`` frame the same way;
``blur_to_host`` takes an array or tensor, blurs it on a device and
returns a host array (for the host-side modules: interop, Farneback, the
drivers).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.utils.device import resolve_device


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


def blur_movie(movie, smoothing_sigma: float, truncate: float = 4.0,
               device=None) -> torch.Tensor:
    """Gaussian-blur every frame of a ``(T, X, Y)`` movie, an array or a
    tensor.  A tensor stays where it lies; an array goes to ``device``
    (``None``: the CUDA device, which must exist; ``'cpu'``: the CPU).
    Integer movies are blurred in float32, as in the JAX package."""
    if not isinstance(movie, torch.Tensor):
        movie = torch.as_tensor(np.asarray(movie)).to(resolve_device(device))
    if not movie.is_floating_point():
        movie = movie.to(torch.float32)
    taps = gaussian_kernel_1d(smoothing_sigma, truncate)
    out = _correlate_last_axis(movie.transpose(-1, -2), taps).transpose(-1, -2)
    return _correlate_last_axis(out, taps).contiguous()


def blur_frame(frame, smoothing_sigma: float, truncate: float = 4.0,
               device=None) -> torch.Tensor:
    """Gaussian-blur one ``(X, Y)`` frame, an array or a tensor, as
    :func:`blur_movie` does."""
    return blur_movie(frame[None, :, :], smoothing_sigma, truncate, device)[0]


def blur_to_host(movie, smoothing_sigma: float, device=None) -> np.ndarray:
    """Gaussian-blur a ``(T, X, Y)`` array or tensor on ``device`` (``None``:
    the CUDA device, which must exist; ``'cpu'``: the CPU) and return the
    result as a host array."""
    movie = torch.as_tensor(movie).to(resolve_device(device))
    return blur_movie(movie, smoothing_sigma=smoothing_sigma).cpu().numpy()
