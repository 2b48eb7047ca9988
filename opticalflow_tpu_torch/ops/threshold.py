"""Adaptive thresholding.

Counterpart of ``opticalflow_tpu.ops.threshold``: rescale the movie to the
uint8 range, then binarise each pixel against the mean of its
``window_size`` neighbourhood minus ``threshold`` (cv2
ADAPTIVE_THRESH_MEAN_C / THRESH_BINARY semantics, replicated borders).
Returns a boolean movie, as the reference does.
"""

from __future__ import annotations

import torch

from opticalflow_tpu_torch.ops.boxsum import replicate_pad
from opticalflow_tpu_torch.utils.device import resolve_device


def _local_mean_replicate(x: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed mean over the last two axes with replicated (cv2
    BORDER_REPLICATE) borders."""
    pad = window // 2
    out = replicate_pad(x, pad, -2).unfold(-2, window, 1).sum(-1)
    out = replicate_pad(out, pad, -1).unfold(-1, window, 1).sum(-1)
    return out / float(window * window)


def apply_adaptive_threshold(movie, window_size: int = 51, threshold: float = 0.0,
                             device=None) -> torch.Tensor:
    """Boolean mask movie via the mean-C adaptive threshold, computed on
    ``device`` (``None``: the CUDA device, which must exist; ``'cpu'``: the
    CPU) in the movie's floating dtype (float32 for integer input); returns
    a bool tensor there."""
    movie = torch.as_tensor(movie).to(resolve_device(device))
    if not movie.is_floating_point():
        movie = movie.to(torch.float32)
    # uint8 as the reference converts: scale by the global max, then
    # truncate toward zero
    as_uint8 = (movie / movie.max() * 255.0).to(torch.uint8).to(movie.dtype)
    # cv2 rounds the mean of the uint8 image (half to even, as torch.round
    # and jnp.round) and compares src > mean - C
    thresh = torch.round(_local_mean_replicate(as_uint8, int(window_size))) - float(threshold)
    return as_uint8 > thresh
