"""Boundary-clipped box sums (uniform filters).

Counterpart of ``opticalflow_tpu.ops.boxsum``.  The reference's box-method
kernel sums image products over a ``box_size`` neighbourhood clipped at the
image boundary.  Here that is a separable windowed sum over the last two
axes with zero padding, which gives the clipped sums exactly: each output
is a short sum of the window's values, never a difference of prefix sums
(a cumsum formulation loses ~2% in low-signal regions in float32, as the
JAX package's docstring records).  Plain float adds, so no convolution
library and no TF32 path is involved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def effective_window(box_size: int) -> int:
    """The reference clips the window to ``[i - b//2, i + b//2]`` inclusive,
    which spans ``b`` pixels for odd ``b`` and ``b + 1`` for even ``b``."""
    half = box_size // 2
    return 2 * half + 1


def box_sum(x: torch.Tensor, box_size: int) -> torch.Tensor:
    """Sum of ``x`` over the clipped box window centred at every pixel of
    its last two axes (any leading axes are a batch)."""
    win = effective_window(box_size)
    pad = win // 2
    out = F.pad(x, (0, 0, pad, pad)).unfold(-2, win, 1).sum(-1)
    return F.pad(out, (pad, pad)).unfold(-1, win, 1).sum(-1)


def replicate_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """``x`` extended by ``pad`` copies of its edge values at both ends of
    axis ``dim`` (edge replication, for any number of axes)."""
    n = x.shape[dim]
    index = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, index)


def correlate_valid(padded: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = sum_k taps[..., k] * padded[..., j + k]`` over the
    last axis, for the ``len - width + 1`` positions where the window fits;
    ``taps`` (..., width) broadcasts against ``padded``'s leading axes
    (its leading shape, then the two image axes)."""
    width = taps.shape[-1]
    n = padded.shape[-1] - width + 1
    shape = taps.shape[:-1] + (1, 1)
    out = taps[..., 0].reshape(shape) * padded[..., 0:n]
    for k in range(1, width):
        out = out + taps[..., k].reshape(shape) * padded[..., k : k + n]
    return out


def box_sum_dynamic(x: torch.Tensor, half, max_half: int) -> torch.Tensor:
    """Boundary-clipped box sums for a batch of half-widths.

    ``half``: an int or an integer tensor of half-widths, each at most
    ``max_half``, whose shape broadcasts against ``x``'s leading axes
    (``x`` (..., X, Y)); returns ``box_sum(x, 2 * half + 1)`` for every
    half-width, of shape ``broadcast(x.shape[:-2], half.shape) + (X, Y)``.
    A separable correlation with a static-length 0/1 kernel whose active
    taps are ``|offset| <= half``: each output is a windowed sum, so a whole
    box-size sweep is one batched computation.
    """
    half = torch.as_tensor(half, device=x.device)
    offsets = torch.arange(-max_half, max_half + 1, device=x.device)
    taps = (offsets.abs() <= half[..., None]).to(x.dtype)
    pad = (max_half, max_half)
    out = correlate_valid(F.pad(x.transpose(-1, -2), pad), taps).transpose(-1, -2)
    return correlate_valid(F.pad(out, pad), taps)
