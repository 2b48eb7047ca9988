"""Finite-difference stencils with the reference's conventions, batched.

Counterpart of ``opticalflow_tpu.core.stencils``.  Every function works on
the last two axes of a tensor, so any leading axes (frame pairs, probe
vectors) are a batch:

* a frame is indexed ``[..., i, j]`` with ``i`` along "x" and ``j`` along
  "y";
* interior derivatives consume a full ``(..., Ni, Nj)`` frame and return
  the ``(..., Ni-2, Nj-2)`` interior;
* ``DY_COMPAT`` reproduces the reference's 'dy' rule defect (it
  differentiates along axis "x"), ``DY_FIXED`` is the correct derivative.
"""

from __future__ import annotations

import torch

DY_FIXED = "fixed"
DY_COMPAT = "compat"


def ddx(m: torch.Tensor) -> torch.Tensor:
    """Central difference along the "x" axis, interior points."""
    return (m[..., 2:, 1:-1] - m[..., :-2, 1:-1]) * 0.5


def ddy(m: torch.Tensor, mode: str = DY_FIXED) -> torch.Tensor:
    """Central difference along the "y" axis, interior points
    (``mode=DY_COMPAT``: the reference defect, a copy of :func:`ddx`)."""
    if mode == DY_COMPAT:
        return ddx(m)
    return (m[..., 1:-1, 2:] - m[..., 1:-1, :-2]) * 0.5


def ddxx(m: torch.Tensor) -> torch.Tensor:
    """Second difference along "x" (unit spacing), interior points."""
    return m[..., 2:, 1:-1] + m[..., :-2, 1:-1] - 2.0 * m[..., 1:-1, 1:-1]


def ddyy(m: torch.Tensor) -> torch.Tensor:
    """Second difference along "y" (unit spacing), interior points."""
    return m[..., 1:-1, 2:] + m[..., 1:-1, :-2] - 2.0 * m[..., 1:-1, 1:-1]


def ddxy(m: torch.Tensor) -> torch.Tensor:
    """Mixed second difference, interior points."""
    return (m[..., 2:, 2:] - m[..., 2:, :-2] - m[..., :-2, 2:] + m[..., :-2, :-2]) * 0.25


def mirror_edges(image: torch.Tensor) -> torch.Tensor:
    """Mirror (zero-gradient) boundary fill of the last two axes, with the
    reference's corner semantics: rows first, then columns overwrite.
    Returns a new tensor."""
    image = image.clone()
    image[..., 0, :] = image[..., 2, :]
    image[..., -1, :] = image[..., -3, :]
    image[..., :, 0] = image[..., :, 2]
    image[..., :, -1] = image[..., :, -3]
    return image
