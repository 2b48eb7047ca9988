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


def bar_x(m: torch.Tensor) -> torch.Tensor:
    """Sum of the "x" neighbours, interior points."""
    return m[..., 2:, 1:-1] + m[..., :-2, 1:-1]


def bar_y(m: torch.Tensor) -> torch.Tensor:
    """Sum of the "y" neighbours, interior points."""
    return m[..., 1:-1, 2:] + m[..., 1:-1, :-2]


def bar4(m: torch.Tensor) -> torch.Tensor:
    """Sum of the 4-neighbourhood, interior points."""
    return m[..., 2:, 1:-1] + m[..., :-2, 1:-1] + m[..., 1:-1, 2:] + m[..., 1:-1, :-2]


_RULES = {
    "dx": lambda m, mode: ddx(m),
    "dy": lambda m, mode: ddy(m, mode),
    "dxx": lambda m, mode: ddxx(m),
    "dyy": lambda m, mode: ddyy(m),
    "dxy": lambda m, mode: ddxy(m),
    "dyx": lambda m, mode: ddxy(m),
    "bar_x": lambda m, mode: bar_x(m),
    "bar_y": lambda m, mode: bar_y(m),
    "bar": lambda m, mode: bar4(m),
}


def interior_derivative(m: torch.Tensor, rule: str, dy_mode: str = DY_FIXED) -> torch.Tensor:
    """Dispatch on the reference helper's rule names."""
    try:
        fn = _RULES[rule]
    except KeyError:
        raise ValueError(f"unknown derivative rule {rule!r}") from None
    return fn(m, dy_mode)


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


def mirror_edges_movie(movie: torch.Tensor) -> torch.Tensor:
    """:func:`mirror_edges` of every frame of a (T, X, Y) stack."""
    return mirror_edges(movie)
