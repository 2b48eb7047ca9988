"""Synthetic test movies in numpy (noise-free).

Counterpart of ``opticalflow_tpu.core.synth.make_fake_data_frame`` and
``make_translating_blob_movie``: a Gaussian hat
``exp(-((x-x0)^2 + (y-y0)^2) / sigma^2)`` on a square grid, translating at a
known uniform velocity.  The movies are deterministic, so the port needs no
random generator; the noisy variant stays in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_fake_data_frame(
    x_position: float,
    y_position: float,
    sigma: float = 1.0,
    width: float = 20.0,
    dimension: int = 1000,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """Draw a Gaussian hat centred at (x_position, y_position).

    Returns ``(frame, delta_x)`` where ``delta_x`` is the pixel size in the
    units of the positions.
    """
    coords = np.linspace(0.0, width, dimension, dtype=dtype)
    dx2 = (coords[:, None] - x_position) ** 2
    dy2 = (coords[None, :] - y_position) ** 2
    frame = np.exp(-(dx2 + dy2) / sigma**2).astype(dtype)
    return frame, float(width / (dimension - 1))


def make_translating_blob_movie(
    n_frames: int = 2,
    dimension: int = 256,
    width: float = 20.0,
    sigma: float = 3.0,
    v_x: float = 0.1,
    v_y: float = 0.2,
    start: Tuple[float, float] = None,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """A ``(n_frames, dimension, dimension)`` movie of a Gaussian blob
    translating at ``(v_x, v_y)`` physical units per frame; returns
    ``(movie, delta_x)``."""
    if start is None:
        start = (width / 2.0, width / 2.0)
    frames = []
    delta_x = None
    for t in range(n_frames):
        frame, delta_x = make_fake_data_frame(
            start[0] + v_x * t, start[1] + v_y * t, sigma=sigma, width=width,
            dimension=dimension, dtype=dtype,
        )
        frames.append(frame)
    return np.stack(frames, axis=0), delta_x
