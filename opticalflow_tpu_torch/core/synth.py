"""Synthetic test movies, in numpy on the host.

Counterpart of ``opticalflow_tpu.core.synth``: the reference's Gaussian hat
``exp(-((x-x0)^2 + (y-y0)^2) / sigma^2)`` on a square grid (optionally with
tiny uniform noise) and the movies built from it, the analytic textures
(a fixed sinusoid mixture and a random broadband sum of plane waves), and
the vortex-pair velocity field with its advected-texture movie.

The noise comes from a numpy ``Generator`` (``rng``; frame ``t`` of a
movie draws from ``default_rng(t)``) where the JAX package uses
``PRNGKey``: the same amplitude (uniform in [0, 1e-7)), other bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_fake_data_frame(
    x_position: float,
    y_position: float,
    sigma: float = 1.0,
    width: float = 20.0,
    include_noise: bool = False,
    dimension: int = 1000,
    rng: Optional[np.random.Generator] = None,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """Draw a Gaussian hat centred at (x_position, y_position); with
    ``include_noise``, ``|frame + uniform[0, 1) * 1e-7|`` drawn from ``rng``
    (``default_rng(0)`` when ``None``).

    Returns ``(frame, delta_x)`` where ``delta_x`` is the pixel size in the
    units of the positions.
    """
    coords = np.linspace(0.0, width, dimension, dtype=dtype)
    dx2 = (coords[:, None] - x_position) ** 2
    dy2 = (coords[None, :] - y_position) ** 2
    frame = np.exp(-(dx2 + dy2) / sigma**2).astype(dtype)
    if include_noise:
        rng = rng if rng is not None else np.random.default_rng(0)
        frame = np.abs(frame + rng.uniform(size=frame.shape).astype(dtype) * 1e-7)
    return frame, float(width / (dimension - 1))


def _texture(x, y, mean_intensity, contrast):
    """Analytic smooth positive texture: a multi-frequency sinusoid
    mixture, closed-form in (x, y), so it can be sampled at warped
    coordinates (exact translations, no interpolation error)."""
    tau = 2.0 * np.pi
    p = (
        0.45 * np.sin(tau * x / 73.0) * np.cos(tau * y / 91.0)
        + 0.30 * np.cos(tau * (x + 0.7 * y) / 41.0)
        + 0.15 * np.sin(tau * (0.4 * x - y) / 157.0)
        + 0.10 * np.cos(tau * x / 23.0) * np.cos(tau * y / 19.0)
    )
    return mean_intensity * (1.0 + contrast * 0.5 * p)


def random_fourier_texture(
    x,
    y,
    n_modes: int = 96,
    min_period: float = 8.0,
    max_period: float = 24.0,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    seed: int = 0,
):
    """Isotropic broadband analytic texture: a sum of random plane waves
    ``sum_k a_k cos(k . x + phi_k)``, wavenumber magnitudes uniform in
    ``[2 pi / max_period, 2 pi / min_period]``, uniformly random directions
    and phases, amplitudes normalised to unit variance before the contrast
    scaling; drawn from ``np.random.default_rng(seed)``, as the JAX package
    draws them.  Closed-form in (x, y), so it can be sampled at warped
    coordinates for exact synthetic advection; locally two-dimensional
    everywhere (no dominant orientation, no near-DC component)."""
    rng = np.random.default_rng(seed)
    kmag = rng.uniform(2.0 * np.pi / max_period, 2.0 * np.pi / min_period, n_modes)
    theta = rng.uniform(0.0, 2.0 * np.pi, n_modes)
    phase = rng.uniform(0.0, 2.0 * np.pi, n_modes)
    amp = rng.uniform(0.5, 1.0, n_modes)
    amp = amp / np.sqrt((amp**2).sum() / 2.0)
    kx = kmag * np.cos(theta)
    ky = kmag * np.sin(theta)
    p = np.zeros_like(x + y)
    # mode by mode: peak memory stays one (Ni, Nj) plane
    for i in range(n_modes):
        p = p + amp[i] * np.cos(kx[i] * x + ky[i] * y + phase[i])
    return mean_intensity * (1.0 + contrast * 0.5 * p)


def make_translating_texture_movie(
    n_frames: int = 2,
    dimension: int = 1024,
    v_x: float = 0.15,
    v_y: float = 0.1,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """A full-field smooth positive texture translating at a known uniform
    velocity (pixels per frame interval; delta_x = delta_t = 1), so the
    data term constrains the velocity everywhere, as on real microscopy
    frames."""
    ii = np.arange(dimension, dtype=dtype)[:, None]
    jj = np.arange(dimension, dtype=dtype)[None, :]
    frames = [_texture(ii - v_x * t, jj - v_y * t, mean_intensity, contrast)
              for t in range(n_frames)]
    return np.stack(frames, axis=0), 1.0


def make_remodelling_ramp_movie(
    n_frames: int = 2,
    dimension: int = 50,
    width: float = 5.0,
    sigma: float = 3.0,
    v_x: float = 0.05,
    v_y: float = 0.1,
    remodelling_max: float = 0.05,
    background: str = "blob",
    mean_intensity: float = 100.0,
    dtype=np.float64,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """A movie with a known non-uniform remodelling rate: material advected
    at uniform (v_x, v_y) while created at ``gamma(x, y) = linspace(0,
    remodelling_max)`` tiled along rows, ``I_t = I_0(x - v t) + t * gamma``.

    ``background``: ``'blob'`` (the reference's Gaussian hat; positions move
    in physical units over a ``width``-sized domain) or ``'texture'`` (a
    full-field :func:`random_fourier_texture`, delta_x = 1, v in
    px/frame).  Returns ``(movie, delta_x, gamma_true)``.
    """
    row = np.linspace(0.0, remodelling_max, dimension, dtype=dtype)
    gamma_true = np.tile(row, (dimension, 1))
    frames = []
    if background == "blob":
        delta_x = None
        for t in range(n_frames):
            blob, delta_x = make_fake_data_frame(
                width / 2.0 + v_x * t, width / 2.0 + v_y * t, sigma=sigma, width=width,
                dimension=dimension, dtype=dtype)
            frames.append(blob + t * gamma_true)
    elif background == "texture":
        delta_x = 1.0
        ii = np.arange(dimension, dtype=dtype)[:, None]
        jj = np.arange(dimension, dtype=dtype)[None, :]
        for t in range(n_frames):
            frames.append(random_fourier_texture(ii - v_x * t, jj - v_y * t,
                                                 mean_intensity=mean_intensity)
                          + t * gamma_true)
    else:
        raise ValueError(f"unknown background {background!r}")
    return np.stack(frames, axis=0), delta_x, gamma_true


def vortex_pair_velocity(
    dimension: int,
    centers=None,
    core_sigma: float = None,
    peak_speed: float = 1.0,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic counter-rotating vortex-pair velocity field (px/frame).

    Stream function ``psi = A [exp(-r1^2/s^2) - exp(-r2^2/s^2)]`` with
    ``v = (dpsi/dy, -dpsi/dx)``, divergence-free by construction; scaled so
    that the sampled pair field's largest |v| is ``peak_speed``.
    """
    if centers is None:
        centers = ((dimension * 0.5, dimension * 0.35), (dimension * 0.5, dimension * 0.65))
    if core_sigma is None:
        core_sigma = dimension / 8.0
    ii = np.arange(dimension, dtype=dtype)[:, None]
    jj = np.arange(dimension, dtype=dtype)[None, :]
    s2 = core_sigma**2
    v_x = np.zeros((dimension, dimension), dtype)
    v_y = np.zeros((dimension, dimension), dtype)
    for sign, (cx, cy) in zip((1.0, -1.0), centers):
        e = np.exp(-((ii - cx) ** 2 + (jj - cy) ** 2) / s2)
        v_x = v_x + sign * (-2.0 * (jj - cy) / s2) * e
        v_y = v_y - sign * (-2.0 * (ii - cx) / s2) * e
    # normalise against the sampled pair field: between the cores the
    # partners add, so the single-vortex peak understates max |v|
    vmax = np.sqrt(np.max(v_x**2 + v_y**2))
    scale = peak_speed / max(vmax, 1e-300)
    return v_x * scale, v_y * scale


def make_vortex_pair_movie(
    n_frames: int = 2,
    dimension: int = 128,
    peak_speed: float = 0.5,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Broadband texture advected by a vortex-pair field: frames are
    :func:`random_fourier_texture` sampled at the backward-warped
    coordinates ``x - t v(x)`` (exact for one step up to O(|v|^2 |grad
    v|)).  Returns ``(movie, v_x_true, v_y_true)`` in px/frame."""
    v_x, v_y = vortex_pair_velocity(dimension, peak_speed=peak_speed, dtype=dtype)
    ii = np.arange(dimension, dtype=dtype)[:, None]
    jj = np.arange(dimension, dtype=dtype)[None, :]
    frames = [random_fourier_texture(ii - t * v_x, jj - t * v_y,
                                     mean_intensity=mean_intensity, contrast=contrast)
              for t in range(n_frames)]
    return np.stack(frames, axis=0), v_x, v_y


def make_translating_blob_movie(
    n_frames: int = 2,
    dimension: int = 256,
    width: float = 20.0,
    sigma: float = 3.0,
    v_x: float = 0.1,
    v_y: float = 0.2,
    start: Tuple[float, float] = None,
    include_noise: bool = False,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """A ``(n_frames, dimension, dimension)`` movie of a Gaussian blob
    translating at ``(v_x, v_y)`` physical units per frame (frame ``t``'s
    noise, with ``include_noise``, from ``default_rng(t)``); returns
    ``(movie, delta_x)``."""
    if start is None:
        start = (width / 2.0, width / 2.0)
    frames = []
    delta_x = None
    for t in range(n_frames):
        frame, delta_x = make_fake_data_frame(
            start[0] + v_x * t, start[1] + v_y * t, sigma=sigma, width=width,
            include_noise=include_noise, dimension=dimension,
            rng=np.random.default_rng(t) if include_noise else None, dtype=dtype,
        )
        frames.append(frame)
    return np.stack(frames, axis=0), delta_x
