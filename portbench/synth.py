"""The benchmark's movie generator, frozen.

A NumPy copy of ``opticalflow_tpu_torch/core/synth.py``'s
``make_fake_data_frame`` and ``make_translating_blob_movie`` as of commit
8e4d725 (the noise option and the returned pixel size dropped: nothing
here uses them), kept here so that the benchmark's inputs cannot move
with the program: a Gaussian hat
``exp(-((x - x0)^2 + (y - y0)^2) / sigma^2)`` on a ``width``-sized square
grid of ``dimension`` points, translating at ``(v_x, v_y)`` width units a
frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def blob_frame(x_position: float, y_position: float, sigma: float, width: float,
               dimension: int) -> np.ndarray:
    """One float64 frame."""
    coords = np.linspace(0.0, width, dimension, dtype=np.float64)
    dx2 = (coords[:, None] - x_position) ** 2
    dy2 = (coords[None, :] - y_position) ** 2
    return np.exp(-(dx2 + dy2) / sigma**2)


def translating_blob_movie(n_frames: int, dimension: int, width: float, sigma: float,
                           v_x: float, v_y: float, start: Tuple[float, float]) -> np.ndarray:
    """A float64 (n_frames, dimension, dimension) movie of a blob that
    starts at ``start`` and moves ``(v_x, v_y)`` a frame."""
    return np.stack([blob_frame(start[0] + v_x * t, start[1] + v_y * t, sigma, width, dimension)
                     for t in range(n_frames)])


def config_movie(config: dict, offset) -> np.ndarray:
    """A configuration's float32 movie: its blob, started at the centre of
    the field moved by ``offset`` (width units in x and y), times
    ``intensity_scale`` and rounded through float32, as microscope counts
    are exact in it."""
    width = config["blob_width"]
    start = (width / 2.0 + offset[0], width / 2.0 + offset[1])
    movie = translating_blob_movie(config["frames"], config["dimension"], width,
                                   config["blob_sigma"], config["v_x"], config["v_y"], start)
    return np.asarray(movie * config["intensity_scale"], np.float32)


def config_movies(config: dict, rng: np.random.Generator):
    """The configuration's movies, one a start of ``start_offsets``, in the
    order ``rng`` draws: every seed runs the same work in another order."""
    offsets = config["start_offsets"]
    return [config_movie(config, offsets[i]) for i in rng.permutation(len(offsets))]
