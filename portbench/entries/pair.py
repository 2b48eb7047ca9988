"""Entry ``pair``: one frame pair a call, the first of each movie in turn.

Call k solves the first pair of movie k mod 5 (the configuration's movies,
in the order the seed draws) as a two-frame movie through
``variational_optical_flow``, with the mix's ``warm_start``: every call
does the same work.  Only the movies' first two frames are made.

Compared numbers, as ``movie_rows``' against ``reference_rows``:
``unconverged_pairs`` and ``nonfinite_pairs`` over every call of the
window; ``epe_px`` and ``remodelling_rel`` over one call of each movie the
window ran, drawn from the seed, at most ``check_pairs`` of them.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from portbench import files

MovieRows = files.entry("movie_rows", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Entry(MovieRows):
    def __init__(self, config: dict, traffic: dict, seed: int, device, solver_overrides=None):
        super().__init__({**config, "frames": 2}, traffic, seed, device, solver_overrides)

    def sample(self, results: List[dict], rng: np.random.Generator):
        by_movie = {}
        for ci, r in enumerate(results):
            by_movie.setdefault(r["movie"], []).append(ci)
        movies = sorted(by_movie)[: self.traffic["check_pairs"]]
        return sorted((int(by_movie[i][rng.integers(len(by_movie[i]))]), 0) for i in movies)
