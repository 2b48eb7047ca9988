"""Entry ``sweep``: ``analysis.sweeps.vary_regularisation(batched=True)``
over the configuration's alpha grid, a whole sweep a call.

One chunk of the grid's own size (at most ``batch_chunk`` cells) at the
grid's middle alphas warms up the chunk's shapes.  Every cell's flags and
values are judged; ``check_cells`` cells that report converged, drawn
from the seed, are compared with the reference's exact solution.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench import compare, synth


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 solver_overrides: Optional[dict] = None):
        from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation
        from opticalflow_tpu_torch.core.types import SolverConfig

        self._sweep = vary_regularisation
        self.config, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.movies = synth.config_movies(config, np.random.default_rng(seed % 2**64))
        self.solver = SolverConfig(**{**config["solver"], **(solver_overrides or {})})
        self.speed_alphas = compare.config_alphas(config["speed_alphas"])
        self.remodelling_alphas = compare.config_alphas(config["remodelling_alphas"])

    def _run(self, movie, speed_alphas, remodelling_alphas):
        c = self.config
        return self._sweep(movie, speed_alphas, remodelling_alphas, batched=True,
                           delta_x=c["delta_x"], delta_t=c["delta_t"], dy_mode=c["dy_mode"],
                           solver=self.solver, batch_chunk=c["batch_chunk"], device=self.device)

    def warm_up(self) -> None:
        mid = lambda a: a[len(a) // 2]  # noqa: E731
        cells = min(self.config["batch_chunk"], self.speed_alphas.size * self.remodelling_alphas.size)
        self._run(self.movies[0], np.full(cells, mid(self.speed_alphas)),
                  np.array([mid(self.remodelling_alphas)]))

    def __call__(self, k: int) -> dict:
        i = k % len(self.movies)
        res = self._run(self.movies[i], self.speed_alphas, self.remodelling_alphas)
        out = {key: np.asarray(res[key]) for key in compare.SWEEP_STATS + ("converged",)}
        out.update(movie=i, iterations=None, pairs=int(out["converged"].size))
        return out

    def numbers(self, results: List[dict], device) -> Dict[str, float]:
        rng = np.random.default_rng([self.seed % 2**64, 1])
        return compare.sweep_numbers(self.movies, results, self.config, device,
                                     self.traffic["check_cells"], rng)

    @staticmethod
    def failed(numbers: Dict[str, float]) -> int:
        return int(numbers["nonfinite_cells"])
