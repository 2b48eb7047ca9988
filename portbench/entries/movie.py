"""Entry ``movie``: ``variational_optical_flow`` on a whole movie a call.

The traffic file gives the ``warm_start``; ``warmup_frames`` frames of
the first movie warm up the call's shapes; ``check_pairs`` pairs, each at
a different pair index of its call (a different slot of a batched solve),
are compared with the reference's exact solution, and every pair's flags
and values.  The configuration's movies come in the order the seed draws
(``synth.config_movies``); calls cycle through them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench import compare, synth


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 solver_overrides: Optional[dict] = None):
        from opticalflow_tpu_torch.core.types import SolverConfig
        from opticalflow_tpu_torch.flow.variational import variational_optical_flow

        self._solve = variational_optical_flow
        self.config, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.movies = synth.config_movies(config, np.random.default_rng(seed % 2**64))
        self.solver = SolverConfig(**{**config["solver"], **(solver_overrides or {})})

    def _run(self, movie):
        c = self.config
        return self._solve(movie, delta_x=c["delta_x"], delta_t=c["delta_t"],
                           speed_alpha=c["speed_alpha"], remodelling_alpha=c["remodelling_alpha"],
                           dy_mode=c["dy_mode"], warm_start=self.traffic["warm_start"],
                           solver=self.solver, device=self.device)

    def warm_up(self) -> None:
        self._run(self.movies[0][: self.traffic["warmup_frames"]])

    def __call__(self, k: int) -> dict:
        i = k % len(self.movies)
        res = self._run(self.movies[i])
        return {"movie": i, "v_x": res["v_x"], "v_y": res["v_y"],
                "remodelling": res["remodelling"],
                "converged": np.asarray(res["converged_all"], bool),
                "iterations": int(np.sum(res["iterations"])),
                "pairs": int(res["v_x"].shape[0])}

    def numbers(self, results: List[dict], device) -> Dict[str, float]:
        rng = np.random.default_rng([self.seed % 2**64, 1])
        sample = compare.sample_pairs([r["pairs"] for r in results],
                                      self.traffic["check_pairs"], rng)
        return compare.movie_numbers(self.movies, results, self.config, sample, device)

    @staticmethod
    def failed(numbers: Dict[str, float]) -> int:
        return int(numbers["unconverged_pairs"] + numbers["nonfinite_pairs"])
