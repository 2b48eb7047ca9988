"""Entry ``sweep_pool``: ``analysis.sweeps.vary_regularisation(batched=True)``
over the configuration's alpha grid on every movie of the pool a call.

A call sweeps each movie of ``start_offsets`` once, in the order the seed
draws, so every call does the same work whatever the seed.  Warm-up is
``sweep``'s: one chunk of the grid's size at the grid's middle alphas.

Compared numbers (limits in ``limits/<cell>.json``):

* ``unconverged_judged_cells``: over every sweep of the window, the cells
  of the mix's fixed ``judged_cells`` (start index in ``start_offsets``,
  alpha_s index, alpha_r index) that report not converged;
* ``nonfinite_cells``: cells, judged or not, with a non-finite statistic;
* ``<statistic>_rel`` for each of ``compare.JUDGED_STATS``: over
  ``check_cells`` (movie, cell) pairs drawn from the seed among the judged
  cells, each in a call drawn from the seed, the largest error relative
  to the reference's (``compare.sweep_reference``), whatever the
  program's flag says.

Each compared cell's errors go to standard error with its movie's start
offset and its alphas.  The judged set leaves out the (start, cell) pairs
that no sound run converges, where the JAX package's own solve does not
converge either (PERF.md).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from portbench import compare, files

Sweep = files.entry("sweep", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Entry(Sweep):
    def __init__(self, config: dict, traffic: dict, seed: int, device, solver_overrides=None):
        super().__init__(config, traffic, seed, device, solver_overrides)
        # the order synth.config_movies drew: movie i starts at offsets[order[i]]
        self.order = np.random.default_rng(seed % 2**64).permutation(len(config["start_offsets"]))
        # judged[i]: the judged cells (flat alpha_s x alpha_r index) of movie i
        n_r = self.remodelling_alphas.size
        self.judged = [np.array([i_s * n_r + i_r for s, i_s, i_r in traffic["judged_cells"]
                                 if s == start], dtype=np.int64) for start in self.order]

    def __call__(self, k: int) -> dict:
        sweeps = []
        for movie in self.movies:
            res = self._run(movie, self.speed_alphas, self.remodelling_alphas)
            sweeps.append({key: np.asarray(res[key]).ravel()
                           for key in compare.SWEEP_STATS + ("converged",)})
        return {"sweeps": sweeps, "iterations": None,
                "pairs": sum(int(s["converged"].size) for s in sweeps)}

    def numbers(self, results: List[dict], device) -> Dict[str, float]:
        out = {"unconverged_judged_cells": 0, "nonfinite_cells": 0}
        out.update({f"{k}_rel": 0.0 for k in compare.JUDGED_STATS})
        for r in results:
            for s, judged in zip(r["sweeps"], self.judged):
                finite = np.all([np.isfinite(s[k].astype(np.float64)) for k in compare.SWEEP_STATS],
                                axis=0)
                out["nonfinite_cells"] += int(np.sum(~finite))
                out["unconverged_judged_cells"] += int(np.sum(~s["converged"][judged]))
        rng = np.random.default_rng([self.seed % 2**64, 1])
        pool = [(movie, int(cell)) for movie, judged in enumerate(self.judged) for cell in judged]
        picked = rng.choice(len(pool), size=min(self.traffic["check_cells"], len(pool)),
                            replace=False)
        by_movie: Dict[int, List] = {}
        for p in sorted(int(p) for p in picked):
            movie, cell = pool[p]
            by_movie.setdefault(movie, []).append((int(rng.integers(len(results))), cell))
        a_s, a_r = np.meshgrid(self.speed_alphas, self.remodelling_alphas, indexing="ij")
        a_s, a_r = a_s.ravel(), a_r.ravel()
        for movie, part in by_movie.items():
            idx = np.array([cell for _, cell in part])
            ref = compare.sweep_reference(self.movies[movie], a_s[idx], a_r[idx], self.config,
                                          device)
            got = [results[ci]["sweeps"][movie] for ci, _ in part]
            errors = compare.stat_errors({k: np.array([g[k][c] for g, (_, c) in zip(got, part)])
                                          for k in compare.JUDGED_STATS}, ref)
            for j, (ci, cell) in enumerate(part):
                print(f"sweep_pool cell start {self.config['start_offsets'][self.order[movie]]} "
                      f"alpha_s {float(a_s[cell])!r} alpha_r {float(a_r[cell])!r} call {ci} "
                      f"converged {bool(got[j]['converged'][cell])} "
                      + " ".join(f"{k}_rel {errors[k][j]:.3e}" for k in compare.JUDGED_STATS),
                      file=sys.stderr)
            for k, err in errors.items():
                out[f"{k}_rel"] = max(out[f"{k}_rel"], float(np.max(err)))
        sys.stderr.flush()
        return out

    @staticmethod
    def failed(numbers: Dict[str, float]) -> int:
        return int(numbers["nonfinite_cells"])
