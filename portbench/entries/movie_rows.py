"""Entry ``movie_rows``: the ``movie`` entry's calls, checked against the
row-checkpointed reference (``reference_rows``), for frames whose plain
reference does not fit on the card.

A call is the ``movie`` entry's: ``variational_optical_flow`` on a whole
movie, the calls cycling through the configuration's movies.  Each call
also keeps its solves' pair ranges: pair 0 alone and then the batched
pass's chunks for ``'two-pass'`` (the program's series
``variational/chunk_pairs``; one chunk of every pair where the program
records none), the chunks alone for ``'cold'``, the whole movie for
``'sequential'``.

Compared numbers (limits in ``limits/<cell>.json``), as ``compare``'s
movie cells: ``unconverged_pairs`` and ``nonfinite_pairs`` over every pair
of the window; ``epe_px`` and ``remodelling_rel`` over ``check_pairs``
pairs, no two at the same pair index: pair 0 of the first call, the last
pair of the last call, a pair of every solve of the calls' plan not yet
sampled, the rest drawn from the seed.  Each sampled pair's errors go to
standard error.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench import files, reference_rows

Movie = files.entry("movie", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SERIES = "variational/chunk_pairs"


def solves(warm_start: str, pairs: int, chunks: List[int]):
    """The (first, last + 1) pair ranges of a call's solves."""
    if warm_start == "sequential":
        return [(0, pairs)]
    bounds, lo = [], 0
    if warm_start == "two-pass":
        bounds, lo = [(0, 1)], 1
    for size in chunks or [pairs - lo]:
        bounds.append((lo, lo + size))
        lo += size
    return bounds


def sample_pairs(results: List[dict], count: int, rng: np.random.Generator):
    """``count`` (call, pair) indices, no two at the same pair index: pair 0
    of the first call, the last pair of the last call, a pair drawn in
    every solve range of any call that holds none yet, then pair indices
    drawn from the rest, each in a call drawn among those that hold it."""
    last = len(results) - 1
    chosen = {(0, 0), (last, results[last]["pairs"] - 1)}
    used = {p for _, p in chosen}
    for lo, hi in sorted({s for r in results for s in r["solves"]}):
        free = [p for p in range(lo, hi) if p not in used]
        if any(lo <= p < hi for p in used) or not free:
            continue
        p = int(free[rng.integers(len(free))])
        calls = [c for c, r in enumerate(results) if (lo, hi) in r["solves"]]
        chosen.add((int(calls[rng.integers(len(calls))]), p))
        used.add(p)
    slots = [p for p in range(max(r["pairs"] for r in results)) if p not in used]
    take = min(max(count - len(chosen), 0), len(slots))
    for p in rng.choice(slots, size=take, replace=False):
        calls = [c for c, r in enumerate(results) if r["pairs"] > p]
        chosen.add((int(calls[rng.integers(len(calls))]), int(p)))
    return sorted(chosen)


def reference_block(shape, device, budget_bytes: float = 40e9) -> int:
    """Pairs the reference solves at once within ``budget_bytes`` on the
    card (after the program's state is freed)."""
    if str(device).startswith("cpu"):
        return 64
    return max(1, int(budget_bytes // reference_rows.pair_bytes(shape[-2] - 2, shape[-1] - 2)))


def movie_numbers(movies: List[np.ndarray], calls: List[dict], config: dict, sample,
                  device) -> Dict[str, float]:
    """``compare.movie_numbers`` against ``reference_rows``: ``calls`` per
    call its movie index ``movie`` and the returned ``v_x``, ``v_y``,
    ``remodelling`` (P, Ni, Nj) and ``converged`` (P,)."""
    to_px = config["delta_t"] / config["delta_x"]
    a_s, a_r = config["speed_alpha"], config["remodelling_alpha"]
    compat = config["dy_mode"] == "compat"
    out = {"unconverged_pairs": 0, "nonfinite_pairs": 0, "epe_px": 0.0, "remodelling_rel": 0.0}
    for c in calls:
        fields = np.stack([c["v_x"], c["v_y"], c["remodelling"]], axis=1)
        out["unconverged_pairs"] += int(np.sum(~np.asarray(c["converged"], bool)))
        out["nonfinite_pairs"] += int(np.sum(~np.isfinite(fields).all(axis=(1, 2, 3))))
    if out["nonfinite_pairs"]:
        out["epe_px"] = out["remodelling_rel"] = float("inf")
        return out
    block = reference_block(movies[0].shape, device)
    for lo in range(0, len(sample), block):
        part = sample[lo:lo + block]
        pairs = [movies[calls[ci]["movie"]][p:p + 2] for ci, p in part]
        frames = torch.from_numpy(np.stack(pairs)).to(device=device, dtype=torch.float64)
        v_ref, g_ref = reference_rows.movie_fields(frames[:, 0], frames[:, 1], a_s, a_r, compat)
        del frames
        v = torch.from_numpy(np.stack([np.stack([calls[ci]["v_x"][p], calls[ci]["v_y"][p]])
                                       for ci, p in part]).astype(np.float64)).to(device)
        g = torch.from_numpy(np.stack([calls[ci]["remodelling"][p] for ci, p in part])
                             .astype(np.float64)).to(device)
        epe = torch.sqrt(((v * to_px - v_ref) ** 2).sum(1))[:, 1:-1, 1:-1].amax((1, 2))
        peak = g_ref.abs().flatten(1).amax(1)
        g_rel = (g - g_ref).abs().flatten(1).amax(1) / peak
        for (ci, p), e, r in zip(part, epe.tolist(), g_rel.tolist()):
            print(f"movie_rows call {ci} movie {calls[ci]['movie']} pair {p} epe_px {e:.3e} "
                  f"remodelling_rel {r:.3e}", file=sys.stderr)
        out["epe_px"] = max(out["epe_px"], float(epe.max()))
        out["remodelling_rel"] = max(out["remodelling_rel"], float(g_rel.max()))
        del v_ref, g_ref, v, g
    sys.stderr.flush()
    return out


class Entry(Movie):
    def __call__(self, k: int) -> dict:
        from opticalflow_tpu_torch.utils import observability

        before = len(observability.values().get(SERIES, ()))
        out = super().__call__(k)
        chunks = [int(c) for c in observability.values().get(SERIES, ())[before:]]
        out["solves"] = solves(self.traffic["warm_start"], out["pairs"], chunks)
        return out

    def sample(self, results: List[dict], rng: np.random.Generator):
        return sample_pairs(results, self.traffic["check_pairs"], rng)

    def numbers(self, results: List[dict], device) -> Dict[str, float]:
        rng = np.random.default_rng([self.seed % 2**64, 1])
        return movie_numbers(self.movies, results, self.config, self.sample(results, rng), device)
