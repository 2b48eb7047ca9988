"""What decides ``correct``: the program's answers against the reference.

Plain NumPy and PyTorch; imports nothing of the program.  Each function
takes what the timed calls returned (host arrays) and the frames the
benchmark made, and returns the numbers compared, by name.  A number
passes when it is at most its limit (``limits/<cell>.json``).

Movie cells (every pair of every call in the window, unless said):

* ``unconverged_pairs``: pairs whose solve reports not converged;
* ``nonfinite_pairs``: pairs with a non-finite value in a returned field;
* ``epe_px``: over a sample of pairs drawn from the seed, each at a
  different pair index (a different slot of a batched solve), the largest
  endpoint error in pixels against the reference's exact solution;
* ``remodelling_rel``: over the same sample, the largest remodelling
  error over the reference field's peak.

Sweep cells (every cell of every call, unless said):

* ``unconverged_cells``: the most cells of one call that report not
  converged (the alpha_s = 10 row never converges, corners flip);
* ``nonfinite_cells``: cells with a non-finite statistic;
* ``<statistic>_rel``: over a sample, drawn from the seed, of different
  cells that report converged, the largest relative error against the
  reference's of ``speed_means``, ``remodelling_variances`` and
  ``functional``.

Every cell: ``plain_calls``, calls of a kernel's plain version in the
window, which on the card means a kernel did not run.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import reference

SWEEP_STATS = ("speed_means", "speed_variances", "remodelling_means",
               "remodelling_variances", "functional")
# the statistics whose error separates the program from its control
# (float32 alone) on the card; the speed variance and the remodelling mean
# do not, and are not compared (PERF.md)
JUDGED_STATS = ("speed_means", "remodelling_variances", "functional")


def sample_pairs(pairs_per_call: Sequence[int], count: int, rng: np.random.Generator):
    """``count`` (call, pair) indices, no two at the same pair index (the
    same slot of a batched solve): the first pair of the first call, the
    last pair of the last call, and the rest at pair indices drawn by
    ``rng``, each in a call drawn by ``rng`` among those that hold it."""
    last = len(pairs_per_call) - 1
    chosen = {(0, 0), (last, pairs_per_call[last] - 1)}
    slots = [p for p in range(max(pairs_per_call)) if p not in {q for _, q in chosen}]
    take = min(max(count - len(chosen), 0), len(slots))
    for p in rng.choice(slots, size=take, replace=False):
        holders = [c for c, n in enumerate(pairs_per_call) if n > p]
        chosen.add((int(holders[rng.integers(len(holders))]), int(p)))
    return sorted(chosen)


def reference_block(shape, device, budget_bytes: float = 40e9) -> int:
    """Pairs the reference solves at once: its row gains take
    ``m * (3 n)**2`` float64s a pair, kept within ``budget_bytes`` on the
    card (after the program's state is freed)."""
    m, n = shape[-2] - 2, shape[-1] - 2
    if str(device).startswith("cpu"):
        return 64
    return max(1, int(budget_bytes // (m * (3 * n) ** 2 * 8)))


def movie_numbers(movies: List[np.ndarray], calls: List[dict], config: dict, sample,
                  device) -> Dict[str, float]:
    """``calls``: per call its movie index ``movie`` and the returned
    ``v_x``, ``v_y``, ``remodelling`` (P, Ni, Nj) and ``converged`` (P,)."""
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
        v_ref, g_ref = reference.movie_fields(frames[:, 0], frames[:, 1], a_s, a_r, compat)
        v = torch.from_numpy(np.stack([np.stack([calls[ci]["v_x"][p], calls[ci]["v_y"][p]])
                                       for ci, p in part]).astype(np.float64)).to(device)
        g = torch.from_numpy(np.stack([calls[ci]["remodelling"][p] for ci, p in part])
                             .astype(np.float64)).to(device)
        epe = torch.sqrt(((v * to_px - v_ref) ** 2).sum(1))[:, 1:-1, 1:-1].amax((1, 2))
        peak = g_ref.abs().flatten(1).amax(1)
        g_rel = (g - g_ref).abs().flatten(1).amax(1) / peak
        out["epe_px"] = max(out["epe_px"], float(epe.max()))
        out["remodelling_rel"] = max(out["remodelling_rel"], float(g_rel.max()))
        del v_ref, g_ref
    return out


def sweep_reference(movie: np.ndarray, a_s: np.ndarray, a_r: np.ndarray, config: dict,
                    device) -> Dict[str, np.ndarray]:
    """The reference's statistics of the one-pair sweep cells at alphas
    ``a_s``, ``a_r`` (C,), in blocks of cells."""
    frames = torch.from_numpy(movie).to(device=device, dtype=torch.float64)
    block = reference_block(movie.shape, device)
    parts = []
    for lo in range(0, a_s.size, block):
        n = min(block, a_s.size - lo)
        stats = reference.sweep_statistics(
            frames[:1].expand(n, -1, -1), frames[1:2].expand(n, -1, -1),
            torch.from_numpy(a_s[lo:lo + n]).to(device), torch.from_numpy(a_r[lo:lo + n]).to(device),
            scale=config["delta_x"] / config["delta_t"], compat=config["dy_mode"] == "compat")
        parts.append({k: v.cpu().numpy() for k, v in stats.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def config_alphas(spec) -> np.ndarray:
    """A list of alphas, or ``{"logspace": [start, stop, num]}``."""
    if isinstance(spec, dict):
        return np.logspace(*spec["logspace"])
    return np.asarray(spec, dtype=np.float64)


def sweep_numbers(movies: List[np.ndarray], calls: List[dict], config: dict, device,
                  count: int, rng: np.random.Generator) -> Dict[str, float]:
    """``calls``: per call its movie index ``movie`` and the returned
    statistics (SWEEP_STATS) and ``converged`` of every cell.  Flags and
    values are judged on every cell; the statistics against the reference
    on ``count`` different cells that report converged, each in a call
    drawn by ``rng`` among those where it did."""
    out = {"unconverged_cells": 0, "nonfinite_cells": 0}
    out.update({f"{k}_rel": 0.0 for k in JUDGED_STATS})
    judged = {}  # cell -> calls where it converged with finite statistics
    for ci, c in enumerate(calls):
        conv = np.asarray(c["converged"], bool).ravel()
        finite = np.all([np.isfinite(np.asarray(c[k], np.float64).ravel()) for k in SWEEP_STATS],
                        axis=0)
        out["unconverged_cells"] = max(out["unconverged_cells"], int(np.sum(~conv)))
        out["nonfinite_cells"] += int(np.sum(~finite))
        for cell in np.flatnonzero(conv & finite):
            judged.setdefault(int(cell), []).append(ci)
    cells = sorted(judged)
    picked = sorted(int(k) for k in rng.choice(cells, size=min(count, len(cells)), replace=False))
    a_s, a_r = np.meshgrid(config_alphas(config["speed_alphas"]),
                           config_alphas(config["remodelling_alphas"]), indexing="ij")
    a_s, a_r = a_s.ravel(), a_r.ravel()
    by_movie: Dict[int, List] = {}
    for cell in picked:
        ci = judged[cell][rng.integers(len(judged[cell]))]
        by_movie.setdefault(calls[ci]["movie"], []).append((ci, cell))
    for movie, part in by_movie.items():
        idx = np.array([cell for _, cell in part])
        ref = sweep_reference(movies[movie], a_s[idx], a_r[idx], config, device)
        stats = {k: np.array([np.asarray(calls[ci][k], np.float64).ravel()[cell]
                              for ci, cell in part]) for k in JUDGED_STATS}
        for k, err in stat_errors(stats, ref).items():
            out[f"{k}_rel"] = max(out[f"{k}_rel"], float(np.max(err)))
    return out


def stat_errors(stats: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per judged statistic, each cell's error relative to the reference's."""
    return {k: np.abs(np.asarray(stats[k], np.float64).ravel() - ref[k]) / np.abs(ref[k])
            for k in JUDGED_STATS}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number without a limit is an error
    of the benchmark's files."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k], "ok": bool(v <= limits[k])}
            for k, v in numbers.items()}
