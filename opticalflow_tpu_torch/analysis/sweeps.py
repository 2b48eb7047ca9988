"""Regularisation sweeps.

Counterpart of ``opticalflow_tpu.analysis.sweeps``: ``vary_regularisation``
runs the variational solve for every (speed_alpha, remodelling_alpha) grid
cell, the reference's serial loop of up to 300 solves.  The batched path
flattens (grid cell x frame pair) into the batch axis of
``flow.variational.solve_frame_pair``, whose per-pair alphas go to the
fused kernel as its (B, 2) scalars, and runs the grid in chunks of at
most ``batch_chunk`` solves.

Each chunk's host-checked Krylov and refinement loops run until its
slowest pair stops, so a chunk's wall time is set by its worst cell (the
extreme-alpha corners may run to ``max_iterations``).  Every chunk records
(utils.observability) its largest iteration count as
``sweep/chunk_max_iterations``, the sum of its cells' iteration counts as
``sweep/chunk_cell_iterations`` (a cell's count is its pairs' mean, its
one pair's count in a one-pair sweep), its cell count as
``sweep/chunk_cells``, its cells that end unconverged in the counter
``sweep/unconverged_cells``, and its wall time as the span ``sweep/chunk``.
All of them come from the copies the chunk makes to the host anyway.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.flow.variational import (
    solve_frame_pair,
    solver_kwargs,
    variational_optical_flow,
)
from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.utils import observability
from opticalflow_tpu_torch.utils.device import resolve_device

# Solves per chunk of the batched sweep.  The JAX package caps it at 48, under
# a fault of its TPU worker at 64.  On an H100 (80GB HBM3, 700 W) the
# 300-solve grid of 128x128 pairs ran fastest at 150 of 48, 150 and 300
# (utils/sweep_chunks.py; the table is in PERF.md): the loops are bound by
# host launches, so the chunk that holds the slowest cells sets the time.
DEFAULT_BATCH_CHUNK = 150


def vary_regularisation(
    movie,
    speed_alpha_values=np.arange(500, 2000, 500),
    remodelling_alpha_values=np.arange(500, 2000, 500),
    filename: Optional[str] = None,
    batched: bool = True,
    device=None,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Sweep both regularisation parameters; collect mean/variance of
    speed and remodelling, convergence flags and the total functional.

    ``batched=True`` solves the grid's cells as batches of cold-start pairs
    (:func:`_batched_sweep`); ``batched=False`` is the reference's serial
    loop through ``variational_optical_flow``, which takes all of its
    kwargs.  ``device``: ``None`` is the CUDA device (it raises without
    one), ``'cpu'`` the CPU.  Returns the JAX package's keys as host
    arrays of shape (len(speed_alpha_values), len(remodelling_alpha_values)).
    """
    speed_alpha_values = np.asarray(speed_alpha_values)
    remodelling_alpha_values = np.asarray(remodelling_alpha_values)
    shape = (len(speed_alpha_values), len(remodelling_alpha_values))
    device = resolve_device(device)

    if batched:
        stats = _batched_sweep(movie, speed_alpha_values, remodelling_alpha_values,
                               device=device, **kwargs)
    else:
        stats = {
            "speed_means": np.zeros(shape),
            "speed_variances": np.zeros(shape),
            "remodelling_means": np.zeros(shape),
            "remodelling_variances": np.zeros(shape),
            "converged": np.zeros(shape, dtype=bool),
            "functional": np.zeros(shape),
        }
        for i, a_s in enumerate(speed_alpha_values):
            for j, a_r in enumerate(remodelling_alpha_values):
                result = variational_optical_flow(
                    movie, speed_alpha=float(a_s), remodelling_alpha=float(a_r), device=device,
                    **kwargs)
                stats["speed_means"][i, j] = np.mean(result["speed"])
                stats["speed_variances"][i, j] = np.var(result["speed"])
                stats["remodelling_means"][i, j] = np.mean(result["remodelling"])
                stats["remodelling_variances"][i, j] = np.var(result["remodelling"])
                stats["converged"][i, j] = result["converged"]
                stats["functional"][i, j] = (
                    result["L1_functional"]
                    + result["speed_functional"]
                    + result["remodelling_functional"]
                )

    result_dict = {
        "speed_alpha_values": speed_alpha_values,
        "remodelling_alpha_values": remodelling_alpha_values,
        **stats,
    }
    if filename is not None:
        np.save(filename, result_dict)
    return result_dict


def _chunk_statistics(u, info, n_cells, n_pairs, scale):
    """Per-cell statistics of one chunk's (cells x pairs) solutions."""
    u = u.reshape((n_cells, n_pairs) + u.shape[1:])
    info = {key: value.reshape(n_cells, n_pairs) for key, value in info.items()}
    speed = torch.sqrt((u[:, :, 0] * scale) ** 2 + (u[:, :, 1] * scale) ** 2)
    remodelling = u[:, :, 2]
    cell_axes = (1, 2, 3)
    return {
        "speed_mean": speed.mean(cell_axes),
        # population statistics, as jnp.var
        "speed_var": speed.var(cell_axes, correction=0),
        "remodelling_mean": remodelling.mean(cell_axes),
        "remodelling_var": remodelling.var(cell_axes, correction=0),
        "converged": info["converged"].all(dim=1),
        # total functional = L1 + speed + remodelling; in compat mode the
        # reference's tuning objective counts the remodelling functional
        # twice instead of speed, kept beside it as functional_ref_compat
        "functional": (info["L1_functional"] + info["speed_functional"]
                       + info["remodelling_functional"]).sum(dim=1),
        "functional_ref_compat": (info["L1_functional"]
                                  + 2.0 * info["remodelling_functional"]).sum(dim=1),
    }


def _batched_sweep(movie, speed_alphas, remodelling_alphas, delta_x=1.0, delta_t=1.0,
                   smoothing_sigma=None, dy_mode="compat", solver=None, dtype=None,
                   batch_chunk=DEFAULT_BATCH_CHUNK, device=None, **unsupported):
    """The grid as chunks of cold-start batched solves.

    Each chunk holds ``batch_chunk // pairs`` cells (at least one); its
    frames are the movie's pairs broadcast over the chunk's cells, and its
    per-pair alphas the cells' alphas repeated over the pairs.  Every
    ``SolverConfig`` field reaches the solve (the JAX package's batched
    sweep passes only method, preconditioner, rtol, max_iterations and
    matvec; with the defaults the two agree).  ``dtype``: float32 when
    ``None``.
    """
    if unsupported:
        raise TypeError(
            f"batched sweep does not support {sorted(unsupported)}; grid cells "
            "are cold-start batched solves (pass batched=False for the serial "
            "variational_optical_flow path, which accepts all of its kwargs)"
        )
    solver = solver or SolverConfig()
    dtype = dtype or torch.float32
    movie = torch.as_tensor(movie).to(device=resolve_device(device), dtype=dtype)
    if smoothing_sigma is not None:
        movie = blur_movie(movie, smoothing_sigma=smoothing_sigma)

    grid = np.array([[a_s, a_r] for a_s in speed_alphas for a_r in remodelling_alphas],
                    dtype=np.float64)
    prev, cur = movie[:-1], movie[1:]
    n_pairs = prev.shape[0]
    cells_per_chunk = max(1, int(batch_chunk) // max(n_pairs, 1))
    u_init = torch.zeros((3,) + tuple(movie.shape[1:]), dtype=dtype, device=movie.device)
    kw = solver_kwargs(solver)
    chunk_outs = []
    for lo in range(0, grid.shape[0], cells_per_chunk):
        t0 = time.perf_counter()
        alphas = torch.as_tensor(grid[lo : lo + cells_per_chunk], dtype=dtype,
                                 device=movie.device)
        n_cells = alphas.shape[0]
        frames = (n_cells * n_pairs,) + tuple(prev.shape[1:])
        # cell-major (cell, pair) order; a view for one pair, else one copy
        u, info = solve_frame_pair(
            prev.expand((n_cells,) + prev.shape).reshape(frames),
            cur.expand((n_cells,) + cur.shape).reshape(frames),
            u_init, alphas[:, 0].repeat_interleave(n_pairs),
            alphas[:, 1].repeat_interleave(n_pairs), dy_mode=dy_mode, **kw)
        stats = _chunk_statistics(u, info, n_cells, n_pairs, delta_x / delta_t)
        chunk_outs.append({key: value.cpu().numpy() for key, value in stats.items()})
        # every slot's count in one copy, where a read of their maximum was
        iterations = info["iterations"].cpu().numpy().reshape(n_cells, n_pairs)
        max_iterations = int(iterations.max())
        converged = int(chunk_outs[-1]["converged"].sum())
        seconds = time.perf_counter() - t0
        observability.record_value("sweep/chunk_max_iterations", max_iterations)
        observability.record_value("sweep/chunk_cell_iterations", iterations.mean(axis=1).sum())
        observability.record_value("sweep/chunk_cells", n_cells)
        observability.add_count("sweep/unconverged_cells", n_cells - converged)
        observability.record_span("sweep/chunk", seconds)
        observability.logger.info(
            "sweep chunk of %d cells x %d pairs: %.3fs, max iterations %d, converged %d/%d",
            n_cells, n_pairs, seconds, max_iterations, converged, n_cells)
    out = {key: np.concatenate([c[key] for c in chunk_outs]) for key in chunk_outs[0]}
    shape = (len(speed_alphas), len(remodelling_alphas))
    return {
        "speed_means": out["speed_mean"].reshape(shape),
        "speed_variances": out["speed_var"].reshape(shape),
        "remodelling_means": out["remodelling_mean"].reshape(shape),
        "remodelling_variances": out["remodelling_var"].reshape(shape),
        "converged": out["converged"].reshape(shape),
        "functional": out["functional"].reshape(shape),
        "functional_ref_compat": out["functional_ref_compat"].reshape(shape),
    }
