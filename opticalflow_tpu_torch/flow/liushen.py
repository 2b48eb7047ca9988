"""Liu-Shen physics-based optical flow (the reference's deprecated Jacobi
path).

Counterpart of ``opticalflow_tpu.flow.liushen``: a fixed count of
synchronous (Jacobi) sweeps of the Liu-Shen equations with a per-pixel 2x2
solve each sweep, as whole-plane arithmetic on every frame pair at once
(a leading pair axis where the JAX package uses ``vmap``, a Python loop
where it uses ``fori_loop``).

Details of the reference kept, as in the JAX package:
* the movie gets a one-pixel zero border, then mirror boundary values;
* the mirror values are re-applied to the velocity planes every sweep;
* the 8-neighbour sum ``V_bar`` leaves out border-ring neighbours while
  ``V_barx`` / ``V_bary`` include them;
* the boundary prefactor is 8 / 5 / 3 (interior / edge / corner);
* remodelling is carried but never updated (the kernel returns its
  initial value).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.core.stencils import mirror_edges
from opticalflow_tpu_torch.core.types import FlowResult
from opticalflow_tpu_torch.ops.blur import blur_movie
from opticalflow_tpu_torch.utils.device import resolve_device


def _interior(f, di, dj):
    """f(i+di, j+dj) on the interior grid of bordered (..., Ni, Nj) planes."""
    ni, nj = f.shape[-2:]
    return f[..., 1 + di : ni - 1 + di, 1 + dj : nj - 1 + dj]


def _prefactor_plane(m, n, like: torch.Tensor) -> torch.Tensor:
    """Boundary prefactor on the interior grid: 8 interior, 5 edges, 3 corners."""
    p = np.full((m, n), 8.0)
    p[0, :] = p[-1, :] = 5.0
    p[:, 0] = p[:, -1] = 5.0
    p[0, 0] = p[0, -1] = p[-1, 0] = p[-1, -1] = 3.0
    return torch.as_tensor(p).to(like)


def _bar8_masked(v):
    """8-neighbour sum with border-ring neighbours left out."""
    vm = F.pad(v[..., 1:-1, 1:-1], (1, 1, 1, 1))
    return (
        _interior(vm, -1, 0) + _interior(vm, +1, 0)
        + _interior(vm, 0, -1) + _interior(vm, 0, +1)
        + _interior(vm, -1, -1) + _interior(vm, -1, +1)
        + _interior(vm, +1, -1) + _interior(vm, +1, +1)
    )


def _central(v):
    """(d/dx, d/dy, d2/dxdy) of bordered planes, on the interior grid."""
    dx = (_interior(v, 1, 0) - _interior(v, -1, 0)) * 0.5
    dy = (_interior(v, 0, 1) - _interior(v, 0, -1)) * 0.5
    dxy = (_interior(v, 1, 1) - _interior(v, 1, -1)
           - _interior(v, -1, 1) + _interior(v, -1, -1)) * 0.25
    return dx, dy, dxy


def liu_shen_pair(
    prev_b: torch.Tensor,
    cur_b: torch.Tensor,
    v_x0: torch.Tensor,
    v_y0: torch.Tensor,
    alpha,
    iterations: int,
):
    """Run ``iterations`` Jacobi sweeps on bordered frame pairs.

    ``prev_b`` / ``cur_b``: (..., Ni+2, Nj+2) mirror-filled bordered frames;
    ``v_x0`` / ``v_y0``: bordered initial velocity planes (pixel units) of
    the same shape.  Returns bordered (v_x, v_y), in the frames' dtype and
    on their device.
    """
    I = _interior(prev_b, 0, 0)
    dIdx, dIdy, dIdxy = _central(prev_b)
    dIdx_t = (_interior(cur_b, 1, 0) - _interior(cur_b, -1, 0)
              - _interior(prev_b, 1, 0) + _interior(prev_b, -1, 0)) * 0.5
    dIdy_t = (_interior(cur_b, 0, 1) - _interior(cur_b, 0, -1)
              - _interior(prev_b, 0, 1) + _interior(prev_b, 0, -1)) * 0.5
    dIdxx = _interior(prev_b, 1, 0) + _interior(prev_b, -1, 0) - 2.0 * I
    dIdyy = _interior(prev_b, 0, 1) + _interior(prev_b, 0, -1) - 2.0 * I

    pref = _prefactor_plane(I.shape[-2], I.shape[-1], I)
    alpha = torch.as_tensor(alpha).to(I)

    # 2x2 system matrix (constant over the sweeps)
    a11 = I * dIdxx - 2.0 * I * I - pref * alpha
    a12 = I * dIdxy
    a22 = I * dIdyy - 2.0 * I * I - pref * alpha
    det = a11 * a22 - a12 * a12

    v_x, v_y = v_x0, v_y0
    for _ in range(iterations):
        v_x = mirror_edges(v_x)
        v_y = mirror_edges(v_y)
        dxdVx, dydVx, dxydVx = _central(v_x)
        dxdVy, dydVy, dxydVy = _central(v_y)
        vx_barx = _interior(v_x, 1, 0) + _interior(v_x, -1, 0)
        vy_bary = _interior(v_y, 0, 1) + _interior(v_y, 0, -1)

        f1 = (
            -I * dIdx_t
            - I * (2.0 * dIdx * dxdVx + dIdy * dxdVy + dIdx * dydVy)
            - I * I * (vx_barx + dxydVy)
            - alpha * _bar8_masked(v_x)
        )
        f2 = (
            -I * dIdy_t
            - I * (2.0 * dIdy * dydVy + dIdx * dydVx + dIdy * dxdVx)
            - I * I * (vy_bary + dxydVx)
            - alpha * _bar8_masked(v_y)
        )
        v_x[..., 1:-1, 1:-1] = (a22 * f1 - a12 * f2) / det
        v_y[..., 1:-1, 1:-1] = (a11 * f2 - a12 * f1) / det
    return v_x, v_y


def liu_shen_movie(movie: torch.Tensor, initial_v_x, initial_v_y, alpha, iterations: int,
                   delta_x: float = 1.0, delta_t: float = 1.0):
    """Every frame pair of a (T, X, Y) movie tensor through ``iterations``
    sweeps, where the movie lies and in its dtype.

    ``initial_v_x`` / ``initial_v_y``: one (X, Y) plane, broadcast to every
    pair, in physical units (scaled by delta_t / delta_x), or a per-pair
    (T-1, X, Y) stack already in pixel units (the continuation form of the
    iteration-recording mode).  Returns (v_x, v_y) stacks (T-1, X, Y) in
    pixel units.
    """
    bordered = mirror_edges(F.pad(movie, (1, 1, 1, 1)))
    n_pairs = movie.shape[0] - 1
    v0x = torch.as_tensor(initial_v_x).to(movie)
    v0y = torch.as_tensor(initial_v_y).to(movie)
    if v0x.dim() == 2:
        v0x = v0x * (delta_t / delta_x)
        v0y = v0y * (delta_t / delta_x)
    shape = (n_pairs,) + tuple(bordered.shape[1:])
    v0x = F.pad(v0x, (1, 1, 1, 1)).expand(shape)
    v0y = F.pad(v0y, (1, 1, 1, 1)).expand(shape)
    v_x, v_y = liu_shen_pair(bordered[:-1], bordered[1:], v0x, v0y, alpha, iterations)
    return v_x[:, 1:-1, 1:-1], v_y[:, 1:-1, 1:-1]


def conduct_variational_optical_flow_deprecated(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    v_x_guess: float = 0.1,
    v_y_guess: float = 0.1,
    remodelling_guess: float = 0.5,
    max_iterations: int = 10,
    smoothing_sigma: Optional[float] = None,
    return_iterations: bool = False,
    iteration_stepsize: int = 1,
    tolerance: float = 1e-10,
    include_remodelling: bool = True,
    use_liu_shen: bool = False,
    dtype=None,
    device=None,
) -> FlowResult:
    """Same arguments and result as the JAX package's deprecated entry point,
    plus ``device`` (``None``: the CUDA device, which must exist; ``'cpu'``:
    the CPU), including the iteration-recording mode of the convergence
    plots.  ``remodelling`` is carried unchanged, as in the reference
    kernel.  ``dtype``: float32 when ``None``.

    ``tolerance`` and ``include_remodelling`` are accepted and ignored, as
    in the reference: its kernel declares both and uses neither (its early
    stop is commented out and it always runs ``max_iterations`` sweeps)."""
    if not use_liu_shen:
        raise ValueError(
            "the deprecated path only supports the Liu-Shen kernel "
            "(matching the reference)"
        )
    dtype = dtype or torch.float32
    movie = torch.as_tensor(movie).to(device=resolve_device(device), dtype=dtype)
    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie, smoothing_sigma=smoothing_sigma)
    else:
        movie_to_analyse = movie

    shape = tuple(movie.shape[1:])
    init_vx = torch.full(shape, float(v_x_guess), dtype=dtype, device=movie.device)
    init_vy = torch.full(shape, float(v_y_guess), dtype=dtype, device=movie.device)
    init_rem = np.full(shape, float(remodelling_guess))
    scale = delta_x / delta_t

    result = FlowResult(
        original_data=movie.cpu().numpy(),
        blurred_data=movie_to_analyse.cpu().numpy(),
        delta_x=delta_x,
        delta_t=delta_t,
    )
    result["max_iterations"] = max_iterations
    n_pairs = movie.shape[0] - 1

    if return_iterations:
        n_records = max_iterations // iteration_stepsize
        vx_steps = np.zeros((n_pairs, n_records + 1) + shape)
        vy_steps = np.zeros_like(vx_steps)
        vx_steps[:, 0] = init_vx.cpu().numpy()
        vy_steps[:, 0] = init_vy.cpu().numpy()
        # incremental continuation, like the reference's recording loop:
        # each record runs `iteration_stepsize` sweeps from the previous
        # record's per-pair state (pixel units)
        v_x, v_y = init_vx, init_vy
        for rec in range(1, n_records + 1):
            v_x, v_y = liu_shen_movie(movie_to_analyse, v_x, v_y, speed_alpha,
                                      iteration_stepsize, delta_x, delta_t)
            vx_steps[:, rec] = v_x.cpu().numpy() * scale
            vy_steps[:, rec] = v_y.cpu().numpy() * scale
        speed_steps = np.sqrt(vx_steps**2 + vy_steps**2)
        rem_steps = np.broadcast_to(init_rem, (n_pairs, n_records + 1) + shape).copy()
        result["v_x_steps"] = vx_steps
        result["v_y_steps"] = vy_steps
        result["speed_steps"] = speed_steps
        result["remodelling_steps"] = rem_steps
        result["iteration_stepsize"] = iteration_stepsize
        result["v_x"] = vx_steps[:, -1]
        result["v_y"] = vy_steps[:, -1]
        result["speed"] = speed_steps[:, -1]
        result["remodelling"] = rem_steps[:, -1]
    else:
        v_x, v_y = liu_shen_movie(movie_to_analyse, init_vx, init_vy, speed_alpha,
                                  max_iterations, delta_x, delta_t)
        result["v_x"] = v_x.cpu().numpy() * scale
        result["v_y"] = v_y.cpu().numpy() * scale
        result["speed"] = np.sqrt(result["v_x"] ** 2 + result["v_y"] ** 2)
        result["remodelling"] = np.broadcast_to(init_rem, (n_pairs,) + shape).copy()

    result["total_iterations"] = max_iterations
    return result
