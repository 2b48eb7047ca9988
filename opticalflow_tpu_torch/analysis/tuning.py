"""Hyperparameter tuning of the regularisation strengths.

Counterpart of ``opticalflow_tpu.analysis.tuning``: minimise the total
functional (L1 + speed + remodelling) over log10(alpha_s), log10(alpha_r)
with scipy's shgo global optimizer.  Two objectives:

* ``use_direct_solver=True`` — the assembled float64 solve on the host
  (``solve.direct``; robust at extreme alphas, small movies only);
* ``use_direct_solver=False`` — the solve on ``device`` through
  ``variational_optical_flow`` (the fused kernel on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.flow.variational import variational_optical_flow
from opticalflow_tpu_torch.utils.device import resolve_device


def total_functional(result) -> float:
    return float(
        result["L1_functional"]
        + result["speed_functional"]
        + result["remodelling_functional"]
    )


def optimize_regularisation_parameters(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    bounds: Sequence[Tuple[float, float]] = ((-1, 8), (1, 8)),
    smoothing_sigma: Optional[float] = None,
    initial_v_x: float = 0.0,
    initial_v_y: float = 0.0,
    initial_remodelling: float = 0.0,
    use_direct_solver: bool = True,
    dy_mode: str = "compat",
    solver: Optional[SolverConfig] = None,
    shgo_kwargs: Optional[dict] = None,
    verbose: bool = False,
    device=None,
):
    """shgo over log10-regularisation bounds; returns (optimal alphas,
    minimum functional, scipy result).  ``device``: ``None`` is the CUDA
    device (it raises without one), ``'cpu'`` the CPU.  The direct
    objective reads the movie in float64 (the device objective in float32,
    ``variational_optical_flow``'s default)."""
    import scipy.optimize

    device = resolve_device(device)

    def objective(log10_params):
        a_s = float(np.power(10.0, log10_params[0]))
        a_r = float(np.power(10.0, log10_params[1]))
        result = variational_optical_flow(
            movie,
            delta_x=delta_x,
            delta_t=delta_t,
            speed_alpha=a_s,
            remodelling_alpha=a_r,
            smoothing_sigma=smoothing_sigma,
            initial_v_x=initial_v_x,
            initial_v_y=initial_v_y,
            initial_remodelling=initial_remodelling,
            use_direct_solver=use_direct_solver,
            dy_mode=dy_mode,
            solver=solver,
            dtype=torch.float64 if use_direct_solver else None,
            device=device,
        )
        value = total_functional(result)
        if verbose:
            print(f"alphas=({a_s:.4g}, {a_r:.4g}) functional={value:.6g}")
        return value

    opt = scipy.optimize.shgo(objective, bounds=list(bounds), **(shgo_kwargs or {}))
    optimal = np.power(10.0, opt.x)
    return optimal, float(opt.fun), opt
