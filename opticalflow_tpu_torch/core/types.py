"""Typed data contracts of the port.

A field-for-field copy of ``opticalflow_tpu.core.types`` (``FlowResult``,
``SolverConfig`` and the presets ``VariationalConfig`` and
``BoxFlowConfig``, whose ``run`` takes a ``device``), owned here so that
the port never imports the JAX package: ``opticalflow_tpu/__init__.py``
loads its flow modules, and through them jax, on import.
``tests/test_torch_core.py`` holds the two copies field for field against
each other.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional

import numpy as np


class FlowResult(Mapping):
    """Result of an optical-flow computation.

    Behaves like the reference result dict (mapping access, ``.keys()``,
    ``np.save``-able via :meth:`to_dict`) with typed attribute access for
    the standard fields.  Velocity arrays have shape ``(frames-1, X, Y)``
    and physical units (delta_x/delta_t applied).
    """

    _STANDARD = (
        "v_x",
        "v_y",
        "speed",
        "remodelling",
        "original_data",
        "blurred_data",
        "delta_x",
        "delta_t",
        "converged",
        "L1_functional",
        "remodelling_functional",
        "speed_functional",
    )

    def __init__(self, **entries: Any):
        self._data: Dict[str, Any] = {k: v for k, v in entries.items() if v is not None}

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- typed accessors --------------------------------------------------
    @property
    def v_x(self) -> np.ndarray:
        return self._data["v_x"]

    @property
    def v_y(self) -> np.ndarray:
        return self._data["v_y"]

    @property
    def speed(self) -> np.ndarray:
        return self._data["speed"]

    @property
    def remodelling(self) -> Optional[np.ndarray]:
        return self._data.get("remodelling")

    @property
    def delta_x(self) -> float:
        return float(self._data["delta_x"])

    @property
    def delta_t(self) -> float:
        return float(self._data["delta_t"])

    @property
    def converged(self) -> Optional[bool]:
        value = self._data.get("converged")
        return None if value is None else bool(value)

    # -- conversion / persistence ----------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain dict with host numpy arrays (reference-compatible)."""
        out = {}
        for key, value in self._data.items():
            if type(value).__module__.startswith("torch"):
                out[key] = value.detach().cpu().numpy()
            else:
                out[key] = value
        return out

    def save(self, path: str) -> None:
        """Persist as the reference does: ``np.save(..., allow_pickle)`` of
        the result dict."""
        np.save(path, self.to_dict(), allow_pickle=True)

    @classmethod
    def load(cls, path: str) -> "FlowResult":
        data = np.load(path, allow_pickle=True).item()
        return cls(**data)

    def __repr__(self) -> str:
        shapes = {
            k: (tuple(v.shape) if hasattr(v, "shape") else v) for k, v in self._data.items()
        }
        return f"FlowResult({shapes})"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver configuration; same fields and defaults as the JAX
    package's ``SolverConfig``."""

    # 'auto' picks BiCGStab below 500 interior points on the longest axis
    # and flexible GMRES(restart)+MG at/above it.
    method: str = "auto"  # 'auto' | 'bicgstab' | 'gmres' | 'cg'
    rtol: float = 1e-6  # relative tolerance on the unpreconditioned residual
    atol: float = 0.0
    max_iterations: int = 1000
    preconditioner: str = "multigrid"  # 'none' | 'block_jacobi' | 'multigrid'
    # Dot products / norms accumulate in float64 even when the fields are
    # float32.  The JAX package did so only under x64 (its CPU tests); on
    # its TPU they ran in float32.  The port always honours the flag.
    high_precision_reductions: bool = True
    # The convergence test floors the tolerance at ``dtype_tol_floor *
    # eps(dtype) * ||b||`` — the attainable accuracy of f32 BiCGStab on
    # these systems.
    dtype_tol_floor: float = 300.0
    # Maximum iterative-refinement steps after the main solve (df32 true
    # residual, correction solved to `refinement_rtol`).
    refinement_restarts: int = 8
    refinement_rtol: float = 0.2
    # Refinement exits at ``refinement_exit_factor * tol``; ``None``
    # resolves by grid size: 0.1 below 500 interior points on the longest
    # axis, 0.03 at/above.
    refinement_exit_factor: Optional[float] = None
    # FGMRES restart length.
    gmres_restart: int = 32
    # Matvec implementation.  'auto' and 'pallas' select the fused
    # hand-written CUDA kernel (ops.cuda_kernels); 'hybrid' the plain-stencil
    # CUDA kernel with the boundary ring overwritten in torch; 'xla' the
    # plain stencil on precomputed coefficient planes (ops.elop); 'gspmd'
    # the plain stencil too, as in the JAX package.  The sharded solve
    # (parallel.batch) maps the same names onto a mesh: 'pallas' the tiled
    # kernel B3, 'xla' the tiled plain stencil, 'auto' B1 untiled.
    matvec: str = "auto"  # 'auto' | 'xla' | 'pallas' | 'hybrid' | 'gspmd'


@dataclasses.dataclass(frozen=True)
class VariationalConfig:
    """Reusable preset of the variational solve; same fields and defaults
    as the JAX package's.  ``config.run(movie)`` solves with them."""

    delta_x: float = 1.0
    delta_t: float = 1.0
    speed_alpha: float = 1.0
    remodelling_alpha: float = 1000.0
    smoothing_sigma: Optional[float] = None
    initial_v_x: float = 0.0
    initial_v_y: float = 0.0
    initial_remodelling: float = 0.0
    # 'sequential' (the reference's warm-start chain), 'cold' or 'two-pass'
    warm_start: str = "sequential"
    dy_mode: str = "compat"
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    dtype: Any = None  # None: the solver's default, float32

    def run(self, movie, device=None) -> FlowResult:
        """The variational solve of ``movie`` with this preset on ``device``
        (``None``: the CUDA device, which must exist; ``'cpu'``: the CPU)."""
        from opticalflow_tpu_torch.flow.variational import variational_optical_flow

        return variational_optical_flow(
            movie,
            delta_x=self.delta_x,
            delta_t=self.delta_t,
            speed_alpha=self.speed_alpha,
            remodelling_alpha=self.remodelling_alpha,
            smoothing_sigma=self.smoothing_sigma,
            initial_v_x=self.initial_v_x,
            initial_v_y=self.initial_v_y,
            initial_remodelling=self.initial_remodelling,
            dy_mode=self.dy_mode,
            warm_start=self.warm_start,
            solver=self.solver,
            dtype=self.dtype,
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class BoxFlowConfig:
    """Reusable preset of the box-method flow; same fields and defaults as
    the JAX package's.  ``config.run(movie)`` runs the flow with them."""

    boxsize: int = 15
    delta_x: float = 1.0
    delta_t: float = 1.0
    smoothing_sigma: Optional[float] = None
    background: Optional[float] = None
    include_remodelling: bool = False

    def run(self, movie, device=None) -> FlowResult:
        """The box-method flow of ``movie`` with this preset on ``device``
        (``None``: the CUDA device, which must exist; ``'cpu'``: the CPU)."""
        from opticalflow_tpu_torch.flow.boxflow import conduct_optical_flow

        return conduct_optical_flow(
            movie,
            boxsize=self.boxsize,
            delta_x=self.delta_x,
            delta_t=self.delta_t,
            smoothing_sigma=self.smoothing_sigma,
            background=self.background,
            include_remodelling=self.include_remodelling,
            device=device,
        )
