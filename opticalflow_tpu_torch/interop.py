"""State carried across from the JAX package.

The system has no learned weights: its state is the solver configuration
and the per-pair system data.  Both arrive here as plain Python / numpy
values (the JAX objects converted by the caller), so this module imports no
JAX:

* ``solver_config_from_jax(dataclasses.asdict(cfg))``
* ``coeffs_from_numpy({k: np.asarray(v) for k, v in coeffs._asdict().items()})``
  for an ``ELCoefficients``, or the same dict of a ``FramePairData`` whose
  ``coeffs`` entry is itself such a dict.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from opticalflow_tpu_torch.core.types import SolverConfig
from opticalflow_tpu_torch.ops import elop


def solver_config_from_jax(config: Mapping) -> SolverConfig:
    """The port's ``SolverConfig`` from the JAX one's ``asdict``; unknown
    fields raise."""
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    unknown = set(config) - names
    if unknown:
        raise ValueError(f"fields the port's SolverConfig lacks: {sorted(unknown)}")
    return SolverConfig(**dict(config))


def _tensor(value, dtype, device, batched_ndim: int) -> torch.Tensor:
    """A numpy value as a tensor with a leading pair axis (added when the
    value has only ``batched_ndim - 1`` dimensions)."""
    # a copy: arrays converted from JAX are read-only
    t = torch.tensor(np.asarray(value), dtype=dtype, device=device)
    return t[None] if t.dim() == batched_ndim - 1 else t


def coeffs_from_numpy(arrays: Mapping, dtype=None, device=None):
    """The port's ``ELCoefficients`` or ``FramePairData`` from a dict of
    numpy arrays, one pair (planes (m, n)) or a batch (planes (B, m, n)).
    ``dtype`` defaults to that of the arrays."""
    if "coeffs" in arrays:
        coeffs = coeffs_from_numpy(arrays["coeffs"], dtype, device)
        dtype = coeffs.diag_x.dtype
        return elop.FramePairData(
            coeffs=coeffs,
            rhs=_tensor(arrays["rhs"], dtype, device, 4),
            **{k: _tensor(arrays[k], dtype, device, 3)
               for k in ("dIdx", "dIdy", "dIdt", "I_interior")},
        )
    if dtype is None:
        dtype = torch.from_numpy(np.asarray(arrays["diag_x"])[:0].copy()).dtype
    fields = {}
    for name in elop.ELCoefficients._fields:
        scalar = name in ("speed_alpha", "remodelling_alpha")
        fields[name] = _tensor(arrays[name], dtype, device, 1 if scalar else 3)
    return elop.ELCoefficients(**fields)
