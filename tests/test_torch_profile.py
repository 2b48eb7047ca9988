"""The port's ``profile_solve_phases``: the JAX package's phase keys
(``opticalflow_tpu/flow/variational.py::profile_solve_phases``), each a
non-negative duration, recorded as ``solve/<phase>`` spans.  The port
times each phase directly (synchronised host timers, best of ``reps``
solves), so the phases of one solve add up to at most its total."""

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch import SolverConfig
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow import variational as pvar
from opticalflow_tpu_torch.utils import observability

JAX_KEYS = ("pair_data", "mg_setup", "krylov_main", "refinement", "host_transfer", "total")


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_profile_solve_phases_keys_and_spans(method):
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=24, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    movie = (movie * 100.0).astype(np.float32)
    observability.reset()
    phases = pvar.profile_solve_phases(movie[0], torch.from_numpy(movie[1]),
                                       solver=SolverConfig(method=method), reps=2,
                                       device="cpu")
    assert tuple(phases) == JAX_KEYS
    assert all(v >= 0.0 for v in phases.values())
    assert phases["krylov_main"] > 0.0 and phases["refinement"] > 0.0
    solve = sum(phases[k] for k in ("pair_data", "mg_setup", "krylov_main", "refinement"))
    assert solve + phases["host_transfer"] <= phases["total"]
    stats = observability.span_statistics()
    for key, seconds in phases.items():
        assert stats[f"solve/{key}"]["count"] == 1
        assert stats[f"solve/{key}"]["total"] == pytest.approx(seconds)
