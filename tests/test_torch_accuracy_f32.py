"""The port's accuracy gate in the reference's TPU mode: float32 fields with
float32 Krylov reductions (``high_precision_reductions=False``), every pair
against the float64 assembled direct solve (``solve/direct.py``), EPE (max
endpoint error over interior pixels) < 1e-3 px, the JAX package's own bar
(``tests/test_accuracy_gate.py``).

The counterpart of that file's two gates at sizes the CPU suite affords
(~25 s together on one thread): one cold pair of 128x128 (there 256x256)
and a cold batch of 6 pairs of 128x128 solved together (there 12), on the
bench's movie (``bench.make_movie``: blob width 20, sigma 3, v = (0.15,
0.1), x100 and rounded through float32, so the oracle sees the same
frames).  The 256x256 pair is left to the card (``chip_smoke.py`` phase
4): on the CPU its float32 refinement stops one step short of the
tolerance with PyTorch's own summation order of the dots and converges
with four others, so a gate there would pin a summation order, not the
solve.
"""

from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

EPE_LIMIT_PX = 1e-3
ALPHAS = dict(speed_alpha=1000.0, remodelling_alpha=1000.0)
F32_REDUCTIONS = SolverConfig(high_precision_reductions=False)


def _movie(n_frames, dim):
    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=dim, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def _epe_per_pair(movie, warm_start):
    kw = dict(ALPHAS, warm_start=warm_start, device="cpu")
    ours = variational_optical_flow(movie, dtype=torch.float32, solver=F32_REDUCTIONS, **kw)
    oracle = variational_optical_flow(movie.astype(np.float64), dtype=torch.float64,
                                      use_direct_solver=True, **kw)
    assert ours["converged_all"].all(), ours["converged_all"]
    d = np.hypot(ours["v_x"] - oracle["v_x"], ours["v_y"] - oracle["v_y"])
    return d[:, 1:-1, 1:-1].max(axis=(1, 2))


def test_f32_reductions_one_pair_under_the_gate():
    epes = _epe_per_pair(_movie(2, 128), "cold")
    assert epes.shape == (1,) and epes[0] < EPE_LIMIT_PX, epes


def test_f32_reductions_cold_batch_every_pair_under_the_gate():
    epes = _epe_per_pair(_movie(7, 128), "cold")
    assert epes.shape == (6,) and (epes < EPE_LIMIT_PX).all(), epes
