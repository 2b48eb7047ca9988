"""Wall time of the 300-solve regularisation sweep at several chunk sizes.

    python -m opticalflow_tpu_torch.utils.sweep_chunks [--chunks 48 150 300]

Runs ``analysis.sweeps.vary_regularisation(batched=True)`` on one GPU over
the grid of BASELINE config 5 (the JAX package's ``bench.py`` sweep
section): one 128x128 pair made as ``bench.py::make_movie(2, 128)`` (blob
width 20, sigma 3, v = (0.15, 0.1), x100, rounded through float32), 15 x 20
alphas on ``logspace(1, 5)``, rtol 1e-6.  After a 2 x 2 warm-up sweep, each
``batch_chunk`` runs the whole grid once on ``movie + 1e-4``; one line per
chunk size gives its wall time (host clock; the sweep returns host arrays,
so it ends synchronised), solves/s, the number of chunks, converged cells,
each chunk's largest iteration count and seconds, and kernel B1's launches,
with the card's name and power limit from nvidia-smi.

``--costs`` first prints what one iteration of the sweep's solve costs at
a chunk of 300 cells and of 26 (the grid's first cells): milliseconds per
call (CUDA events, the host's launches included) of the fused matvec
(B1), the multigrid V-cycle, the refinement's df32 operator and residual
as the solve runs them (kernel B4) and their plain versions (the torch ops
the refinement ran before B4), and the wall time of 50 main BiCGStab
iterations.  ``--costs --chunks`` (no chunk size) prints the costs alone.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from opticalflow_tpu_torch import SolverConfig
from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.utils import observability

SPEED_ALPHAS = np.logspace(1, 5, 15)
REMODELLING_ALPHAS = np.logspace(1, 5, 20)


def sweep_movie() -> np.ndarray:
    """``bench.py::make_movie(2, 128)`` as float32."""
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=128, width=20.0, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def timed_sweep(movie: np.ndarray, batch_chunk: int):
    """One whole-grid batched sweep on the card; returns (result, seconds,
    per-chunk max iterations, per-chunk seconds, B1 launches, plain calls)."""
    observability.reset()
    launches, plain = ck.LAUNCHES, ck.PLAIN_CALLS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = vary_regularisation(movie, SPEED_ALPHAS, REMODELLING_ALPHAS, batched=True,
                                 solver=SolverConfig(rtol=1e-6), batch_chunk=batch_chunk)
    seconds = time.perf_counter() - t0
    its = [int(v) for v in observability.values()["sweep/chunk_max_iterations"]]
    chunk_s = observability.span_statistics()["sweep/chunk"]
    return (result, seconds, its, chunk_s, ck.LAUNCHES - launches, ck.PLAIN_CALLS - plain)


def op_costs(movie: np.ndarray, card: str, batches=(300, 26)):
    """Per-call costs of the sweep solve's operators at each batch size."""
    import functools

    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.solve import multigrid
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms

    dev = torch.device("cuda")
    frames = torch.from_numpy(movie + 1e-4).to(dev)
    grid = torch.tensor([[a, b] for a in SPEED_ALPHAS for b in REMODELLING_ALPHAS],
                        dtype=torch.float32, device=dev)
    for n in batches:
        prev, cur = frames[0].expand(n, 128, 128), frames[1].expand(n, 128, 128)
        a_s, a_r = grid[:n, 0], grid[:n, 1]
        scale = frames[0].max()
        p, c = prev / scale, cur / scale
        pair = elop.compute_frame_pair_data(p, c, a_s / scale**2, a_r, "compat")
        matvec = variational._make_matvec("auto", p, a_s / scale**2, a_r, "compat", pair.coeffs)
        hierarchy = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), 126, 126,
                                    torch.float32)
        ops = ck.pack_df32(elop.compute_frame_pair_data_df(prev, cur, a_s, a_r, "compat",
                                                           scale.expand(n)))
        gen = torch.Generator(dev).manual_seed(0)
        u = torch.randn(n, 3, 126, 126, device=dev, generator=gen)
        u_lo = u * 1e-8 * torch.randn(n, 3, 126, 126, device=dev, generator=gen)
        v_cycle = functools.partial(multigrid.v_cycle, hierarchy, sweeps=2)
        costs = {"B1": call_ms(lambda: matvec(u), 20), "V-cycle": call_ms(lambda: v_cycle(u), 5),
                 "df32 operator (B4)": call_ms(lambda: ck.el_matvec_df32(ops, u), 20),
                 "df32 operator plain": call_ms(lambda: ck.el_matvec_df32_ref(ops, u), 5),
                 "df32 residual (B4)": call_ms(lambda: ck.el_residual_df32(ops, u, u_lo), 20),
                 "df32 residual plain": call_ms(lambda: ck.el_residual_df32_ref(ops, u, u_lo), 5)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # 50 main iterations: a tolerance no pair reaches
        variational.solve_frame_pair(prev, cur, torch.zeros(3, 128, 128, device=dev), a_s, a_r,
                                     rtol=1e-30, tol_floor=0.0, max_iterations=50,
                                     refinement_restarts=0)
        torch.cuda.synchronize()
        per_iteration = (time.perf_counter() - t0) / 50 * 1e3
        print(f"{n} cells of 128x128: ms per call " + ", ".join(
            f"{k} {v:.3f}" for k, v in costs.items())
            + f"; main BiCGStab iteration {per_iteration:.1f} ms (50 iterations, set-up "
              f"included)  [{card}]", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", type=int, nargs="*", default=[48, 150, 300])
    parser.add_argument("--costs", action="store_true",
                        help="first print the per-call costs of the solve's operators")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ck.load_library()
    movie = sweep_movie()
    vary_regularisation(movie, SPEED_ALPHAS[7:9], REMODELLING_ALPHAS[7:9])  # warm-up
    if args.costs:
        op_costs(movie, card)
    n = SPEED_ALPHAS.size * REMODELLING_ALPHAS.size
    for chunk in args.chunks:
        result, seconds, its, chunk_s, launches, plain = timed_sweep(movie + 1e-4, chunk)
        print(f"batch_chunk {chunk}: {seconds:.3f} s, {n / seconds:.3f} solves/s, "
              f"{len(its)} chunks, converged {int(result['converged'].sum())}/{n}, chunk max "
              f"iterations {its}, chunk seconds total {chunk_s['total']:.3f} max "
              f"{chunk_s['max']:.3f}, B1 launches {launches}, plain calls {plain}  [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
