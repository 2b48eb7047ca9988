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
(B1), the multigrid V-cycle (also through the plain stages on the same
hierarchy, and what one V-cycle launches: B1, B5 and B6 and the torch
operations it dispatches), the refinement's df32 operator and residual
as the solve runs them (kernel B4) and their plain versions (the torch ops
the refinement ran before B4), and the wall time of 50 main BiCGStab
iterations after one untimed (set-up and the step's CUDA graph capture
included), with the Krylov loop's exit read every ``krylov.CHUNK`` steps
and read after every step (``CHUNK = 1``): the host syncs of each, the
capture's host seconds,
and what one read costs, the difference of the two walls over the
difference of their syncs; then the card's busy share of the first (its
kernel time over the wall of one more run under ``torch.profiler``,
``cuda_timing.busy_share``).  ``--costs --chunks`` (no chunk size) prints
the costs alone.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict

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


def _sweep_system(movie: np.ndarray, n: int):
    """The first ``n`` cells of the sweep's solve on the card: raw frames
    (n, 128, 128), raw alphas, the intensity scale, the normalised pair
    data, kernel B1's matvec and the multigrid hierarchy (kernel route)."""
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.solve import multigrid

    dev = torch.device("cuda")
    frames = torch.from_numpy(movie + 1e-4).to(dev)
    grid = torch.tensor([[a, b] for a in SPEED_ALPHAS for b in REMODELLING_ALPHAS],
                        dtype=torch.float32, device=dev)
    prev, cur = frames[0].expand(n, 128, 128), frames[1].expand(n, 128, 128)
    a_s, a_r = grid[:n, 0], grid[:n, 1]
    scale = frames[0].max()
    p, c = prev / scale, cur / scale
    pair = elop.compute_frame_pair_data(p, c, a_s / scale**2, a_r, "compat")
    matvec = variational._make_matvec("auto", p, a_s / scale**2, a_r, "compat", pair.coeffs)
    hierarchy = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), 126, 126,
                                torch.float32, route=variational.mg_route("auto"))
    return prev, cur, a_s, a_r, scale, pair, matvec, hierarchy


def v_cycle_counts(v_cycle: Callable, u: torch.Tensor) -> Dict[str, int]:
    """What one call of ``v_cycle(u)`` launches: the launches of kernels B1,
    B5 and B6 (their counters) and the torch operations it dispatches,
    views excluded (a ``TorchDispatchMode``; the kernels, launched through
    ctypes, dispatch none), each a launch or more on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    before = ck.LAUNCHES, ck.MG_LAUNCHES, ck.MGT_LAUNCHES
    with Count() as mode:
        v_cycle(u)
    torch.cuda.synchronize()
    return {"B1": ck.LAUNCHES - before[0], "B5": ck.MG_LAUNCHES - before[1],
            "B6": ck.MGT_LAUNCHES - before[2], "torch ops": mode.ops}


def v_cycle_costs(movie: np.ndarray, n: int, card: str, sweeps: int = 2) -> Dict[str, float]:
    """Milliseconds per V-cycle (CUDA events, the host's launches included)
    at ``n`` cells of the sweep's 126x126 interior, on the kernels (B5, B6)
    and, on the same hierarchy, through the plain stages (route 'torch'),
    with what each launches (:func:`v_cycle_counts`); prints one line."""
    import functools

    from opticalflow_tpu_torch.solve import multigrid
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms

    hierarchy = _sweep_system(movie, n)[-1]
    u = torch.randn(n, 3, 126, 126, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    for route in ("kernels", "torch"):
        v_cycle = functools.partial(multigrid.v_cycle, hierarchy._replace(route=route),
                                    sweeps=sweeps)
        out[route] = call_ms(lambda: v_cycle(u), 5)
        out[f"{route} launches"] = v_cycle_counts(v_cycle, u)
    print(f"V-cycle at {n} cells of 126x126 ({len(hierarchy.levels)} levels, {sweeps} sweeps): "
          f"{out['kernels']:.3f} ms on kernels B5/B6, launching {out['kernels launches']}; "
          f"{out['torch']:.3f} ms through the plain stages, launching {out['torch launches']}  "
          f"[{card}]", flush=True)
    return out


def op_costs(movie: np.ndarray, card: str, batches=(300, 26)):
    """Per-call costs of the sweep solve's operators at each batch size."""
    import functools

    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.solve import krylov, multigrid
    from opticalflow_tpu_torch.utils.cuda_timing import busy_share, call_ms

    dev = torch.device("cuda")
    chunk = krylov.CHUNK
    for n in batches:
        v_cycle_costs(movie, n, card)
        prev, cur, a_s, a_r, scale, pair, matvec, hierarchy = _sweep_system(movie, n)
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

        def main_solve():  # 50 main iterations: a tolerance no pair reaches
            return variational.solve_frame_pair(
                prev, cur, torch.zeros(3, 128, 128, device=dev), a_s, a_r, rtol=1e-30,
                tol_floor=0.0, max_iterations=50, refinement_restarts=0)

        main_solve()  # warm-up: the first capture at this shape allocates its pool
        runs = {}
        for k in (chunk, 1):
            krylov.CHUNK = k
            observability.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            main_solve()
            torch.cuda.synchronize()
            capture = observability.span_statistics().get("krylov/capture", {"total": 0.0})
            runs[k] = ((time.perf_counter() - t0) / 50 * 1e3,
                       observability.counts().get("krylov/host_syncs", 0), capture["total"])
        krylov.CHUNK = chunk
        _, wall, kernel_s = busy_share(main_solve)
        (ms, syncs, capture_s), (ms_1, syncs_1, _) = runs[chunk], runs[1]
        read_ms = (ms_1 - ms) * 50 / max(syncs_1 - syncs, 1)
        print(f"{n} cells of 128x128: ms per call " + ", ".join(
            f"{k} {v:.3f}" for k, v in costs.items())
            + f"; main BiCGStab iteration {ms:.3f} ms (50 iterations, set-up included; "
              f"exit read every {chunk} steps: {syncs} host syncs, the capture "
              f"{capture_s * 1e3:.1f} ms of host time), {ms_1:.3f} ms read every step "
              f"({syncs_1} syncs): a read costs {read_ms:.3f} ms; busy "
              f"{kernel_s / wall:.3f} of the wall under the profiler ({kernel_s * 1e3:.1f} ms "
              f"of kernels in {wall * 1e3:.1f} ms)  [{card}]", flush=True)


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
