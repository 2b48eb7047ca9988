"""How far the float32 solve ends from the float64 one at the refinement
exit, and how that distance moves with summation orders, the multigrid
route and the exit factor.  Two studies, one JSON line per run:

    python -m opticalflow_tpu_torch.utils.exit_band sweep [--devices cpu cuda]
    python -m opticalflow_tpu_torch.utils.exit_band strip [--threads 1 2 4 8]

``sweep``: the 2 x 2 regularisation grid of
``tests/test_torch_gpu.py::test_sweep_on_the_card_runs_the_kernel_and_matches_the_cpu``
(alphas {300, 3000} x {500, 5000}) on the 3-frame 40x40 blob movie of that
test (v = (0.15, 0.1), sigma 3) and on three others (other velocities and
widths), batched, in float32 on each device given.  Each run varies:

* the V-cycle's stencil summation order: ``jax`` (the port's:
  ``multigrid.stencil_matvec``, one term at a time in JAX's order) or
  ``library`` (the 27 taps stacked and summed by ``.sum``, an order the
  library chooses); the strip also takes ``partials`` (three partial
  sums, one a field, each in JAX's order, then added);
* on CUDA, the multigrid route: ``kernels`` (B5 and B6, JAX's order) or
  ``torch`` (the plain stages, either order);
* the refinement's exit factor: 0.1 (the default below 500 points), 0.01
  and 0.001.

Each line gives, per statistic (speed mean and variance, remodelling mean,
functional; the grid's four cells), the relative distance from the
float64 sweep on the CPU refined to 0.001 x tol, and its largest.  After
the runs of a movie, for each device other than the CPU, one line per
order and exit factor with its largest relative distance from the CPU's
run (what the test bounds by 1e-4) and, for JAX's order, whether its two
routes agree bit for bit.

``strip``: the 502x22 strip of ``tests/test_torch_flow_large.py`` (500 x
20 interior points, the large-grid branch: FGMRES, 4 sweeps, exit 0.03 x
tol) on the CPU in float32 at each intra-op thread count given, for each
mirror image given (``none``, ``rows``, ``columns``, ``both``: flipping
permutes every reduction's inputs) and each order, against the float64
direct solve of the same image: iterations and EPE (px, max over interior
pixels).  Everything runs on this package alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation
from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.flow import variational
from opticalflow_tpu_torch.solve import multigrid

GRID = ([300.0, 3000.0], [500.0, 5000.0])
KEYS = ("speed_means", "speed_variances", "remodelling_means", "functional")
# (v_x, v_y, sigma); the first is the card test's movie
MOVIES = ((0.15, 0.1, 3.0), (0.2, -0.1, 3.0), (0.1, 0.12, 2.5), (-0.15, 0.05, 3.5))
EXITS = (0.1, 0.01, 0.001)
IMAGES = {"none": (), "rows": (1,), "columns": (2,), "both": (1, 2)}


def library_order_matvec(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``multigrid.stencil_matvec`` with its 27 taps stacked and summed by
    ``.sum``: the same function, summed in an order the library chooses."""
    B, M, N = S.shape[0], S.shape[-2], S.shape[-1]
    upad = F.pad(u, (1, 1, 1, 1))
    taps = torch.stack(
        [upad[..., di : di + M, dj : dj + N] for di in range(3) for dj in range(3)], dim=-3
    ).flatten(-4, -3)  # (B, [K,] 27, M, N), index q*9 + di*3 + dj
    lead = (B,) + (1,) * (u.dim() - 4)
    out = [(S[:, o].reshape(lead + (27, M, N)) * taps).sum(dim=-3) for o in range(3)]
    return torch.stack(out, dim=-3)


def partial_sums_matvec(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``multigrid.stencil_matvec`` summed as three partial sums, one a
    field q (its 9 terms in JAX's order), then added in q's order."""
    M, N = S.shape[-2], S.shape[-1]
    upad = F.pad(u, (1, 1, 1, 1))
    Sk = S if u.dim() == 4 else S[:, None]
    total = None
    for q in range(3):
        acc = None
        for di in range(3):
            for dj in range(3):
                term = Sk[..., q, di, dj, :, :] * upad[..., q : q + 1, di : di + M, dj : dj + N]
                acc = term if acc is None else acc + term
        total = acc if total is None else total + acc
    return total


ORDERS = {"library": library_order_matvec, "partials": partial_sums_matvec}


@contextlib.contextmanager
def variant(order: str, route: Optional[str] = None):
    """Solves inside run the V-cycle's stencil in ``order`` and, where
    ``route`` is given, the multigrid on that route whatever the matvec."""
    saved = multigrid.stencil_matvec, multigrid.ROUTES["torch"], variational.mg_route
    try:
        if order in ORDERS:
            multigrid.stencil_matvec = ORDERS[order]
            multigrid.ROUTES["torch"] = saved[1]._replace(stencil_apply=ORDERS[order])
        if route is not None:
            variational.mg_route = lambda matvec_impl: route
        yield
    finally:
        multigrid.stencil_matvec, multigrid.ROUTES["torch"], variational.mg_route = saved


def blob_movie(v_x: float, v_y: float, sigma: float) -> np.ndarray:
    movie, _ = make_translating_blob_movie(n_frames=3, dimension=40, width=20.0, sigma=sigma,
                                           v_x=v_x, v_y=v_y)
    return (movie * 100.0).astype(np.float32)


def _relative(got: Dict, ref: Dict) -> Dict[str, list]:
    return {k: np.abs(np.asarray(got[k]) / np.asarray(ref[k]) - 1.0).ravel().tolist()
            for k in KEYS}


def sweep_study(devices) -> None:
    # (order, route): on the CPU both routes run the plain stages; on CUDA
    # JAX's order runs on the kernels and on the plain stages, the
    # library's only on the plain stages
    cases = {"cpu": (("jax", None), ("library", None))}
    cuda_cases = (("jax", "kernels"), ("library", "torch"), ("jax", "torch"))
    for index, params in enumerate(MOVIES):
        movie = blob_movie(*params)
        ref = vary_regularisation(movie, *GRID, device="cpu", dtype=torch.float64,
                                  solver=SolverConfig(refinement_exit_factor=0.001))
        runs = {}
        for device in devices:
            for order, route in cases.get(device, cuda_cases):
                for exit_factor in EXITS:
                    with variant(order, route):
                        got = vary_regularisation(
                            movie, *GRID, device=device,
                            solver=SolverConfig(refinement_exit_factor=exit_factor))
                    runs[device, order, route, exit_factor] = got
                    rel = _relative(got, ref)
                    print(json.dumps({"study": "sweep", "movie": index, "v_x_v_y_sigma": params,
                                      "device": device, "order": order, "route": route,
                                      "exit": exit_factor,
                                      "converged": bool(got["converged"].all()),
                                      "vs_float64": rel,
                                      "max": max(max(v) for v in rel.values())}), flush=True)
        # the test's comparison: each device's run of an order against the
        # CPU's; and on CUDA, the kernels against the plain stages
        for (device, order, route, exit_factor), got in runs.items():
            if device == "cpu" or (order, route) == ("jax", "torch"):
                continue
            rel = _relative(got, runs["cpu", order, None, exit_factor])
            line = {"study": "sweep", "movie": index, "between": [device, "cpu"],
                    "order": order, "exit": exit_factor,
                    "max": max(max(v) for v in rel.values()),
                    "speed_variances": rel["speed_variances"]}
            if order == "jax":
                other = runs[device, "jax", "torch", exit_factor]
                line["kernels_equal_torch_route"] = all(
                    np.array_equal(got[k], other[k]) for k in KEYS)
            print(json.dumps(line), flush=True)


def strip_movie() -> np.ndarray:
    """``tests/test_torch_flow_large.py::strip_movie``: columns 241:263 of
    the 2-frame 502x502 blob movie (width 20 * 502 / 256, x100, float32)."""
    dim = 502
    movie, _ = make_translating_blob_movie(n_frames=2, dimension=dim, width=20.0 * dim / 256,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return np.ascontiguousarray((movie * 100.0).astype(np.float32)[:, :, 241:263])


def _epe(a, b) -> float:
    d = np.sqrt((a["v_x"] - b["v_x"]) ** 2 + (a["v_y"] - b["v_y"]) ** 2)
    return float(d[:, 1:-1, 1:-1].max())


def strip_study(threads, images, orders) -> None:
    alphas = dict(speed_alpha=1000.0, remodelling_alpha=1000.0)
    strip = strip_movie()
    before = torch.get_num_threads()
    try:
        for image in images:
            axes = IMAGES[image]
            movie = np.ascontiguousarray(np.flip(strip, axes)) if axes else strip
            torch.set_num_threads(max(threads))
            oracle = variational_optical_flow(movie, dtype=torch.float64, use_direct_solver=True,
                                              device="cpu", **alphas)
            for order in orders:
                for n in threads:
                    torch.set_num_threads(n)
                    t0 = time.perf_counter()
                    with variant(order):
                        ours = variational_optical_flow(movie, dtype=torch.float32,
                                                        device="cpu", **alphas)
                    print(json.dumps({"study": "strip", "image": image, "order": order,
                                      "threads": n, "iterations": ours["iterations"].tolist(),
                                      "converged": bool(ours["converged_all"].all()),
                                      "epe_direct": _epe(ours, oracle),
                                      "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        torch.set_num_threads(before)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="study", required=True)
    sweep = sub.add_parser("sweep", help="the card test's 2 x 2 sweep")
    sweep.add_argument("--devices", nargs="+", default=["cpu"])
    strip = sub.add_parser("strip", help="the 502x22 strip against its direct solve")
    strip.add_argument("--threads", nargs="+", type=int, default=[1, 2, 4, 8])
    strip.add_argument("--images", nargs="+", choices=tuple(IMAGES), default=["none"])
    strip.add_argument("--orders", nargs="+", choices=("jax",) + tuple(ORDERS), default=["jax"])
    args = parser.parse_args(argv)
    print(json.dumps({"torch": torch.__version__, "threads": torch.get_num_threads(),
                      "cpu": torch.backends.cpu.get_cpu_capability(),
                      "cuda": torch.cuda.get_device_name(0) if torch.cuda.is_available()
                      else None}), flush=True)
    if args.study == "sweep":
        sweep_study(args.devices)
    else:
        strip_study(args.threads, args.images, args.orders)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
