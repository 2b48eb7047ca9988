"""A/B of where the solve's time goes on each path, against another
checkout of the package, on one card:

    python -m opticalflow_tpu_torch.utils.refinement_ab OTHER_TREE

``OTHER_TREE`` is the root of another checkout (e.g. an older commit's
``opticalflow_tpu_torch`` unpacked there with ``git archive``).  Each
version runs in processes of its own, its package first on the path: the
quick paths in turns other, this, this, other, the sweep once each, other
then this.  Every solve runs with a phase timer (``solve_frame_pair``'s
``phase_timer``: the device synchronised at each phase's start and end),
so each path gives its wall time (host clock, synchronised), the seconds
of each phase summed over its solves, and the df32 refinement's share of
the wall; its host syncs (``krylov/host_syncs``: every read of the card
by the Krylov loops and the refinement), CUDA graph captures and replays
(``krylov/graph_captures`` / ``krylov/graph_replays``, 0 for a version
without graphs) and the captures' host seconds (the span
``krylov/capture``); and, from one more run of each path in each version's
first process under ``torch.profiler``, its busy share: the card's kernel
time over the wall (this checkout's ``utils/cuda_timing.py::busy_share``,
loaded from its file, whichever package runs).  The paths, as
chip_smoke.py drives them:

* ``bench``: the bench movie (13 frames of 256x256, blob width 20, sigma 3,
  v = (0.15, 0.1), x100 through float32), two-pass, alpha 1000 / 1000;
* ``large``: the 1024x1024 pair (blob width 80), the default solver;
* ``hybrid``: the same pair with ``matvec='hybrid'`` (kernel B2 and the
  boundary ring);
* ``cli``: the command line's 512x512 stack (blob width 40, integer counts
  of peak 100), its first 11 frames: 10 pairs in sequence, FGMRES
  (``--cli-pairs 50``: all 51 frames, the 50 pairs chip_smoke.py's command
  line phase solves);
* ``sweep``: the 300-solve grid of BASELINE config 5 (one 128x128 pair,
  15 x 20 alphas on logspace(1, 5), rtol 1e-6) in chunks of 150 cells, each
  chunk one batched ``solve_frame_pair`` call as
  ``analysis.sweeps.vary_regularisation`` makes it.

``--paths`` runs only the paths named; ``--no-phase-timer`` times the
walls alone, with no device sync between phases, as chip_smoke.py times
its paths.  ``--torch-stages`` adds a third version, ``stages``: this
checkout with every multigrid hierarchy on the ``'torch'`` route (the
plain stages as torch ops in place of kernels B5 and B6, which they equal
bit for bit, so the same iterations), in turns other, this, stages,
stages, this, other and the sweep other, this, stages: this against
stages is the kernels' gain at equal iterations, stages against other
the rest of the change.  Prints one line per path with each version's median wall
time, phase split, refinement share, iterations, converged count and
kernel launches (B4's, B5's and B6's where the version has them), and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

QUICK, SWEEP = ("bench", "large", "hybrid", "cli"), ("sweep",)
ALPHA = 1000.0


def _movie(n_frames, dim, counts=False):
    import numpy as np

    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=dim,
                                           width=20.0 * max(dim, 256) / 256, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    if counts:
        return np.round(movie / movie.max() * 100.0).astype(np.float32)
    return (movie * 100.0).astype(np.float32)


def _busy_share():
    """This checkout's ``cuda_timing.busy_share``, loaded from its file, so
    that a worker running another checkout's package has it too."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_timing.py")
    spec = importlib.util.spec_from_file_location("_cuda_timing_here", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.busy_share


def worker(paths, cli_pairs: int = 10, timed_phases: bool = True,
           torch_stages: bool = False, busy: bool = False) -> None:
    """Runs ``paths`` with the package found first on the path; prints one
    JSON object {path: {wall, phases, iterations, converged, pairs, counts,
    syncs, busy}} (phases empty without ``timed_phases``; busy, the kernel
    seconds over the wall of one more run under the profiler, null without
    ``busy``).  ``torch_stages``: every multigrid hierarchy on the
    ``'torch'`` route."""
    import numpy as np
    import torch

    from opticalflow_tpu_torch import SolverConfig
    from opticalflow_tpu_torch.flow import variational
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import observability

    dev = torch.device("cuda", 0)
    ck.load_library()
    if torch_stages:
        variational.mg_route = lambda matvec_impl: "torch"
    phases = defaultdict(float)

    @contextlib.contextmanager
    def phase(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            phases[name] += time.perf_counter() - t0

    timers = {"phase": phase if timed_phases else None}  # none in the profiled run

    def movie_solve(movie, warm_start, solver):
        m = torch.from_numpy(movie).to(dev)
        u0 = m.new_zeros((3,) + tuple(m.shape[1:]))
        _, info = variational._solve_movie(m, u0, ALPHA, ALPHA, "compat", warm_start,
                                           phase_timer=timers["phase"],
                                           **variational.solver_kwargs(solver))
        return info

    def sweep_solve(movie, solver):
        from opticalflow_tpu_torch.utils.sweep_chunks import REMODELLING_ALPHAS, SPEED_ALPHAS

        m = torch.from_numpy(movie + 1e-4).to(dev)
        grid = torch.tensor([[a, b] for a in SPEED_ALPHAS for b in REMODELLING_ALPHAS],
                            dtype=torch.float32, device=dev)
        u0 = m.new_zeros((3,) + tuple(m.shape[1:]))
        infos = []
        for lo in range(0, grid.shape[0], 150):
            alphas = grid[lo : lo + 150]
            n = alphas.shape[0]
            _, info = variational.solve_frame_pair(
                m[:1].expand(n, *m.shape[1:]), m[1:].expand(n, *m.shape[1:]), u0,
                alphas[:, 0], alphas[:, 1], dy_mode="compat", phase_timer=timers["phase"],
                **variational.solver_kwargs(solver))
            infos.append(info)
        return {k: torch.cat([i[k] for i in infos]) for k in ("iterations", "converged")}

    runs = {"bench": lambda: movie_solve(_movie(13, 256), "two-pass", SolverConfig()),
            "large": lambda: movie_solve(_movie(2, 1024), "sequential", SolverConfig()),
            "hybrid": lambda: movie_solve(_movie(2, 1024), "sequential",
                                          SolverConfig(matvec="hybrid")),
            "cli": lambda: movie_solve(_movie(51, 512, counts=True)[:cli_pairs + 1], "sequential",
                                       SolverConfig()),
            "sweep": lambda: sweep_solve(_movie(2, 128), SolverConfig(rtol=1e-6))}
    movie_solve(_movie(3, 64), "cold", SolverConfig())  # warm-up
    out = {}
    for path in paths:
        phases.clear()
        counters = ("LAUNCHES", "CORE_LAUNCHES", "EXT_LAUNCHES", "DF_LAUNCHES", "MG_LAUNCHES",
                    "MGT_LAUNCHES")
        before = {c: getattr(ck, c, 0) for c in counters}
        observability.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = runs[path]()
        its = info["iterations"].cpu().numpy()  # synchronised
        wall = time.perf_counter() - t0
        counts = observability.counts()
        capture = observability.span_statistics().get("krylov/capture", {"total": 0.0})
        out[path] = {"wall": wall, "phases": dict(phases), "iterations": its.tolist(),
                     "converged": int(np.asarray(info["converged"].cpu()).sum()),
                     "pairs": int(its.size),
                     "counts": {c: getattr(ck, c, 0) - before[c] for c in counters},
                     "syncs": {k: counts.get(f"krylov/{k}", 0)
                               for k in ("host_syncs", "graph_captures", "graph_replays")},
                     "capture_s": capture["total"], "busy": None}
        if busy:
            timers["phase"] = None
            _, busy_wall, kernel_s = _busy_share()(runs[path])
            out[path]["busy"] = {"wall": busy_wall, "kernel_s": kernel_s}
            timers["phase"] = phase if timed_phases else None
    print(json.dumps(out), flush=True)


def run(tree: str, paths, cli_pairs: int, timed_phases: bool, torch_stages: bool = False,
        busy: bool = False) -> dict:
    """One worker process with ``tree``'s package first on the path."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    flags = (["--cli-pairs", str(cli_pairs)] + ([] if timed_phases else ["--no-phase-timer"])
             + (["--torch-stages"] if torch_stages else []) + (["--busy"] if busy else []))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *flags, "--worker", *paths],
                          env=env, capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_tree", nargs="?", help="root of the other checkout")
    parser.add_argument("--paths", nargs="+", choices=QUICK + SWEEP, default=QUICK + SWEEP)
    parser.add_argument("--cli-pairs", type=int, default=10, choices=range(1, 51),
                        metavar="1..50", help="pairs of the cli path (default 10)")
    parser.add_argument("--no-phase-timer", dest="timed_phases", action="store_false",
                        help="walls alone, no device sync between phases")
    parser.add_argument("--torch-stages", action="store_true",
                        help="also this checkout with the multigrid on its plain stages")
    parser.add_argument("--busy", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args.worker, args.cli_pairs, args.timed_phases, args.torch_stages, args.busy)
        return 0
    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"other": args.other_tree, "this": this, "stages": this}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    quick = [p for p in QUICK if p in args.paths]
    sweep = [p for p in SWEEP if p in args.paths]
    names = ("other", "this") + (("stages",) if args.torch_stages else ())
    runs = {name: [] for name in names}
    for name in (names + names[::-1]) if quick else ():
        runs[name].append(run(trees[name], quick, args.cli_pairs, args.timed_phases,
                              name == "stages", busy=not runs[name]))
    for name in names if sweep else ():
        runs[name].append(run(trees[name], sweep, args.cli_pairs, args.timed_phases,
                              name == "stages", busy=True))
    for path in quick + sweep:
        line = []
        for name in names:
            rs = [r[path] for r in runs[name] if path in r]
            walls = [r["wall"] for r in rs]
            med = rs[walls.index(statistics.median_low(walls))]
            split = ", ".join(f"{k} {v:.3f}" for k, v in med["phases"].items())
            its = med["iterations"] if med["pairs"] <= 12 else f"summed {sum(med['iterations'])}"
            busy = next(r["busy"] for r in rs if r["busy"] is not None)
            line.append(f"{name}: wall s {[round(w, 3) for w in walls]}, median run {split}; "
                        f"refinement {med['phases'].get('refinement', 0.0) / med['wall']:.3f} of "
                        f"the wall; iterations {its}, ms per iteration "
                        f"{1e3 * med['wall'] / max(sum(med['iterations']), 1):.3f}, converged "
                        f"{med['converged']}/{med['pairs']}, launches {med['counts']}, "
                        f"{med['syncs']}, captures' host s {med['capture_s']:.3f}; busy "
                        f"{busy['kernel_s'] / busy['wall']:.3f} of the wall under the profiler "
                        f"({busy['kernel_s']:.3f} s of kernels in {busy['wall']:.3f} s)")
        print(f"{path}: " + " | ".join(line) + f"  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
