"""A/B of one application of the sharded solve's tiled matvec, by each
route, against another checkout of the package, on one card:

    python -m opticalflow_tpu_torch.utils.route_ab OTHER_TREE

``OTHER_TREE`` is the root of another checkout (e.g. an older commit's
``opticalflow_tpu_torch`` unpacked there with ``git archive``).  Each
version runs in processes of its own, its package first on the path, in
turns other, this, this, other (``--rounds`` rounds); each process builds
its kernels, then times one application of
``parallel.spmd.make_sharded_kernel_matvec`` on the 1022x1022 interior of
the 1024x1024 bench pair over a (1, 2, 2) mesh of the card, by the windows
route (every tile on the one device) and by the exchange route (forced
with ``as_distinct=True``: the seams handed between tiles, a B3 launch per
tile), at K = 1 and the multigrid probes' K = 27: milliseconds per call of
back-to-back calls, host launches included (``cuda_timing.call_ms``), the
median of each version's runs.  Prints one line per case with both
medians, their ratio and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CASES = [(route, K) for route in ("windows", "exchange") for K in (1, 27)]
DIM = 1024  # the bench's large pair: blob width 80, sigma 3, v = (0.15, 0.1)


def worker() -> None:
    """Times every case with the package found first on the path; prints
    one JSON object {"route K": ms}."""
    import numpy as np
    import torch

    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
    from opticalflow_tpu_torch.parallel import spmd
    from opticalflow_tpu_torch.parallel.mesh import make_mesh
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms

    dev = torch.device("cuda", 0)
    movie, _ = make_translating_blob_movie(n_frames=1, dimension=DIM, width=20.0 * DIM / 256,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    frame = torch.from_numpy((movie * 100.0).astype(np.float32)).to(dev)
    scale = frame.flatten(1).amax(1)
    I = (frame / scale[:, None, None]).contiguous()
    a_s, a_r = 1000.0 / scale**2, torch.full_like(scale, 1000.0)
    mesh = make_mesh([dev] * 4, frames=1, tx=2, ty=2)
    gen = torch.Generator(dev).manual_seed(3)
    times = {}
    for route, K in CASES:
        mv = spmd.make_sharded_kernel_matvec(mesh, I, a_s, a_r, "compat",
                                             as_distinct=route == "exchange")
        shape = (1, 3, DIM - 2, DIM - 2) if K == 1 else (1, K, 3, DIM - 2, DIM - 2)
        u = torch.randn(shape, device=dev, generator=gen)
        times[f"{route} {K}"] = call_ms(lambda: mv(u), 50 if K == 1 else 10)
        del u
        torch.cuda.empty_cache()
    print(json.dumps(times), flush=True)


def run(tree: str) -> dict:
    """One worker process with ``tree``'s package first on the path."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], env=env,
                          capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_tree", nargs="?", help="root of the other checkout")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker()
        return 0
    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            runs[name].append(run(args.other_tree if name == "other" else this))
    for route, K in CASES:
        key = f"{route} {K}"
        med = {name: statistics.median(r[key] for r in rs) for name, rs in runs.items()}
        print(f"tiled matvec, mesh (1, 2, 2), {DIM - 2}x{DIM - 2}, {route} route, K={K}: ms per "
              f"application other {med['other']:.4f} (runs "
              f"{[round(r[key], 4) for r in runs['other']]}), this {med['this']:.4f} (runs "
              f"{[round(r[key], 4) for r in runs['this']]}), this/other "
              f"{med['this'] / med['other']:.3f}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
