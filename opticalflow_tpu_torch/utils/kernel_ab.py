"""A/B of the port's kernels B1 and B2 against another version of their
sources, on one card:

    python -m opticalflow_tpu_torch.utils.kernel_ab OTHER_CSRC_DIR

builds the kernels that ``OTHER_CSRC_DIR`` holds (e.g. the ``csrc`` of an
older checkout, unpacked with ``git archive``) beside this checkout's
build (``cuda_kernels.build``), then, at the shapes of the
bench cell and of the 1024x1024 pair (11 pairs of 254x254 and 1 pair of
1022x1022, K = 1, compat), checks that both builds give bitwise the same
output and times each on the device alone, every launch through
``cuda_kernels._launch`` and its checks (CUDA-graph replays of 100
launches, :func:`cuda_timing.device_ms`) in turns other, this, this,
other, for ``--rounds`` rounds.  Prints one line per case with the median
of each build and their ratio, and the card's name and power limit.  Exits
non-zero when an output differs.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from opticalflow_tpu_torch.core.synth import make_translating_blob_movie
from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.utils.cuda_timing import device_ms

LABELS = {"el_matvec_reduced_fused": "B1", "el_matvec_plain_core": "B2"}


def _operands(pairs: int, m: int, dev):
    movie, _ = make_translating_blob_movie(n_frames=pairs, dimension=m + 2,
                                           width=20.0 * (m + 2) / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    frames = torch.from_numpy(movie.astype(np.float32)).to(dev)
    I = (frames / frames.flatten(1).amax(1)[:, None, None]).contiguous()
    scalars = torch.tensor([[0.1, 1000.0]] * pairs, device=dev)
    u = torch.randn(pairs, 3, m, m, device=dev, generator=torch.Generator(dev).manual_seed(7))
    return I, scalars, u


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_csrc", help="csrc directory of the other version")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libraries = {"other": ck.build(os.path.abspath(args.other_csrc)), "this": ck.load_library()}
    failed = False
    for pairs, m in ((11, 254), (1, 1022)):
        I, scalars, u = _operands(pairs, m, dev)
        for entry, label in LABELS.items():
            def call(name, entry=entry):
                """One checked launch of ``entry`` from build ``name``."""
                return ck._launch(entry, I, scalars, u, True, library=libraries[name])

            outs = {name: call(name) for name in libraries}
            same = torch.equal(outs["other"], outs["this"])
            failed |= not same
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    times[name].append(device_ms(lambda name=name: call(name)))
            med = {name: statistics.median(t) * 1e3 for name, t in times.items()}
            print(f"{label} {pairs} x {m}x{m} K=1: bitwise equal {same}; device us per launch "
                  f"other {med['other']:.3f} (runs {[round(t * 1e3, 3) for t in times['other']]}),"
                  f" this {med['this']:.3f} (runs {[round(t * 1e3, 3) for t in times['this']]}),"
                  f" this/other {med['this'] / med['other']:.4f}  [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
