"""A/B of the port's kernels B1, B2 and B3 against another version of their
sources, on one card:

    python -m opticalflow_tpu_torch.utils.kernel_ab OTHER_CSRC_DIR

builds the kernels that ``OTHER_CSRC_DIR`` holds (e.g. the ``csrc`` of an
older checkout, unpacked with ``git archive``) beside this checkout's
build (``cuda_kernels.build``), then, at every shape PERF.md times (B1: 11
pairs of 254x254, one pair of 510x510 (the command line's), 150 pairs of
126x126 (the sweep's chunk), each at K = 1 and 27, and one pair of
1022x1022 at K = 1; B2: 11 x 254x254 and 1 x 1022x1022; B3: the 1022x1022
interior as one pre-extended tile; compat), checks whether both builds give
bitwise the same output (and prints the largest relative difference per
field, max|this - other| / max|other|), and times each on the device alone,
every launch through ``cuda_kernels._launch`` and its checks (CUDA-graph
replays, :func:`cuda_timing.device_ms`) in turns other, this, this, other,
for ``--rounds`` rounds.  Prints one line per case with the median of each
build, their ratio, the call's bound (bytes over 3.35 TB/s; the share of it
each build reaches) and the card's name and power limit.  Exits non-zero
when an output differs by more than ``REL_LIMIT`` of its field.
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (HBM3)
REL_LIMIT = 1e-6  # largest relative difference per field the two builds may show
# (kernel, label, pairs, K, m): m x m interiors
CASES = [("el_matvec_reduced_fused", "B1", 11, 1, 254),
         ("el_matvec_reduced_fused", "B1", 11, 27, 254),
         ("el_matvec_reduced_fused", "B1", 1, 1, 510),
         ("el_matvec_reduced_fused", "B1", 1, 27, 510),
         ("el_matvec_reduced_fused", "B1", 150, 1, 126),
         ("el_matvec_reduced_fused", "B1", 150, 27, 126),
         ("el_matvec_reduced_fused", "B1", 1, 1, 1022),
         ("el_matvec_plain_core", "B2", 11, 1, 254),
         ("el_matvec_plain_core", "B2", 1, 1, 1022),
         ("el_matvec_extended", "B3", 1, 1, 1022)]


def _operands(pairs: int, K: int, m: int, extended: bool, dev):
    movie, _ = make_translating_blob_movie(n_frames=pairs, dimension=m + 2,
                                           width=20.0 * (m + 2) / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    frames = torch.from_numpy(movie.astype(np.float32)).to(dev)
    I = (frames / frames.flatten(1).amax(1)[:, None, None]).contiguous()
    scalars = torch.tensor([[0.1, 1000.0]] * pairs, device=dev)
    halo = 2 if extended else 0
    shape = (pairs, 3, m + halo, m + halo) if K == 1 else (pairs, K, 3, m + halo, m + halo)
    u = torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(7))
    return I, scalars, u


def bound_us(pairs: int, K: int, m: int, extended: bool) -> float:
    """Bytes the call must move (I, scalars and the field planes read once,
    the output planes written once) over the card's memory rate, in us."""
    field = (m + 2) ** 2 if extended else m * m
    nbytes = 4 * (pairs * (m + 2) ** 2 + 2 * pairs + 3 * pairs * K * (field + m * m))
    return nbytes / HBM_BYTES_PER_S * 1e6


def rel_diff_per_field(y: torch.Tensor, ref: torch.Tensor):
    """max|y - ref| / max|ref| of each of the three fields."""
    return [((y[..., q, :, :] - ref[..., q, :, :]).abs().max()
             / ref[..., q, :, :].abs().max()).item() for q in range(3)]


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
    for entry, label, pairs, K, m in CASES:
        extended = entry == "el_matvec_extended"
        I, scalars, u = _operands(pairs, K, m, extended, dev)

        def call(name):
            """One checked launch of ``entry`` from build ``name``."""
            return ck._launch(entry, I, scalars, u, True, extended, library=libraries[name])

        outs = {name: call(name) for name in libraries}
        same = torch.equal(outs["other"], outs["this"])
        rel = rel_diff_per_field(outs["this"], outs["other"])
        failed |= max(rel) > REL_LIMIT
        del outs
        times = {"other": [], "this": []}
        launches = 100 if pairs * K * m * m < 3e7 else 20
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                times[name].append(device_ms(lambda name=name: call(name), launches=launches))
        med = {name: statistics.median(t) * 1e3 for name, t in times.items()}
        b = bound_us(pairs, K, m, extended)
        print(f"{label} {pairs} x {m}x{m} K={K}: bitwise equal {same}, max rel diff per field "
              f"{', '.join(f'{r:.3e}' for r in rel)}; device us per launch other "
              f"{med['other']:.3f} (runs {[round(t * 1e3, 3) for t in times['other']]}), this "
              f"{med['this']:.3f} (runs {[round(t * 1e3, 3) for t in times['this']]}), "
              f"this/other {med['this'] / med['other']:.4f}; bound {b:.3f} us, share other "
              f"{b / med['other']:.3f} this {b / med['this']:.3f}  [{card}]", flush=True)
        del I, scalars, u
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
