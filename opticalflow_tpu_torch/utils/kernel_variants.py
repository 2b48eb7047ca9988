"""Kernel B1 with some of its compile-time constants replaced, timed beside
this checkout's build on one card:

    python -m opticalflow_tpu_torch.utils.kernel_variants \\
        '{"stages3": {"kStages": 3}, "solve8": {"kWarpsSolve": 8}}'

writes each variant's ``el_tiles.cuh`` (and ``el_matvec.cu``,
``el_stencil.cuh``) under ``_build/variants/NAME``, builds it (``cuda_kernels.build``, which prints
nothing but keeps ptxas's registers and spills in ``BUILD_LOG``, shown
here), then at each B1 shape of :mod:`kernel_ab` checks whether its output
equals this build's bitwise and times every build on the device alone
(CUDA-graph replays, :func:`cuda_timing.device_ms`) in turns this,
variants..., then the reverse, for ``--rounds`` rounds.  Prints one line
per shape with each build's median, its share of the bound, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

from opticalflow_tpu_torch.ops import cuda_kernels as ck
from opticalflow_tpu_torch.utils.cuda_timing import device_ms
from opticalflow_tpu_torch.utils.kernel_ab import CASES, _operands, bound_us

ENTRY = "el_matvec_reduced_fused"


def write_variant(name: str, constants: dict) -> str:
    """The csrc directory of one variant of B1: el_tiles.cuh with each
    ``constexpr int NAME = ...;`` of ``constants`` set to its value."""
    directory = os.path.join(ck.BUILD_DIR, "variants", name)
    os.makedirs(directory, exist_ok=True)
    for source in ("el_stencil.cuh", "el_matvec.cu"):
        shutil.copy(os.path.join(ck.SOURCE_DIR, source), directory)
    with open(os.path.join(ck.SOURCE_DIR, "el_tiles.cuh")) as fh:
        source = fh.read()
    for constant, value in constants.items():
        source, count = re.subn(rf"constexpr int {constant} = [^;]+;",
                                f"constexpr int {constant} = {int(value)};", source)
        if count != 1:
            raise ValueError(f"el_tiles.cuh has no constexpr int {constant}")
    with open(os.path.join(directory, "el_tiles.cuh"), "w") as fh:
        fh.write(source)
    return directory


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", help='JSON: {"name": {"kStages": 3, ...}, ...}')
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libraries = {"this": ck.load_library()}
    for name, constants in json.loads(args.variants).items():
        libraries[name] = ck.build(write_variant(name, constants))
        ptxas = [line.strip() for line in ck.BUILD_LOG.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"{name} {constants}: " + "; ".join(ptxas), flush=True)
    dev = torch.device("cuda", 0)
    for label, pairs, K, m, _ in CASES:
        if label != "B1":
            continue
        I, scalars, u = _operands(pairs, K, m, dev)

        def call(name):
            return ck._launch(ENTRY, I, scalars, u, True, library=libraries[name])

        reference = call("this")
        same = {name: torch.equal(call(name), reference) for name in libraries}
        times = {name: [] for name in libraries}
        launches = 100 if pairs * K * m * m < 3e7 else 20
        order = list(libraries)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                times[name].append(device_ms(lambda name=name: call(name), launches=launches))
        b = bound_us(pairs, K, m)
        cells = []
        for name in libraries:
            med = statistics.median(times[name]) * 1e3
            cells.append(f"{name} {med:.3f} us ({b / med:.2f}{'' if same[name] else ', differs'})")
        print(f"{label} {pairs} x {m}x{m} K={K}, bound {b:.3f} us: " + "; ".join(cells)
              + f"  [{card}]", flush=True)
        del I, scalars, u, reference
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
