"""A/B of the port's kernels B1, B2 and B3 against another version of their
sources, on one card:

    python -m opticalflow_tpu_torch.utils.kernel_ab OTHER_CSRC_DIR

builds the kernels that ``OTHER_CSRC_DIR`` holds (e.g. the ``csrc`` of an
older checkout, unpacked with ``git archive``) beside this checkout's
build (``cuda_kernels.build``), then, at every shape a path launches, each
at K = 1 and the multigrid probes' K = 27 (B1: 11 pairs of 254x254 (the
bench), one pair of 510x510 (the command line), 150 pairs of 126x126 (the
sweep's chunk), one pair of 1022x1022 (the 1024x1024 pair); B2: one pair
of 1022x1022 (the hybrid solve) and 11 x 254x254; B3: the 1022x1022
interior as one tile (mesh (1, 1, 1)), as the windows route's 2 x 2
tiles of 511x511 in one launch, and one exchange-route launch on a tile of
511x511 and the halo lines ``spmd.exchange_halos`` gives it; compat), checks whether both builds give
bitwise the same output (and prints the largest relative difference per
field, max|this - other| / max|other|), and times each on the device alone,
every launch through the wrappers' checks (CUDA-graph replays,
:func:`cuda_timing.device_ms`), warm (operands in L2 where they fit) and
cold (L2 evicted before every launch), in turns other, this, this, other,
for ``--rounds`` rounds.  Prints one line per case with the median of each
build, their ratio, the call's bound (bytes over 3.35 TB/s or operations
over 67 TFLOP/s of float32, whichever is larger; the share of it each build
reaches) and the card's name and power limit.  Exits non-zero when an
output is not bitwise equal to the other build's.

B3 is called in the form each build takes: a ``csrc`` whose C entry point
is ``el_matvec_extended`` (before B3 read tiles in place) on pre-extended
(m+2, n+2) blocks cut from one extension of the field, whose outputs are
laid back into the field to be compared; one with ``el_matvec_tiled`` on
the field itself, or on one tile and its halo lines, written in place.  The bound counts the
operands of the later form.
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
from opticalflow_tpu_torch.ops import elop
from opticalflow_tpu_torch.parallel import spmd
from opticalflow_tpu_torch.parallel.mesh import make_mesh
from opticalflow_tpu_torch.utils.cuda_timing import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (HBM3)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FLOPS_PER_PIXEL = 110  # float32 operations per output pixel of el_stencil.cuh
# B3's C entry point before it read tiles in place: pre-extended blocks,
# the argument types of B1's
LEGACY_B3 = ("el_matvec_extended", ck.ENTRY_POINTS["el_matvec.cu"][1], ())
# (label, pairs, K, m, form): m x m interiors; form "pairs" for B1 and B2;
# B3 "one tile" (mesh (1, 1, 1)), "windows" (2 x 2 tiles in one launch),
# "lines" (tile (0, 0) of 2 x 2 and its halo lines)
CASES = [(label, pairs, K, m, form)
         for label, pairs, m, form in [("B1", 11, 254, "pairs"), ("B1", 1, 510, "pairs"),
                                       ("B1", 150, 126, "pairs"), ("B1", 1, 1022, "pairs"),
                                       ("B2", 1, 1022, "pairs"), ("B2", 11, 254, "pairs"),
                                       ("B3", 1, 1022, "one tile"), ("B3", 1, 1022, "windows"),
                                       ("B3", 1, 1022, "lines")]
         for K in (1, 27)]
ENTRIES = {"B1": "el_matvec_reduced_fused", "B2": "el_matvec_plain_core"}
TILES = {"one tile": (1, 1), "windows": (2, 2), "lines": (2, 2)}


def _operands(pairs: int, K: int, m: int, dev):
    """Normalised blob frames (pairs, m+2, m+2), (pairs, 2) scalars and a
    random (pairs, K, 3, m, m) field (K = 1: (pairs, 3, m, m))."""
    movie, _ = make_translating_blob_movie(n_frames=pairs, dimension=m + 2,
                                           width=20.0 * (m + 2) / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    frames = torch.from_numpy(movie.astype(np.float32)).to(dev)
    I = (frames / frames.flatten(1).amax(1)[:, None, None]).contiguous()
    scalars = torch.tensor([[0.1, 1000.0]] * pairs, device=dev)
    shape = (pairs, 3, m, m) if K == 1 else (pairs, K, 3, m, m)
    u = torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(7))
    return I, scalars, u


def bound_us(pairs: int, K: int, m: int, form: str = "pairs") -> float:
    """The least time of the call, in us: the bytes it must move (I blocks,
    scalars, the field planes and, in the lines form, the halo lines read
    once, the output planes written once) over the card's memory rate, or
    its operations over the float32 rate, whichever is larger."""
    tx, ty = TILES.get(form, (1, 1))
    mt, nt = m // tx, m // ty
    N = pairs * (1 if form == "lines" else tx * ty)  # frame blocks of the call
    pixels = N * mt * nt
    lines = 2 * (nt + 2) + 2 * mt if form == "lines" else 0
    nbytes = 4 * (N * (mt + 2) * (nt + 2) + 2 * N + 3 * K * (2 * pixels + N * lines))
    return max(nbytes / HBM_BYTES_PER_S, FLOPS_PER_PIXEL * K * pixels / F32_FLOPS_PER_S) * 1e6


def rel_diff_per_field(y: torch.Tensor, ref: torch.Tensor):
    """max|y - ref| / max|ref| of each of the three fields."""
    return [((y[..., q, :, :] - ref[..., q, :, :]).abs().max()
             / ref[..., q, :, :].abs().max()).item() for q in range(3)]


def b3_calls(library, I, scalars, u, form: str):
    """(launch, result) of B3 from ``library`` in ``form`` on the field
    ``u``: ``launch()`` runs one checked launch; ``result()`` the last
    launch's output, as the whole field ("one tile", "windows") or tile
    (0, 0) ("lines")."""
    tx, ty = TILES[form]
    mt, nt = u.shape[-2] // tx, u.shape[-1] // ty
    I_t = spmd.to_tiles(I, tx, ty).contiguous()
    s_t = scalars.repeat_interleave(tx * ty, dim=0).contiguous()
    if form == "lines":
        I_t, s_t = I_t[:1].contiguous(), s_t[:1].contiguous()
    box = {}
    if LEGACY_B3[0] in library:  # pre-extended blocks
        fn = library[LEGACY_B3[0]]
        u_ext = spmd.to_tiles(elop.extend_interior(u), tx, ty)
        u_ext = (u_ext[:1] if form == "lines" else u_ext).contiguous()
        K = u.shape[1] if u.dim() == 5 else 1

        def launch():
            out = u_ext.new_empty(u_ext.shape[:-2] + (mt, nt))
            rc = ck._call(fn, u.device, K, (I_t.data_ptr(), s_t.data_ptr(), u_ext.data_ptr(),
                                            out.data_ptr(), I_t.shape[0], K, mt, nt, 1))
            if rc != 0:
                raise RuntimeError(f"{LEGACY_B3[0]} kernel launch failed: cudaError {rc}")
            box["out"] = out

        def result():
            y = box["out"]
            return y if form == "lines" else spmd.from_tiles(y, u.shape[0], tx, ty)

        return launch, result
    if form == "lines":  # the exchange route's halo lines of tile (0, 0), on one card
        devices = make_mesh([u.device] * (tx * ty), frames=1, tx=tx, ty=ty).devices[0]
        halo = spmd.exchange_halos(spmd.split_tiles(u, devices))[0][0]
        out = torch.full_like(u, float("nan"))
        window, tile = (t[..., :mt, :nt] for t in (out, u))

        def launch():
            ck._launch_tiled(I_t, s_t, tile, True, halo=halo, out=window, library=library)

        return launch, lambda: window

    def launch():
        box["out"] = ck._launch_tiled(I_t, s_t, u, True, (tx, ty), library=library)

    return launch, lambda: box["out"]


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
    other = os.path.abspath(args.other_csrc)
    with open(os.path.join(other, "el_matvec_ext.cu")) as fh:
        legacy = "el_matvec_tiled" not in fh.read()
    entries = dict(ck.ENTRY_POINTS, **({"el_matvec_ext.cu": LEGACY_B3} if legacy else {}))
    libraries = {"other": ck.build(other, entries), "this": ck.load_library()}
    print(f"other build: {other} (B3 on {'pre-extended blocks' if legacy else 'tiles in place'})",
          flush=True)
    failed = False
    for label, pairs, K, m, form in CASES:
        I, scalars, u = _operands(pairs, K, m, dev)
        if label == "B3":
            calls = {name: b3_calls(lib, I, scalars, u, form) for name, lib in libraries.items()}
        else:
            calls = {}
            for name, lib in libraries.items():
                box = {}

                def launch(lib=lib, box=box):
                    box["out"] = ck._launch(ENTRIES[label], I, scalars, u, True, library=lib)

                calls[name] = launch, (lambda box=box: box["out"])
        outs = {}
        for name, (launch, result) in calls.items():
            launch()
            outs[name] = result().clone()
        same = torch.equal(outs["other"], outs["this"])
        rel = rel_diff_per_field(outs["this"], outs["other"])
        failed |= not same
        del outs
        launches = 100 if pairs * K * m * m < 3e7 else 20
        med = {}
        for cold in (False, True):
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    times[name].append(device_ms(calls[name][0], launches=launches, cold=cold))
            med[cold] = {name: statistics.median(t) * 1e3 for name, t in times.items()}
            med[cold]["runs"] = {name: [round(x * 1e3, 3) for x in t] for name, t in times.items()}
        b = bound_us(pairs, K, m, form)
        shape = f"{pairs} x {m}x{m}" if form == "pairs" else f"{m}x{m} {form}"
        timing = "; ".join(
            f"{mode} us other {med[c]['other']:.3f} this {med[c]['this']:.3f} (this/other "
            f"{med[c]['this'] / med[c]['other']:.4f}; share other {b / med[c]['other']:.3f} this "
            f"{b / med[c]['this']:.3f}; runs {med[c]['runs']})"
            for mode, c in (("warm", False), ("cold", True)))
        print(f"{label} {shape} K={K}: bitwise equal {same}, max rel diff per field "
              f"{', '.join(f'{r:.3e}' for r in rel)}; bound {b:.3f} us; {timing}  [{card}]",
              flush=True)
        del I, scalars, u, calls
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
