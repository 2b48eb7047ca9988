"""A/B of the port's kernels B1, B2, B3 and B4 against another version of
their sources, on one card:

    python -m opticalflow_tpu_torch.utils.kernel_ab OTHER_CSRC_DIR [--kernels B4]

builds the kernels that ``OTHER_CSRC_DIR`` holds (e.g. the ``csrc`` of an
older checkout, unpacked with ``git archive``) beside this checkout's
build (``cuda_kernels.build``), then, at every shape a path launches, each
at K = 1 and the multigrid probes' K = 27 (B1: 11 pairs of 254x254 (the
bench), one pair of 510x510 (the command line), 150 pairs of 126x126 (the
sweep's chunk), one pair of 1022x1022 (the 1024x1024 pair); B2: one pair
of 1022x1022 (the hybrid solve) and 11 x 254x254; B3: the 1022x1022
interior as one tile (mesh (1, 1, 1)), as the windows route's 2 x 2
tiles of 511x511 in one launch, and one exchange-route launch on a tile of
511x511 and the halo lines ``spmd.exchange_halos`` gives it; compat;
B4 at each shape of ``DF32_SHAPES``, both dy rules, operator and residual
mode, on a blob's packed df32 data (``df32_cases.blob_operands``)),
checks whether both builds give
bitwise the same output (and prints the largest relative difference per
field, max|this - other| / max|other|), and times each on the device alone,
every launch through the wrappers' checks (CUDA-graph replays,
:func:`cuda_timing.device_ms`), warm (operands in L2 where they fit) and
cold (L2 evicted before every launch), in turns other, this, this, other,
for ``--rounds`` rounds.  Prints one line per case with the median of each
build, their ratio, the call's bound (bytes over 3.35 TB/s or operations
over 67 TFLOP/s of float32, whichever is larger; the share of it each build
reaches; for B4 also the issue ceiling, its operations one issue slot
each, and each B4 build's registers, spills and resident warps an SM) and
the card's name and power limit.  Exits non-zero when an output is not
bitwise equal to the other build's (bits compared for B4: signed zeros
and NaN).  ``--kernels`` picks the kernels (default all).

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
from opticalflow_tpu_torch.utils import df32_cases
from opticalflow_tpu_torch.utils.cuda_timing import (F32_FLOPS_PER_S, HBM_BYTES_PER_S,
                                                     device_ms)

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
# B4's path shapes: (pairs, m, the path that launches it); m x m interiors
DF32_SHAPES = [(11, 254, "256x256 bench"), (1, 1022, "1024x1024"), (150, 126, "sweep"),
               (1, 510, "command line")]
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


def _timed_ab(calls, launches: int, rounds: int):
    """Device us of each build's launch, warm and cold, in turns other,
    this, this, other for ``rounds`` rounds: {cold: {name: median, "runs":
    {name: [us, ...]}}}."""
    med = {}
    for cold in (False, True):
        times = {"other": [], "this": []}
        for _ in range(rounds):
            for name in ("other", "this", "this", "other"):
                times[name].append(device_ms(calls[name][0], launches=launches, cold=cold))
        med[cold] = {name: statistics.median(t) * 1e3 for name, t in times.items()}
        med[cold]["runs"] = {name: [round(x * 1e3, 3) for x in t] for name, t in times.items()}
    return med


def _report(case: str, same: bool, rel, b: float, med, card: str, issue: float = 0.0) -> None:
    """One line of a case: bitwise equality, relative differences, each
    build's median warm and cold, its share of the bound ``b`` and, where
    ``issue`` is given, of that issue ceiling (us)."""
    def shares(t, name):
        text = f"share {name} {b / t[name]:.3f}"
        return text + (f" (issue ceiling {issue / t[name]:.3f})" if issue else "")

    timing = "; ".join(
        f"{mode} us other {med[c]['other']:.3f} this {med[c]['this']:.3f} (this/other "
        f"{med[c]['this'] / med[c]['other']:.4f}; {shares(med[c], 'other')}, "
        f"{shares(med[c], 'this')}; runs {med[c]['runs']})"
        for mode, c in (("warm", False), ("cold", True)))
    if issue:
        timing = f"issue ceiling {issue:.3f} us; {timing}"
    print(f"{case}: bitwise equal {same}, max rel diff per field "
          f"{', '.join(f'{r:.3e}' for r in rel)}; bound {b:.3f} us; {timing}  [{card}]",
          flush=True)


def _outputs(calls):
    outs = {}
    for name, (launch, result) in calls.items():
        launch()
        outs[name] = result().clone()
    return outs


def matvec_ab(libraries, rounds: int, card: str, dev, labels) -> bool:
    """B1, B2 and B3 (those of ``labels``) at every shape of ``CASES``;
    whether every output was bitwise equal."""
    ok = True
    for label, pairs, K, m, form in CASES:
        if label not in labels:
            continue
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
        outs = _outputs(calls)
        same = torch.equal(outs["other"], outs["this"])
        rel = rel_diff_per_field(outs["this"], outs["other"])
        ok &= same
        del outs
        med = _timed_ab(calls, 100 if pairs * K * m * m < 3e7 else 20, rounds)
        shape = f"{pairs} x {m}x{m}" if form == "pairs" else f"{m}x{m} {form}"
        _report(f"{label} {shape} K={K}", same, rel, bound_us(pairs, K, m, form), med, card)
        del I, scalars, u, calls
        torch.cuda.empty_cache()
    return ok


def b4_usage(library, log: str, dev) -> str:
    """Registers, spills and resident warps an SM of B4's instances in one
    build (its ptxas log, and its occupancy query where it has one)."""
    parts = []
    for name, use in ck.ptxas_usage(log).items():
        if "el_df32" in name:
            parts.append(f"{name}: {use['registers']} registers, {use['smem_bytes']} bytes smem, "
                         f"spills {use['spill_stores']} / {use['spill_loads']} bytes")
    for P in (24, 26):
        for residual in (False, True):
            warps = ck.df32_warps_per_sm(P, residual, dev, library=library)
            if warps is not None:
                parts.append(f"P={P} {'residual' if residual else 'operator'}: {warps} warps an SM")
    return "; ".join(parts) or "no ptxas log (built before this process)"


def df32_ab(libraries, rounds: int, card: str, dev) -> bool:
    """B4 at each path shape of ``DF32_SHAPES``, both dy rules and both
    modes: bitwise output, device us warm and cold in turns, the share of
    the bound and of the issue ceiling; whether every output was bitwise
    equal."""
    ok = True
    for pairs, m, path in DF32_SHAPES:
        for dy_mode in ("compat", "fixed"):
            ops, x_hi, x_lo = df32_cases.blob_operands(pairs, m, dy_mode, dev)
            P = ops.planes.shape[1]
            for mode in ("operator", "residual"):
                lo = x_lo if mode == "residual" else None
                calls = {}
                for name, lib in libraries.items():
                    box = {}

                    def launch(lib=lib, box=box, lo=lo):
                        box["out"] = ck._launch_df32(ops, x_hi, lo, library=lib)

                    calls[name] = launch, (lambda box=box: box["out"])
                outs = _outputs(calls)
                same = df32_cases.bitwise_equal(outs["other"], outs["this"])
                rel = rel_diff_per_field(outs["this"], outs["other"])
                ok &= same
                del outs
                med = _timed_ab(calls, 20 if pairs * m * m > 1e6 else 100, rounds)
                _report(f"B4 {mode} {dy_mode} (P = {P}) {pairs} x {m}x{m} ({path})", same, rel,
                        df32_cases.bound(pairs, m, m, P, mode == "residual")[0], med, card,
                        df32_cases.issue_us(pairs, m, m))
                del calls
            del ops, x_hi, x_lo
            torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_csrc", help="csrc directory of the other version")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--kernels", default="B1,B2,B3,B4",
                        help="comma-separated kernels to compare (default all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    labels = set(args.kernels.split(","))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other_csrc)
    with open(os.path.join(other, "el_matvec_ext.cu")) as fh:
        legacy = "el_matvec_tiled" not in fh.read()
    entries = dict(ck.ENTRY_POINTS, **({"el_matvec_ext.cu": LEGACY_B3} if legacy else {}))
    libraries, logs = {}, {}
    for name, build in (("other", lambda: ck.build(other, entries)), ("this", ck.load_library)):
        ck.BUILD_LOG = ""
        libraries[name] = build()
        logs[name] = ck.BUILD_LOG
    print(f"other build: {other} (B3 on {'pre-extended blocks' if legacy else 'tiles in place'})",
          flush=True)
    ok = matvec_ab(libraries, args.rounds, card, dev, labels)
    if "B4" in labels:
        if "el_df32" not in libraries["other"]:
            raise SystemExit(f"kernel_ab: {other} has no el_df32.cu")
        for name in ("other", "this"):
            print(f"B4 {name} build: {b4_usage(libraries[name], logs[name], dev)}", flush=True)
        ok &= df32_ab(libraries, args.rounds, card, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
