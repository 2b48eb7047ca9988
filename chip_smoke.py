#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit (fails without a CUDA device);
2. build every kernel from ``opticalflow_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, with the
   time per call of each (CUDA events), at the shapes of both paths (the
   solves' K = 1 and the multigrid probes' K = 27, at 254x254 and
   1022x1022 interiors, and a ragged one): the fused matvec (B1) and the
   plain-stencil core (B2), each also timed on the device, warm and with
   the L2 evicted, at every shape its paths launch; and the hybrid matvec
   (B2 plus the boundary ring) against B1's plain version; then the df32
   refinement's kernel B4 (residual and operator mode, both dy rules)
   against its plain versions bit for bit (the bits compared) at the
   shapes the refinement launches it (11 x 254x254, 1 x 1022x1022, the
   sweep's 150 x 126x126, the command line's 1 x 510x510), each timed on
   the device warm and cold beside its bound and its issue ceiling, at
   shapes that end mid-tile (3 x 61x190, 2 x 17x33) and the 2x2 minimum,
   and on adversarial operands (signed zeros, subnormal low parts, mixed
   exponents, NaN from an overflowing split; 70,000 pairs of 2x2, more
   than 65,535 blocks); its registers, spills and warps an SM printed;
   then the multigrid V-cycle's kernels B5 (smoothing sweeps, level-0
   epilogue, stencil apply) and B6 (residual-and-restrict, prolong-and-add,
   and at a probed level the last pre-sweep fused into the
   residual-and-restrict and the prolong-add into the first post-sweep)
   against their plain versions bit for bit at every level shape each
   path's V-cycle launches (the bench's 11 x 254x254 and 127-16, the
   sweep's 150 x 126x126 and 63-16, the command line's 510, 255 and 128,
   the 1024x1024 pair's 1022, 511 and 256), a ragged 3 x 61x190, 2x2 and
   1x1, the setup's probes at K = 27 and the coarsest operator's K = 192;
   B5's level-0 and level-1 launches and every B6 instance at each path's
   level 0 and level 1, and the setup's transfers at K = 27, timed warm
   and cold beside their bound (R y and P e beside ``F.conv2d`` /
   ``F.conv_transpose2d``); and one V-cycle at the sweep's chunk timed, on
   the kernels and through the plain stages, with what each launches (22
   kernels on the kernels, checked), then captured as a Krylov step is
   into a CUDA graph and replayed: 22 launches counted a replay, no plain
   call, the eager V-cycle's bits; then FGMRES's Gram-Schmidt and update,
   kernel B7, against their plain versions at the two-pass cell's 1 and
   49 pairs of 3 x 510x510 (columns 0, 15 and 31 of restart 32), each
   timed warm and cold beside its bound, its plain version and the four
   float64 ``torch.bmm`` products the port ran before (``library_ms``);
4. the 256x256 path once warm and once timed: ``variational_optical_flow``
   on the bench movie (13 frames of 256x256, 12 pairs, two-pass warm
   start, alpha_s = alpha_r = 1000), with every kernel's counters set to 0
   just before the timed run and read just after, and the flow of pairs 1
   and 11 held against the float64 assembled direct solve; then the same
   solve with its Krylov steps run on the card without capture (the
   private ``krylov._uncaptured``): the graphed run's flow, iterations,
   residuals and flags bit for bit; then the same
   solve in the reference's TPU mode, float32 Krylov reductions
   (``high_precision_reductions=False``): 12/12 converged, B1 launched, and
   pairs 1 and 11 within 1e-3 px of the same oracle; then the phase split
   (``profile_solve_phases``) of pair 0's solve, with the df32
   refinement's share;
5. the 1024x1024 path (the large-grid branch: FGMRES(32), 4-sweep
   multigrid, refinement with FGMRES correction solves): one pair of the
   1024x1024 embryo-scale movie, first solved once in float64 as the
   oracle (FGMRES to rtol 1e-10, plain matvec), then in float32 with the
   defaults, once with ``matvec='hybrid'`` (B2) and once with the default
   fused matvec (B1), the counters set to 0 just before each and read just
   after, each held to EPE < 1e-3 px against the oracle; then the phase
   split (``profile_solve_phases``) of the hybrid and the default solve,
   with the refinement's share;
6. the sharded path (``parallel``): kernel B3 against its plain versions
   at the shapes the tiled matvec gives it, in each operand form (the
   whole field in one launch over its tiles: the 1022x1022 interior as one
   tile and as 2 x 2 tiles of 511x511, 11 x 254x254, a ragged 2 x 61x190;
   one tile and its four halo lines written into its window of the
   result, as the exchange route launches it: tile (0, 0) of 511x511, and
   a ragged 1 x 2 tiling of 61x190; the JAX kernel's pre-extended blocks),
   K = 1 and 27, the tiled matvec against B1's plain version on the
   (1, 1, 1) and (1, 2, 2) meshes of the one card, timed beside B1, and
   on (1, 2, 2) the exchange route (the route of tiles on distinct GPUs,
   forced on the one card) bitwise against the windows route, each timed
   per application; then the 1024x1024 pair solved by
   ``sharded_variational_solve`` with ``matvec='pallas'`` on both meshes
   (counters set to 0 just before each and read just after: B3 launched,
   B1, B2 and every plain version not), each converged and held to EPE <
   1e-3 px against phase 5's oracle; then the distinct-device routes on
   the one card: the bench movie's 12 pairs on a (2, 1, 1) mesh over the
   card twice, in serial blocks and in two worker threads, in turns (B1
   launched; bitwise equal; both wall times), and the 1024x1024 pair by
   the exchange route on (1, 2, 2) (bitwise equal to the windows route, 4
   B3 launches for each of its one, the seam copies counted); then, on a
   machine with two or more GPUs, the (2, 1, 1) frames mesh and a (1, 2,
   1) tile mesh over cuda:0 and cuda:1, each bitwise equal to one card
   (on one GPU a line says so); and ``distributed_variational_solve`` in
   a world of one (a gloo process group on 127.0.0.1, the solve on the
   card) on the bench movie, equal
   to ``sharded_variational_solve``'s result within 1e-6 px, then again
   with the default solver (``'auto'``: B1 launched, no other kernel and
   no plain version);
7. the sweep path (``analysis.sweeps.vary_regularisation``, batched): the
   300-solve grid of BASELINE config 5 (one 128x128 pair, 15 x 20 alphas
   on logspace(1, 5), rtol 1e-6) once timed after a 2 x 2 warm-up, the
   counters set to 0 just before it and read just after (B1 launched, no
   plain version), solves/s, chunks, converged cells and each chunk's
   largest iteration count, every statistic finite on the converged cells,
   and three interior cells held against the serial path
   (``batched=False``), then the grid again with its Krylov steps
   uncaptured: every statistic, flag and chunk's largest iteration count
   bit for bit the graphed run's; phase 3 holds B1 against its plain version at the
   sweep's chunk shape (the default chunk's 150 pairs of 126x126, K = 1
   and 27) and times it (as it times B1 at the bench's 11 pairs of 254x254
   at K = 27);
8. the other analyses on the bench movie: box flow (with and without
   remodelling), the box-size and blur-size sweeps at their defaults on
   pair (3, 4), Liu-Shen (10 sweeps), CLAHE, the adaptive threshold and the
   area resize, each on the card and on the CPU, held to a stated bound;
9. the command line (``analysis.drivers``) on files: which host packages
   this machine has (matplotlib, pandas, cv2, PIL, tifffile; ffmpeg, g++);
   a 51-frame 512x512 stack (BASELINE config 3) written as an uncompressed
   16-bit multi-page TIFF of integer counts, and a 13-frame 256x256 PGM
   folder, read back exactly through ``io.sequences`` on the native loader
   (built with g++); then ``variational`` on the TIFF with the actin
   geometry (delta_x 0.0913, delta_t 10) and the CLI's defaults (alpha
   1000 / 1000, sequential warm start, FGMRES(32) at this size): every pair
   converged, B1 launched and no plain version, the saved result equal to
   the returned one, pairs 0-2 equal to a direct ``variational_optical_flow``
   of frames 0-3 within 1e-6 relative, pair 0 within 1e-3 px of the float64
   FGMRES oracle; ``sweep`` on frames 0:2 (3 x 3 alphas, 9 solves); ``box``
   (boxsize 31, sigma 3) under ``--profile``, equal to a direct
   ``conduct_optical_flow``, with its trace written.  Where matplotlib is
   installed each subcommand runs whole through ``drivers.main``; where it
   is not, the drivers' compute-and-save steps run and the plot steps are
   named as not drawn.  Phase 3 holds B1 against its plain version at the
   command line's shape (one pair of 510x510, K = 1 and 27) and times it.

Every solve of phases 4-7 and 9 refines through kernel B4 and runs its
V-cycles on kernels B5 and B6: each path run counts their launches beside
its matvec kernel's and fails where B4, B5 or B6 did not launch or any
plain version ran (the float64 oracles, matvec ``'xla'``, run the plain
stages and are not path runs).  Every Krylov solve on the card (BiCGStab,
CG, FGMRES: the main solve and each correction solve of the refinement)
replays its step from a CUDA graph captured once a solve: each path run
prints its host syncs, graph captures, replays and the captures' host
seconds, and fails where it replayed none; the one exception is the
exchange route of phase 6 (its matvec copies between devices), which
keeps the eager loop and fails where it captured.

The second-to-last line is a JSON object with one entry per kernel: its
launches in each path's run (``launches_by_path``) and their sum
(``launches``); its largest error against its plain version; at its timed
shape (B1 and B2: 11 pairs of 254x254; B3: the 1022x1022 interior as one
tile; K = 1; B4: the operator at 11 pairs of 254x254; B5: the sweep and
B6: the sweep-residual-restrict on the sweep's level 1, 150 x 63x63), its
device time per
launch warm (``ms``, CUDA-graph replays
on operands left in L2) and cold (``cold_ms``, the L2 evicted before every
launch), the plain version's (``plain_ms``), both per back-to-back call
(``call_ms``, ``plain_call_ms``), the least time the card could take
(``bound_ms``: the larger of the bytes moved over 3.35 TB/s and the
operations over 67 TFLOP/s of float32, ``bound_by``), and ``library_ms``
(B6's R y and P e: ``F.conv2d`` / ``F.conv_transpose2d``; null for the
others: no single PyTorch call computes the EL stencil, the df32
residual, a block-Jacobi sweep or a residual with its transfer), its
registers per compiled instance (``registers``, ptxas's count in this
run's build; null where the library was already built);
for B4 also its spill bytes (``spill_bytes``, null likewise) and its
resident warps an SM per mode (``warps_per_sm``); the same timing keys at
every other shape a path launches: B1 under ``at_bench_shape`` (K = 27),
``at_large_shape``, ``at_sweep_shape`` and ``at_cli_shape``, B2 under
``at_bench_shape`` and ``at_large_shape``, B3-B6 under ``at_path_shape``
(B3: each operand form and K; B4: each mode and shape; B5: each path's
timed launches; B6: every instance at each path's level 0 and 1, and the
setup's transfers).
The last line is ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

import importlib.util
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REL_TOL = 1e-5  # per field: max|kernel - plain| <= REL_TOL * max|plain| (both f32)
EPE_LIMIT_PX = 1e-3  # flow endpoint error vs the f64 direct solve / f64 FGMRES oracle
N_FRAMES, DIM, ALPHA = 13, 256, 1000.0
ORACLE_PAIRS = (1, 11)
LARGE_DIM = 1024  # one pair; blob width 20 * 1024 / 256 as the bench scales it
SAME_PX = 1e-6  # distributed (world of one) vs sharded_variational_solve, same pairs
# phase 7: cells of the 15 x 20 grid held against the serial path, and the
# bound on |batched - serial| of their speed and remodelling means,
# relative to the field's scale, max(|mean|, standard deviation).  Both
# solve the same float32 system to rtol 1e-6, but a batch of 300 pairs
# reduces in another order than one pair, so the two stop at different
# iterates.  The scale is not the mean alone: the remodelling field takes
# both signs, and its mean can be 1% of its spread (cell (3, 5)).
SWEEP_CELLS = ((3, 5), (7, 10), (11, 15))
SWEEP_REL_TOL = 1e-4
ANALYSIS_PAIR = 3  # phase 8's sweeps run on pair (3, 4) of the bench movie
# phase 9: BASELINE config 3's stack (bench.py's stack_512 section) as a
# TIFF of integer counts, the actin pixel geometry, and the PGM folder
CLI_FRAMES, CLI_DIM = 51, 512
CLI_DELTA_X, CLI_DELTA_T = "0.0913", "10"
PGM_FRAMES, PGM_DIM = 13, 256
# the bench movie's intensity scale (x100), rounded to integer counts: the
# CLI's default alpha = 1000 is set for that scale (alpha_s enters the solve
# as alpha_s / I_max^2); at 12-bit counts (peak 4095) it regularises ~1,700x
# more weakly, and the float32 solve does not converge on crops of this movie
PEAK_COUNTS = 100
CLI_SAME_REL = 1e-6  # pairs 0-2 of the CLI run vs a direct call on frames 0-3
HOST_PACKAGES = ("matplotlib", "pandas", "cv2", "PIL", "tifffile")


def bench_movie():
    """The bench movie: blob width 20, sigma 3, v = (0.15, 0.1) per frame,
    x100 and rounded through float32 (integer-like microscopy data is
    exact in f32, so the f64 oracle sees the same frames)."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=N_FRAMES, dimension=DIM, width=20.0,
                                           sigma=3.0, v_x=0.15, v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def embryo_pair():
    """The bench's 1024x1024 pair: blob width 80, sigma 3, v = (0.15, 0.1),
    x100 and rounded through float32."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=2, dimension=LARGE_DIM,
                                           width=20.0 * LARGE_DIM / 256, sigma=3.0, v_x=0.15,
                                           v_y=0.1)
    return (movie * 100.0).astype(np.float32)


def counts_movie(n_frames, dim):
    """The bench movie's generator at dim x dim (blob width 20 * dim / 256,
    sigma 3, v = (0.15, 0.1) px per frame), at the bench's scale (peak 100)
    and rounded: integer counts as a camera writes them, as uint16."""
    from opticalflow_tpu_torch.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=n_frames, dimension=dim,
                                           width=20.0 * max(dim, 256) / 256, sigma=3.0,
                                           v_x=0.15, v_y=0.1)
    return np.round(movie / movie.max() * PEAK_COUNTS).astype(np.uint16)


def write_tiff_stack(path, movie):
    """An uncompressed little-endian 16-bit multi-page TIFF of a (T, X, Y)
    uint16 movie: per page one IFD (width, height, 16 bits, no
    compression, black-is-zero, one strip) and then its pixels."""
    T, H, W = movie.shape
    page_bytes = H * W * 2
    # (tag, type, value): type 3 SHORT, 4 LONG; the strip offset is filled in
    tags = [(256, 4, W), (257, 4, H), (258, 3, 16), (259, 3, 1), (262, 3, 1), (273, 4, None),
            (277, 3, 1), (278, 4, H), (279, 4, page_bytes)]
    ifd_bytes = 2 + 12 * len(tags) + 4
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        offset = 8
        for k in range(T):
            data = offset + ifd_bytes
            next_ifd = data + page_bytes if k < T - 1 else 0
            f.write(struct.pack("<H", len(tags)))
            for tag, typ, value in tags:
                f.write(struct.pack("<HHII", tag, typ, 1, data if value is None else value))
            f.write(struct.pack("<I", next_ifd))
            f.write(movie[k].astype("<u2").tobytes())
            offset = next_ifd


def write_pgm_folder(folder, movie):
    """One binary 16-bit PGM (P5, maxval 65535: big-endian 2-byte samples)
    per frame."""
    os.makedirs(folder, exist_ok=True)
    for k, frame in enumerate(movie):
        with open(os.path.join(folder, f"frame_{k:03d}.pgm"), "wb") as f:
            f.write(b"P5\n%d %d\n65535\n" % (frame.shape[1], frame.shape[0]))
            f.write(frame.astype(">u2").tobytes())


def bound(N, K, m, n, lines=False):
    """(bound_ms, bound_by) of one kernel call on N frame blocks of (m+2,
    n+2) and K field stacks of (m, n) each: every input read once (I,
    scalars, the field planes and, with ``lines``, each stack's four halo
    lines, 2 (n + 2) + 2 m values a plane), every output plane written
    once, over the card's memory rate; the stencil's operations over its
    float32 rate."""
    from opticalflow_tpu_torch.utils.cuda_timing import F32_FLOPS_PER_S, HBM_BYTES_PER_S
    from opticalflow_tpu_torch.utils.kernel_ab import FLOPS_PER_PIXEL

    halo = 2 * (n + 2) + 2 * m if lines else 0
    nbytes = 4 * (N * (m + 2) * (n + 2) + 2 * N + 3 * N * K * (2 * m * n + halo))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_PIXEL * N * K * m * n / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(entry, label, kernel_fn, plain_fn, args, shape, card, bounds=None):
    """Fill ``entry`` with the timing keys of a kernel at one shape: device
    times of the kernel warm (``ms``: its operands left in L2 where they
    fit) and cold (``cold_ms``: L2 evicted before every launch), of its
    plain version, per-call times of both, and its bound (``bounds``, or
    :func:`bound` of ``shape``)."""
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms, device_ms

    entry["ms"] = device_ms(lambda: kernel_fn(*args))
    entry["cold_ms"] = device_ms(lambda: kernel_fn(*args), cold=True)
    entry["plain_ms"] = device_ms(lambda: plain_fn(*args), launches=10)
    entry["call_ms"] = call_ms(lambda: kernel_fn(*args), 50)
    entry["plain_call_ms"] = call_ms(lambda: plain_fn(*args), 10)
    entry["bound_ms"], entry["bound_by"] = bounds or bound(*shape)
    entry["library_ms"] = None  # no single PyTorch call computes the EL stencil
    print(f"{label} timed at N={shape[0]} K={shape[1]} {shape[2]}x{shape[3]}"
          f"{' with halo lines' if shape[4:] and shape[4] else ''}: device "
          f"{entry['ms'] * 1e3:.3f} us per launch warm, {entry['cold_ms'] * 1e3:.3f} cold (plain "
          f"version {entry['plain_ms'] * 1e3:.1f} us), per call {entry['call_ms']:.4f} / "
          f"{entry['plain_call_ms']:.4f} ms, bound {entry['bound_ms'] * 1e3:.3f} us "
          f"({entry['bound_by']}), {entry['bound_ms'] / entry['ms']:.2f} of it warm, "
          f"{entry['bound_ms'] / entry['cold_ms']:.2f} cold  [{card}]", flush=True)


def _rel_errors(y, y_ref):
    """max|y - y_ref| / max|y_ref| per field, and the largest max|y - y_ref|."""
    rel, max_abs = [], 0.0
    for q in range(3):
        err = (y[..., q, :, :] - y_ref[..., q, :, :]).abs().max().item()
        rel.append(err / y_ref[..., q, :, :].abs().max().item())
        max_abs = max(max_abs, err)
    return rel, max_abs


def sweep_chunk():
    """Solves per chunk of the batched sweep at its default (one pair per
    cell), at most the grid's 300."""
    from opticalflow_tpu_torch.analysis.sweeps import DEFAULT_BATCH_CHUNK
    from opticalflow_tpu_torch.utils.sweep_chunks import REMODELLING_ALPHAS, SPEED_ALPHAS

    return min(DEFAULT_BATCH_CHUNK, SPEED_ALPHAS.size * REMODELLING_ALPHAS.size)


def _sweep_operands(dev):
    """B1's operands in the sweep path's first chunk: the 128x128 pair's
    normalised previous frame once per cell, each cell's (alpha_s / s^2,
    alpha_r)."""
    from opticalflow_tpu_torch.utils.sweep_chunks import REMODELLING_ALPHAS, SPEED_ALPHAS, sweep_movie

    n = sweep_chunk()
    frame = torch.from_numpy(sweep_movie()[0] + 1e-4).to(dev)
    scale = frame.max()
    grid = torch.tensor([[a, b] for a in SPEED_ALPHAS for b in REMODELLING_ALPHAS][:n],
                        dtype=torch.float32, device=dev)
    I = (frame / scale).expand(n, *frame.shape).contiguous()
    return I, torch.stack([grid[:, 0] / scale**2, grid[:, 1]], dim=-1).contiguous()


def _normalised(movie, dev):
    frames = torch.from_numpy(movie).to(dev)
    scale = frames.flatten(1).amax(1)
    I = (frames / scale[:, None, None]).contiguous()  # normalised as the solve does
    return I, torch.stack([ALPHA / scale**2, torch.full_like(scale, ALPHA)], dim=-1)


# wrapper (its plain version is the wrapper's name + "_ref"; for B4-B6 the
# kernel: B4's wrappers are el_residual_df32 and el_matvec_df32, B5's
# mg_smooth, mg_smooth_fine and mg_stencil_apply, B6's mg_residual_restrict
# and mg_prolong_add): counter label, source, TPU kernel it replaces (B4-B6:
# no Pallas kernel, the JAX function that XLA fuses)
KERNELS = {
    "el_matvec_reduced_fused": ("B1", "opticalflow_tpu_torch/csrc/el_matvec.cu",
                                "opticalflow_tpu/ops/pallas_kernels.py:398"),
    "el_matvec_plain_core": ("B2", "opticalflow_tpu_torch/csrc/el_matvec_plain.cu",
                             "opticalflow_tpu/ops/pallas_kernels.py:685"),
    "el_matvec_extended": ("B3", "opticalflow_tpu_torch/csrc/el_matvec_ext.cu",
                           "opticalflow_tpu/ops/pallas_kernels.py:70"),
    "el_df32": ("B4", "opticalflow_tpu_torch/csrc/el_df32.cu",
                "opticalflow_tpu/ops/elop.py:519"),
    "mg_smooth": ("B5", "opticalflow_tpu_torch/csrc/mg_smooth.cu",
                  "opticalflow_tpu/solve/multigrid.py:247"),
    "mg_transfer": ("B6", "opticalflow_tpu_torch/csrc/mg_transfer.cu",
                    "opticalflow_tpu/solve/multigrid.py:77"),
    "gram_schmidt": ("B7", "opticalflow_tpu_torch/csrc/krylov_gs.cu",
                     "opticalflow_tpu/solve/krylov.py:374"),
}


# the shapes at which phase 3 times B1 and B2 besides their first case:
# those their paths launch (the bench's at K = 27)
TIMED_AT = {"el_matvec_reduced_fused": ("bench", "large", "sweep", "cli"),
            "el_matvec_plain_core": ("bench", "large")}
KERNELS_BY_LABEL = {label: name for name, (label, _, _) in KERNELS.items()}
# the B5 launches phase 3 times on each path: level 0's, then level 1's
# (every B6 instance is timed at both: mg_cases.transfer_cases)
MG_TIMED = (("fine",), ("sweep", "zero guess"))
# the launches of one V-cycle at the sweep's chunk (sweeps 2, 5 levels): 4
# B1, then B5 and B6, with both fused B6 stages at the 3 probed levels
V_CYCLE_LAUNCHES = {"B1": 4, "B5": 10, "B6": 8}


def check_kernels(movie, large, stack_frame, dev, card):
    """B1 and B2 vs their plain versions, and the hybrid matvec vs B1's
    plain version, at the shapes of phases 4, 5, 7 and 9; returns the JSON
    entry of each kernel (without the launch counts), timed at the first
    case, B1 also at the sweep's and the command line's shapes."""
    from opticalflow_tpu_torch.core import stencils
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms

    frames = {"bench": _normalised(movie, dev), "large": _normalised(large[:1], dev),
              "sweep": _sweep_operands(dev), "cli": _normalised(stack_frame, dev)}
    gen = torch.Generator(dev).manual_seed(1)
    n_sweep = sweep_chunk()
    cases = [  # (name, frames, B, K, m, n, compat, hybrid too)
        ("11 pairs 254x254 compat", "bench", 11, 1, 254, 254, True, True),
        ("11 pairs 254x254 fixed", "bench", 11, 1, 254, 254, False, False),
        ("11 pairs x 27 probes 254x254", "bench", 11, 27, 254, 254, True, False),
        ("1 pair 1022x1022", "large", 1, 1, 1022, 1022, True, True),
        ("1 pair x 27 probes 1022x1022", "large", 1, 27, 1022, 1022, True, False),
        ("2 pairs 61x190 ragged", "bench", 2, 1, 61, 190, True, False),
        # the sweep path's one chunk: every cell's alphas on the same frame
        (f"{n_sweep} cells 126x126 (sweep)", "sweep", n_sweep, 1, 126, 126, True, False),
        (f"{n_sweep} cells x 27 probes 126x126 (sweep)", "sweep", n_sweep, 27, 126, 126, True,
         False),
        # the command line's stack: one pair per solve, 510x510 interior
        ("1 pair 510x510 (CLI)", "cli", 1, 1, 510, 510, True, False),
        ("1 pair x 27 probes 510x510 (CLI)", "cli", 1, 27, 510, 510, True, False),
    ]
    entries = {name: {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "max_abs_err": 0.0}
               for name, (_, source, replaces) in KERNELS.items()}
    for index, (name, which, B, K, m, n, compat, hybrid) in enumerate(cases):
        I_all, scalars_all = frames[which]
        I = I_all[:B, : m + 2, : n + 2].contiguous()
        scalars = scalars_all[:B].contiguous()
        shape = (B, 3, m, n) if K == 1 else (B, K, 3, m, n)
        u = torch.randn(shape, device=dev, generator=gen)
        reps = 50 if B * K * m * n < 3e7 else 10
        gbytes = 4 * (B * (m + 2) * (n + 2) + 6 * B * K * m * n) / 1e9
        ms = {}
        for kernel in ("el_matvec_reduced_fused", "el_matvec_plain_core"):
            kernel_fn, plain_fn = getattr(ck, kernel), getattr(ck, kernel + "_ref")
            y = kernel_fn(I, scalars, u, compat)
            y_ref = plain_fn(I, scalars, u, compat)
            torch.cuda.synchronize()
            rel, err = _rel_errors(y, y_ref)
            del y, y_ref
            k_ms = call_ms(lambda: kernel_fn(I, scalars, u, compat), reps)
            p_ms = call_ms(lambda: plain_fn(I, scalars, u, compat), 10)
            ms[kernel] = k_ms, p_ms
            print(f"{kernel} {name}: max rel err per field "
                  f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); kernel {k_ms:.4f} ms "
                  f"({gbytes / k_ms * 1e3:.0f} GB/s), plain {p_ms:.4f} ms per call  [{card}]",
                  flush=True)
            if max(rel) > REL_TOL:
                raise AssertionError(f"{kernel} disagrees with its plain version: {name}")
            entries[kernel]["max_abs_err"] = max(entries[kernel]["max_abs_err"], err)
            if index == 0:
                time_kernel(entries[kernel], KERNELS[kernel][0], kernel_fn, plain_fn,
                            (I, scalars, u, compat), (B, K, m, n), card)
            elif which in TIMED_AT[kernel] and (which != "bench" or K > 1):
                # also timed at every other shape its paths launch
                timed = entries[kernel].setdefault(f"at_{which}_shape", {})[f"N={B} K={K}"] = {}
                time_kernel(timed, f"{KERNELS[kernel][0]} ({which})", kernel_fn, plain_fn,
                            (I, scalars, u, compat), (B, K, m, n), card)
        if hybrid:
            dy_mode = stencils.DY_COMPAT if compat else stencils.DY_FIXED
            ring = elop.ring_coeffs(elop.compute_coefficients(I, scalars[:, 0], scalars[:, 1],
                                                              dy_mode))
            y_h = ck.el_matvec_hybrid(I, scalars, u, compat, ring)
            y_ref = ck.el_matvec_reduced_fused_ref(I, scalars, u, compat)
            torch.cuda.synchronize()
            rel, _ = _rel_errors(y_h, y_ref)
            h_ms = call_ms(lambda: ck.el_matvec_hybrid(I, scalars, u, compat, ring), reps)
            print(f"el_matvec_hybrid {name}: max rel err per field vs the fused plain version "
                  f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); ms per call: "
                  f"B2 core {ms['el_matvec_plain_core'][0]:.4f}, hybrid {h_ms:.4f}, B1 fused "
                  f"{ms['el_matvec_reduced_fused'][0]:.4f}, plain "
                  f"{ms['el_matvec_reduced_fused'][1]:.4f}  [{card}]", flush=True)
            if max(rel) > REL_TOL:
                raise AssertionError(f"hybrid matvec disagrees with the plain version: {name}")
    return entries


def check_extended_kernel(movie, large, dev, card, entry):
    """B3 vs its plain versions at the shapes the tiled matvec gives it, in
    each operand form (the whole field in one launch over its tiles; one
    tile and its four halo lines, written into its window of the result;
    and pre-extended blocks, the JAX kernel's form), and the tiled matvec
    vs B1's plain version on the (1, 1, 1) and (1, 2, 2) meshes at
    1022x1022, timed beside B1, and on (1, 2, 2) its exchange route (the
    distinct-device route, forced on the one card) bitwise against its
    windows route, both timed; fills B3's JSON entry (timed at the first
    case, and at every shape a route launches under ``at_path_shape``)."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.parallel import spmd
    from opticalflow_tpu_torch.parallel.mesh import make_mesh
    from opticalflow_tpu_torch.utils.cuda_timing import call_ms

    frames = {"bench": _normalised(movie, dev), "large": _normalised(large[:1], dev)}
    gen = torch.Generator(dev).manual_seed(2)
    cases = [  # (name, frames, pairs, K, m, n, tx, ty, form, timed)
        ("1022x1022 as one tile", "large", 1, 1, 1022, 1022, 1, 1, "field", True),
        ("1022x1022 as one tile x 27 probes", "large", 1, 27, 1022, 1022, 1, 1, "field", True),
        ("2 x 2 tiles of 511x511, one launch", "large", 1, 1, 1022, 1022, 2, 2, "field", True),
        ("2 x 2 tiles of 511x511 x 27 probes, one launch", "large", 1, 27, 1022, 1022, 2, 2,
         "field", True),
        ("tile (0, 0) of 2 x 2 and its halo lines", "large", 1, 1, 1022, 1022, 2, 2, "lines",
         True),
        ("tile (0, 0) of 2 x 2 and its halo lines x 27 probes", "large", 1, 27, 1022, 1022, 2, 2,
         "lines", True),
        ("2 x 2 pre-extended blocks of 511x511", "large", 1, 1, 1022, 1022, 2, 2, "blocks",
         False),
        ("2 x 2 pre-extended blocks of 511x511 x 27 probes", "large", 1, 27, 1022, 1022, 2, 2,
         "blocks", False),
        ("11 pairs 254x254", "bench", 11, 1, 254, 254, 1, 1, "field", False),
        ("2 pairs 61x190 ragged", "bench", 2, 1, 61, 190, 1, 1, "field", False),
        ("2 pairs 61x190 as 1 x 2 tiles, halo lines", "bench", 2, 1, 61, 190, 1, 2, "lines",
         False),
    ]
    for index, (name, which, pairs, K, m, n, tx, ty, form, timed) in enumerate(cases):
        I_all, scalars_all = frames[which]
        I = I_all[:pairs, : m + 2, : n + 2].contiguous()
        u = torch.randn((pairs, K, 3, m, n), device=dev, generator=gen)
        I_t = spmd.to_tiles(I, tx, ty).contiguous()
        s_t = scalars_all[:pairs].repeat_interleave(tx * ty, dim=0).contiguous()
        mt, nt = m // tx, n // ty
        if form == "field":
            kernel_fn, plain_fn = ck.el_matvec_tiled, ck.el_matvec_tiled_ref
            args, shape = (I_t, s_t, u, True, (tx, ty)), (pairs * tx * ty, K, mt, nt)
        elif form == "lines":  # tile (0, 0) of every pair, as the exchange route launches it
            t = torch.arange(pairs, device=dev) * tx * ty
            halo = ck.halo_lines(spmd.to_tiles(elop.extend_interior(u), tx, ty)[t])
            window = torch.empty_like(u)[..., :mt, :nt]
            kernel_fn, plain_fn = ck.el_matvec_tiled, ck.el_matvec_tiled_ref
            args = (I_t[t].contiguous(), s_t[t].contiguous(), u[..., :mt, :nt], True, (1, 1),
                    halo, window)
            shape = (pairs, K, mt, nt, True)
        else:
            kernel_fn, plain_fn = ck.el_matvec_extended, ck.el_matvec_extended_ref
            u_t = spmd.to_tiles(elop.extend_interior(u), tx, ty).contiguous()
            args, shape = (I_t, s_t, u_t, True), (pairs * tx * ty, K, mt, nt, True)
        y = kernel_fn(*args).clone()
        y_ref = plain_fn(*args)
        torch.cuda.synchronize()
        rel, err = _rel_errors(y, y_ref)
        del y, y_ref
        reps = 50 if pairs * K * m * n < 3e7 else 10
        k_ms = call_ms(lambda: kernel_fn(*args), reps)
        p_ms = call_ms(lambda: plain_fn(*args), 10)
        print(f"B3 {name} ({form}, N={shape[0]} blocks, K={K}): max rel err per field "
              f"{', '.join(f'{r:.2e}' for r in rel)} (tol {REL_TOL:g}); kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms per call  [{card}]", flush=True)
        if max(rel) > REL_TOL:
            raise AssertionError(f"B3 disagrees with its plain version: {name}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if index == 0:
            time_kernel(entry, "B3", kernel_fn, plain_fn, args, shape, card)
        elif timed:
            key = f"{form} N={shape[0]} K={K} {mt}x{nt}"
            time_kernel(entry.setdefault("at_path_shape", {}).setdefault(key, {}),
                        f"B3 ({form})", kernel_fn, plain_fn, args, shape, card)
        del I_t, u, args

    # the tiled matvec of the sharded solve against B1's plain version
    I, scalars = frames["large"]
    for tx, ty in ((1, 1), (2, 2)):
        mesh = make_mesh([dev] * (tx * ty), frames=1, tx=tx, ty=ty)
        mv = spmd.make_sharded_kernel_matvec(mesh, I, scalars[:, 0], scalars[:, 1], "compat")
        for K in (1, 27):
            u = torch.randn((1, 3, 1022, 1022) if K == 1 else (1, K, 3, 1022, 1022), device=dev,
                            generator=gen)
            rel, _ = _rel_errors(mv(u), ck.el_matvec_reduced_fused_ref(I, scalars, u, True))
            reps = 50 if K == 1 else 10
            t_ms = call_ms(lambda: mv(u), reps)
            b1_ms = call_ms(lambda: ck.el_matvec_reduced_fused(I, scalars, u, True), reps)
            print(f"tiled matvec, mesh (1, {tx}, {ty}), 1022x1022 K={K}: max rel err per field "
                  f"vs B1's plain version {', '.join(f'{r:.2e}' for r in rel)} (tol "
                  f"{REL_TOL:g}); ms per call: tiled (B3) {t_ms:.4f}, B1 {b1_ms:.4f}  [{card}]",
                  flush=True)
            if max(rel) > REL_TOL:
                raise AssertionError(f"tiled matvec (1, {tx}, {ty}) K={K} disagrees with B1")
            if tx * ty > 1:  # the distinct-device route, forced on the one card
                mv_x = spmd.make_sharded_kernel_matvec(mesh, I, scalars[:, 0], scalars[:, 1],
                                                       "compat", as_distinct=True)
                same = torch.equal(mv_x(u), mv(u))
                x_ms = call_ms(lambda: mv_x(u), reps)
                print(f"tiled matvec, mesh (1, {tx}, {ty}), 1022x1022 K={K}, one application "
                      f"(CUDA events, ms per call): windows route (one B3 launch) {t_ms:.4f}, "
                      f"exchange route ({tx * ty} B3 launches, seams handed between tiles) "
                      f"{x_ms:.4f}; outputs bitwise equal {same}  [{card}]", flush=True)
                if not same:
                    raise AssertionError(f"exchange route (1, {tx}, {ty}) K={K} differs from the "
                                         "windows route")


def bound_df32(B, m, n, P, residual):
    """(bound_ms, bound_by) of one B4 call on B pairs of (m, n) with P
    planes: ``df32_cases.bound``, each operand byte once over the card's
    memory rate or ~1,250 operations a pixel over its float32 rate."""
    from opticalflow_tpu_torch.utils import df32_cases

    us, by = df32_cases.bound(B, m, n, P, residual)
    return us * 1e-3, by


def check_df32_kernel(movie, large, stack, dev, card, entry):
    """Phase 3's B4: the df32 residual and operator against their plain
    versions, bit for bit (the bits compared: signed zeros and NaN), in
    both modes and both dy rules at the shapes the refinement launches it
    (the bench's 11 pairs of 254x254, the 1024x1024 pair, the sweep's chunk
    of 150 cells of 126x126, the command line's 510x510 pair), at shapes
    that end mid-tile (3 x 61x190, 2 x 17x33) and at the 2x2 minimum; then
    on adversarial operands (``df32_cases.adversarial_operands``: signed
    zeros, subnormal low parts, mixed exponents; NaN from an overflowing
    split), also 70,000 pairs of 2x2, a grid of more than 65,535 blocks.
    Each path shape timed in compat mode, both kernel modes, warm and
    cold, with its bound and its issue ceiling.  Fills B4's JSON entry (the
    operator at the bench's shape; every other shape and mode under
    ``at_path_shape``)."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import df32_cases
    from opticalflow_tpu_torch.utils.sweep_chunks import sweep_movie

    n_sweep = sweep_chunk()
    sweep = sweep_movie() + 1e-4
    bench = np.full((11, 2), ALPHA)
    cases = [  # (name, previous frames, current frames, raw alphas, timed)
        ("11 pairs 254x254 (bench)", movie[1:12], movie[2:13], bench, True),
        ("1 pair 1022x1022 (1024)", large[:1], large[1:2], bench[:1], True),
        (f"{n_sweep} cells 126x126 (sweep)", np.repeat(sweep[:1], n_sweep, axis=0),
         np.repeat(sweep[1:], n_sweep, axis=0), df32_cases.sweep_alphas(n_sweep), True),
        ("1 pair 510x510 (CLI)", stack[:1], stack[1:2], bench[:1], True),
        ("3 pairs 61x190 ragged", movie[:3, :63, :192], movie[1:4, :63, :192], bench[:3], False),
        ("2 pairs 17x33 mid-tile", movie[:2, 90:109, 90:125], movie[1:3, 90:109, 90:125],
         bench[:2], False),
        ("2 pairs 2x2 minimum", movie[:2, 126:130, 126:130], movie[1:3, 126:130, 126:130],
         bench[:2], False),
    ]
    gen = torch.Generator(dev).manual_seed(3)
    for name, prev, cur, alphas, timed in cases:
        for dy_mode in ("compat", "fixed"):
            ops = df32_cases.pack_pairs(prev, cur, alphas, dy_mode, dev)
            B, P, m, n = ops.planes.shape
            x_hi = torch.randn((B, 3, m, n), device=dev, generator=gen)
            x_lo = x_hi * 1e-8 * torch.randn((B, 3, m, n), device=dev, generator=gen)
            _check_df32_modes(ops, x_hi, x_lo, f"{name} {dy_mode} (P = {P})", card, entry,
                              timed and dy_mode == "compat", "bench" in name)
            del ops, x_hi, x_lo
    adversarial = [  # (pairs, m, n, P, overflow)
        (3, 61, 190, 24, False), (2, 17, 33, 26, False), (2, 2, 2, 24, False),
        (2, 45, 67, 26, True), (70000, 2, 2, 26, False)]
    for B, m, n, P, overflow in adversarial:
        ops, x_hi, x_lo = df32_cases.adversarial_operands(B, m, n, P, seed=11, device=dev,
                                                          overflow=overflow)
        _check_df32_modes(ops, x_hi, x_lo, f"adversarial {B} pairs {m}x{n} (P = {P}"
                          f"{', overflow: NaN' if overflow else ''})", card, entry, False, False)
        del ops, x_hi, x_lo
    usage = kernel_usage().get("el_df32.cu")  # None where this run built nothing
    entry["registers"] = {_short(fn): u["registers"] for fn, u in usage.items()} if usage else None
    entry["spill_bytes"] = (sum(u["spill_stores"] + u["spill_loads"] for u in usage.values())
                            if usage else None)
    entry["warps_per_sm"] = {f"P={P} {mode}": ck.df32_warps_per_sm(P, mode == "residual", dev)
                             for P in (24, 26) for mode in ("operator", "residual")}
    print(f"B4 build: registers {entry['registers']}, spill bytes {entry['spill_bytes']}, warps "
          f"an SM {entry['warps_per_sm']}  [{card}]", flush=True)


def _check_df32_modes(ops, x_hi, x_lo, name, card, entry, timed, first):
    """B4 in both modes on one set of operands, held to its plain versions
    by bits; with ``timed``, each mode timed at this shape (the operator
    into ``entry`` itself when ``first``, else under ``at_path_shape``)."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import df32_cases

    B, P, m, n = ops.planes.shape
    modes = {"residual": (ck.el_residual_df32, ck.el_residual_df32_ref, (ops, x_hi, x_lo)),
             "operator": (ck.el_matvec_df32, ck.el_matvec_df32_ref, (ops, x_hi))}
    for mode, (kernel_fn, plain_fn, args) in modes.items():
        y = kernel_fn(*args)
        y_ref = plain_fn(*args)
        torch.cuda.synchronize()
        same = torch.equal(y, y_ref)
        bits = df32_cases.bitwise_equal(y, y_ref)
        finite = torch.isfinite(y_ref)
        err = (y - y_ref)[finite].abs().max().item() if finite.any() else 0.0
        print(f"B4 {mode} {name}: torch.equal to its plain version {same}, bits equal {bits}, "
              f"max |kernel - plain| {err:.3e} over {int(finite.sum())} finite of {y.numel()}  "
              f"[{card}]", flush=True)
        if not bits:
            raise AssertionError(f"B4 {mode} differs from its plain version: {name}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del y, y_ref
        if not timed:
            continue
        bounds = bound_df32(B, m, n, P, mode == "residual")
        if mode == "operator" and first:
            target = entry
        else:
            target = entry.setdefault("at_path_shape", {})[f"{mode} N={B} {m}x{n}"] = {}
        time_kernel(target, f"B4 {mode} ({name})", kernel_fn, plain_fn, args, (B, 1, m, n), card,
                    bounds)
        issue_us = df32_cases.issue_us(B, m, n)
        print(f"B4 {mode} ({name}): issue ceiling {issue_us:.3f} us, "
              f"{issue_us * 1e-3 / target['ms']:.2f} of it warm, "
              f"{issue_us * 1e-3 / target['cold_ms']:.2f} cold  [{card}]", flush=True)


def check_mg_kernels(dev, card, entries):
    """Phase 3's B5 and B6: every launch each path's V-cycle makes at its
    level shapes (``mg_cases.path_cases``: the bench's 11 x 254x254 and its
    probed levels 127-16, the sweep's 150 x 126x126 and 63-16, the command
    line's 1 x 510x510, 255 and 128, the 1024x1024 pair's 1 x 1022x1022,
    511 and 256), every B6 instance, the six standalone and the two fused,
    at each path's level 0 and level 1 (``mg_cases.transfer_cases``), the
    setup's transfers at K = 27 (``mg_cases.probe_cases``), a ragged 3 x
    61x190, 2 x 2 and 1 x 1, the coarsest operator's K = 192 (3 m n at 8 x
    8), each held to its plain version bit for bit (the bits compared:
    signed zeros among the operands).  Level 0's epilogue and level 1's
    sweep and zero guess (B5), and every B6 instance of transfer_cases and
    probe_cases, timed warm and cold beside their bound; R y and P e also
    beside the one PyTorch call of the same function (``F.conv2d`` /
    ``F.conv_transpose2d``, TF32 off); the sweep path's level-1 sweep and
    sweep-residual-restrict fill B5's and B6's own keys.  Then the
    V-cycle's milliseconds and launches at the sweep's chunk, the launches
    checked against ``V_CYCLE_LAUNCHES``."""
    from opticalflow_tpu_torch.utils import mg_cases
    from opticalflow_tpu_torch.utils.cuda_timing import device_ms
    from opticalflow_tpu_torch.utils.df32_cases import bitwise_equal
    from opticalflow_tpu_torch.utils.sweep_chunks import sweep_movie, v_cycle_costs

    Case = mg_cases.Case
    n_sweep = sweep_chunk()
    cases = []  # (label, case, timed)
    for path in mg_cases.PATHS:
        path_cases = mg_cases.path_cases(path)
        level0, level1 = path_cases[0].M, path_cases[4].M
        timed = {(level0, k) for k in MG_TIMED[0]} | {(level1, k) for k in MG_TIMED[1]}
        cases += [(path, c, (c.M, c.kind) in timed) for c in path_cases
                  if mg_cases.KINDS[c.kind] == "B5"]
        cases += [(path, c, False) for c in path_cases  # deeper levels' B6
                  if mg_cases.KINDS[c.kind] == "B6" and c.M not in (level0, level1)]
        cases += [(path, c, True) for c in mg_cases.transfer_cases(path)]
        cases += [(f"{path} setup", c, True) for c in mg_cases.probe_cases(path)]
    cases += [("ragged", Case(kind, 3, 1, 61, 190), False) for kind in
              ("sweep", "zero guess", "fine", "apply", "residual-restrict", "restrict b - y",
               "prolong-add", "sweep-residual-restrict", "prolong-add-sweep")]
    cases += [(label, Case(kind, 2, K, M, M), False) for label, M in (("2x2", 2), ("1x1", 1))
              for K in (1, 27) for kind in mg_cases.KINDS
              if K == 1 or kind not in mg_cases.SWEEPS]
    cases += [("sweep setup", Case("apply", n_sweep, 27, 32, 32), False),
              ("sweep setup, coarsest operator", Case("apply", n_sweep, 192, 8, 8), False),
              ("bench setup, coarsest operator", Case("apply", 11, 192, 8, 8), False)]
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardsticks' convolutions in full float32
    for index, (label, case, timed) in enumerate(cases):
        name = KERNELS_BY_LABEL[mg_cases.KINDS[case.kind]]
        kernel_fn, plain_fn, args = mg_cases.operands(case, dev, seed=index)
        y = kernel_fn(*args)
        y_ref = plain_fn(*args)
        torch.cuda.synchronize()
        outs = list(zip(y, y_ref)) if isinstance(y, tuple) else [(y, y_ref)]
        bits = all(bitwise_equal(a, b) for a, b in outs)
        err = max((a - b).abs().max().item() for a, b in outs)
        desc = f"{case.kind} N={case.B} K={case.K} {case.M}x{case.N}"
        print(f"{mg_cases.KINDS[case.kind]} {label} {desc}: bits equal to its plain version "
              f"{bits}, max |kernel - plain| {err:.3e}  [{card}]", flush=True)
        if not bits:
            raise AssertionError(f"{mg_cases.KINDS[case.kind]} differs from its plain version: "
                                 f"{label} {desc}")
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        del y, y_ref, outs
        if timed:
            own = label == "sweep" and case.M == 63 and case.kind in ("sweep",
                                                                       "sweep-residual-restrict")
            if own:
                target = entries[name]
            else:
                target = entries[name].setdefault("at_path_shape", {})[f"{label} {desc}"] = {}
            time_kernel(target, f"{mg_cases.KINDS[case.kind]} {label} {case.kind}", kernel_fn,
                        plain_fn, args, (case.B, case.K, case.M, case.N), card,
                        mg_cases.bound(case))
            library = mg_cases.library_call(case, args)
            if library is not None:
                target["library_ms"] = device_ms(library)
                cold = device_ms(library, cold=True)
                print(f"  the same function as one PyTorch call (F.{mg_cases.LIBRARY[case.kind]}, "
                      f"TF32 off): {target['library_ms'] * 1e3:.3f} us warm, {cold * 1e3:.3f} "
                      f"cold; the kernel {target['library_ms'] / target['ms']:.2f}x as fast warm, "
                      f"{cold / target['cold_ms']:.2f}x cold  [{card}]", flush=True)
        del args
    torch.backends.cudnn.allow_tf32 = tf32
    print(f"B5 and B6: {len(cases)} cases bitwise equal to their plain versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    costs = v_cycle_costs(sweep_movie(), n_sweep, card)
    launches = {k: costs["kernels launches"][k] for k in V_CYCLE_LAUNCHES}
    print(f"launches per V-cycle: {sum(launches.values())} ({launches}), expected "
          f"{sum(V_CYCLE_LAUNCHES.values())} with both fused B6 stages, 28 without", flush=True)
    if launches != V_CYCLE_LAUNCHES:
        raise AssertionError(f"a V-cycle launched {launches}, expected {V_CYCLE_LAUNCHES}")
    v_cycle_replays(n_sweep, card)


# B7's shapes: the two-pass cell's N = 3 x 510^2 at one pair and at its 49,
# restart 32, every pair at column j
GS_N, GS_PAIRS, GS_COLUMNS, GS_RESTART = 3 * 510 * 510, (1, 49), (0, 15, 31), 32


def gs_bytes(B, N, rows, column=True):
    """(each input byte read once and the output written once, the bytes B7
    moves): a column reads ``rows`` rows of V and w and writes w2, in three
    passes over the rows, w twice and w1 once, w1 and w2 written; an update
    reads ``rows`` rows of Z and x and writes its sum.  Float32 storage."""
    if column:
        return 4 * B * N * (rows + 2), 4 * B * N * (3 * rows + 5)
    return (4 * B * N * (rows + 2),) * 2


def check_gs_kernel(dev, card, entry):
    """Phase 3's B7 (FGMRES's Gram-Schmidt and update) at the two-pass
    cell's shapes, float32 storage and float64 sums: the column against its
    plain version (max |kernel - plain| over |w|: a float32 rounding of
    the projections at most) at 1 and 49 pairs and columns 0, 15 and 31,
    each timed warm and cold beside the bound (each input byte once:
    ``bound_ms``; the three passes' bytes printed beside it), the plain
    version, and the four ``torch.bmm`` products on V held in float64 over
    all 33 rows that the port ran before (``library_ms``, the port calls no
    bmm there now); the update at 1 and 49 pairs and 31 columns, with its
    one bmm.  The 49 pairs at column 31 fill B7's own keys."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils.cuda_timing import HBM_BYTES_PER_S, device_ms

    acc, R, N = torch.float64, GS_RESTART + 1, GS_N
    for B in GS_PAIRS:
        gen = torch.Generator(dev).manual_seed(B)
        V = torch.randn(B, R, N, device=dev, generator=gen) / N**0.5
        w = torch.randn(B, N, device=dev, generator=gen)
        act = torch.ones(B, dtype=torch.bool, device=dev)
        V64 = V.double()

        def library():  # fgmres before: V in float64, every row, four products
            h1 = torch.bmm(V64, w.to(acc)[:, :, None])
            w1 = w - torch.bmm(V64.transpose(1, 2), h1)[..., 0].float()
            h2 = torch.bmm(V64, w1.to(acc)[:, :, None])
            return w1 - torch.bmm(V64.transpose(1, 2), h2)[..., 0].float()

        lib_ms = device_ms(library, launches=10)
        for col in GS_COLUMNS:
            j = torch.full((B,), col, dtype=torch.int64, device=dev)
            Vj = V.clone()
            Vj[:, col + 1:] = 0  # a cycle's rows past j
            got = ck.gram_schmidt(Vj, w, j, act, acc)
            ref = ck.gram_schmidt_ref(Vj, w, j, act, acc)
            torch.cuda.synchronize()
            err = (got[0] - ref[0]).abs().max().item() / ref[0].abs().max().item()
            h_err = (got[1] - ref[1]).abs().max().item() / w.norm(dim=1).max().item()
            print(f"B7 column {B} x {N} j={col}: max |w - plain| / max|w| {err:.2e}, max |h - "
                  f"plain| / |w| {h_err:.2e}  [{card}]", flush=True)
            if not (err <= 1e-6 and h_err <= 1e-12):
                raise AssertionError(f"B7 column {B} x {N} j={col} differs from its plain version")
            entry["max_abs_err"] = max(entry["max_abs_err"], (got[0] - ref[0]).abs().max().item())
            del got, ref
            if B == max(GS_PAIRS) and col == max(GS_COLUMNS):
                target = entry
            else:
                target = entry.setdefault("at_path_shape", {})[f"column N={B} j={col}"] = {}
            once, passes = gs_bytes(B, N, col + 1)
            time_kernel(target, f"B7 column j={col}", ck.gram_schmidt, ck.gram_schmidt_ref,
                        (Vj, w, j, act, acc), (B, 1, N, 1), card,
                        (once / HBM_BYTES_PER_S * 1e3, "bytes"))
            target["library_ms"] = lib_ms
            print(f"  three passes' bytes {passes / HBM_BYTES_PER_S * 1e3 * 1e3:.1f} us, "
                  f"{passes / HBM_BYTES_PER_S * 1e3 / target['ms']:.2f} of it warm; the four "
                  f"float64 bmm on all {R} rows {lib_ms * 1e3:.1f} us, "
                  f"{lib_ms / target['ms']:.2f}x the kernel  [{card}]", flush=True)
            del Vj
        del V64
        Z, x = V[:, :GS_RESTART].contiguous(), w
        cols = torch.full((B,), GS_RESTART - 1, dtype=torch.int64, device=dev)
        y = torch.randn(B, GS_RESTART, device=dev, generator=gen)
        y[:, GS_RESTART - 1:] = 0
        got, ref = ck.basis_update(x, y, Z, cols, acc), ck.basis_update_ref(x, y, Z, cols, acc)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        print(f"B7 update {B} x {N} cols={GS_RESTART - 1}: max |x - plain| / max|x| {err:.2e}  "
              f"[{card}]", flush=True)
        if not err <= 1e-6:
            raise AssertionError(f"B7 update {B} x {N} differs from its plain version")
        target = entry.setdefault("at_path_shape", {})[f"update N={B} cols={GS_RESTART - 1}"] = {}
        time_kernel(target, "B7 update", ck.basis_update, ck.basis_update_ref,
                    (x, y, Z, cols, acc), (B, 1, N, 1), card,
                    (gs_bytes(B, N, GS_RESTART - 1, False)[0] / HBM_BYTES_PER_S * 1e3, "bytes"))
        Z64 = Z.double()
        target["library_ms"] = device_ms(
            lambda: x + torch.bmm(y.double()[:, None, :], Z64)[:, 0].float(), launches=10)
        print(f"  the float64 bmm on all {GS_RESTART} rows {target['library_ms'] * 1e3:.1f} us  "
              f"[{card}]", flush=True)
        del V, w, Z, Z64, got, ref
        torch.cuda.empty_cache()


def v_cycle_replays(n, card, replays=3):
    """The V-cycle at the sweep's chunk of ``n`` cells captured as a Krylov
    step is (``krylov._Step``), then replayed ``replays`` times, the counters
    set to 0 just before the replays and read just after: each replay must
    count ``V_CYCLE_LAUNCHES`` (the counts a capture records, added back per
    replay) and no plain call, and its output must equal the V-cycle run
    eagerly bit for bit."""
    import functools

    from opticalflow_tpu_torch.solve import krylov, multigrid
    from opticalflow_tpu_torch.utils.sweep_chunks import _sweep_system, sweep_movie

    hierarchy = _sweep_system(sweep_movie(), n)[-1]
    u = torch.randn(n, 3, 126, 126, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    v_cycle = functools.partial(multigrid.v_cycle, hierarchy, sweeps=2)
    out = torch.empty_like(u)
    step = krylov._Step(lambda: out.copy_(v_cycle(u)), u.device)
    step()  # runs the V-cycle once, then captures it
    ref = v_cycle(u)
    reset_counters()
    for _ in range(replays):
        step()
    torch.cuda.synchronize()
    counts = read_counters()
    per_replay = {k: counts[k] / replays for k in V_CYCLE_LAUNCHES}
    plain = sum(counts[f"{k} plain"] for k in V_CYCLE_LAUNCHES)
    equal = torch.equal(out, ref)
    print(f"V-cycle at {n} cells replayed from a CUDA graph {replays} times: launches per replay "
          f"{per_replay} (expected {V_CYCLE_LAUNCHES}), plain calls {plain}, graph replays "
          f"{counts['graph replays']}, output bitwise equal to the eager V-cycle {equal}  "
          f"[{card}]", flush=True)
    if per_replay != V_CYCLE_LAUNCHES or plain or not equal:
        raise AssertionError(f"V-cycle under replay: {per_replay}, plain {plain}, equal {equal}")


def kernel_usage():
    """Registers, shared memory and spills of every kernel this process
    built, by source (ptxas's report in ``BUILD_LOG``)."""
    from opticalflow_tpu_torch.ops import cuda_kernels as ck

    usage = {}
    for chunk in ck.BUILD_LOG.split("== ")[1:]:
        source, _, log = chunk.partition("\n")
        usage[source.strip()] = ck.ptxas_usage(log)
    return usage


def _short(mangled):
    """A kernel's name and template arguments from its mangled name, e.g.
    el_df32_kernel<1,0> or restrict_kernel<1,8,32>."""
    import re

    found = re.search(r"\d+((?:el|mg|gs)_\w+?kernel|sweep_restrict_kernel|restrict_kernel|"
                      r"prolong_sweep_kernel|prolong_kernel)", mangled)
    name = found.group(1) if found else mangled
    args = re.findall(r"L[a-zA-Z]\w*?E?(\d+)E", mangled[found.end():] if found else "")
    return f"{name}<{','.join(args)}>" if args else name


GRAPH_REPLAYS = [0]  # CUDA graph replays since the last reset_counters()


def _count_graph_replays():
    """Count every ``torch.cuda.CUDAGraph.replay`` in ``GRAPH_REPLAYS`` (the
    port keeps no replay counter: its launch counters count replayed work)."""
    replay = torch.cuda.CUDAGraph.replay
    if getattr(replay, "counted", False):
        return

    def counted(graph):
        GRAPH_REPLAYS[0] += 1
        return replay(graph)

    counted.counted = True
    torch.cuda.CUDAGraph.replay = counted


def reset_counters():
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import observability

    _count_graph_replays()
    GRAPH_REPLAYS[0] = 0
    ck.LAUNCHES = ck.PLAIN_CALLS = ck.CORE_LAUNCHES = ck.CORE_PLAIN_CALLS = 0
    ck.EXT_LAUNCHES = ck.EXT_PLAIN_CALLS = ck.DF_LAUNCHES = ck.DF_PLAIN_CALLS = 0
    ck.MG_LAUNCHES = ck.MG_PLAIN_CALLS = ck.MGT_LAUNCHES = ck.MGT_PLAIN_CALLS = 0
    ck.GS_LAUNCHES = ck.GS_PLAIN_CALLS = 0
    observability.reset()
    torch.cuda.synchronize()


def read_counters():
    from opticalflow_tpu_torch.ops import cuda_kernels as ck
    from opticalflow_tpu_torch.utils import observability

    return {"B1": ck.LAUNCHES, "B1 plain": ck.PLAIN_CALLS, "B2": ck.CORE_LAUNCHES,
            "B2 plain": ck.CORE_PLAIN_CALLS, "B3": ck.EXT_LAUNCHES,
            "B3 plain": ck.EXT_PLAIN_CALLS, "B4": ck.DF_LAUNCHES, "B4 plain": ck.DF_PLAIN_CALLS,
            "B5": ck.MG_LAUNCHES, "B5 plain": ck.MG_PLAIN_CALLS, "B6": ck.MGT_LAUNCHES,
            "B6 plain": ck.MGT_PLAIN_CALLS, "B7": ck.GS_LAUNCHES, "B7 plain": ck.GS_PLAIN_CALLS,
            "host syncs": observability.counts().get("krylov/host_syncs", 0),
            "graph captures": observability.counts().get("krylov/graph_captures", 0),
            "graph replays": GRAPH_REPLAYS[0],
            "capture s": round(observability.span_statistics().get(
                "krylov/capture", {"total": 0.0})["total"], 4)}


def bypassed(counts, kernel, graphs=True):
    """Whether a path run missed its matvec kernel, the refinement's B4 or
    the V-cycle's B5 or B6, or ran another matvec kernel or any plain
    version; or, with ``graphs``, replayed no Krylov step from a CUDA graph
    (without, the exchange route's eager loop: captured one)."""
    others = [k for k in ("B1", "B2", "B3") if k != kernel]
    plains = [f"{k} plain" for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7")]
    missed = any(counts[k] == 0 for k in (kernel, "B4", "B5", "B6"))
    route = counts["graph replays"] == 0 if graphs else counts["graph captures"] > 0
    return missed or route or any(counts[k] for k in others + plains)


def large_grid_path(large, dev, card):
    """The 1024x1024 pair: f64 oracle, then the float32 solve with the
    hybrid matvec (B2) and with the fused one (B1); returns the counts of
    each of the two runs and the oracle."""
    from opticalflow_tpu_torch import SolverConfig, variational_optical_flow
    from opticalflow_tpu_torch.flow.variational import profile_solve_phases

    movie_t = torch.from_numpy(large).to(dev)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA)
    t0 = time.perf_counter()
    oracle = variational_optical_flow(
        movie_t, dtype=torch.float64, solver=SolverConfig(
            method="gmres", rtol=1e-10, refinement_restarts=0, matvec="xla"), **kw)
    print(f"1024 oracle (float64 FGMRES, rtol 1e-10, plain matvec): "
          f"{time.perf_counter() - t0:.3f} s, iterations {oracle['iterations'].tolist()}, converged "
          f"{oracle['converged_all'].tolist()}  [{card}]", flush=True)
    if not oracle["converged_all"].all():
        raise AssertionError("the float64 oracle did not converge")

    runs = {}
    for matvec, kernel in (("hybrid", "B2"), ("auto", "B1")):
        reset_counters()
        t0 = time.perf_counter()
        result = variational_optical_flow(movie_t, solver=SolverConfig(matvec=matvec), **kw)
        wall = time.perf_counter() - t0  # returns host arrays: synchronised
        counts = read_counters()
        d = np.sqrt((result["v_x"] - oracle["v_x"]) ** 2 + (result["v_y"] - oracle["v_y"]) ** 2)
        e = float(d[0, 1:-1, 1:-1].max())
        print(f"1024 float32 matvec={matvec!r}: {wall:.3f} s, iterations "
              f"{result['iterations'].tolist()}, converged {result['converged_all'].tolist()}, "
              f"counts {counts}, EPE {e:.3e} px vs the float64 oracle (limit "
              f"{EPE_LIMIT_PX:g})  [{card}]", flush=True)
        if not result["converged_all"].all():
            raise AssertionError(f"1024 matvec={matvec!r} did not converge")
        if bypassed(counts, kernel) or counts["B7"] == 0:
            raise AssertionError(f"1024 matvec={matvec!r} bypassed its kernel: {counts}")
        if result["v_x"].shape != (1, LARGE_DIM, LARGE_DIM) or not np.isfinite(result["v_x"]).all():
            raise AssertionError("1024: bad shape or non-finite values")
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"1024 matvec={matvec!r}: EPE {e} px")
        runs[f"{LARGE_DIM}x{LARGE_DIM} {matvec}"] = counts

    for matvec in ("hybrid", "auto"):
        print_phases(f"1024 {matvec}", profile_solve_phases(
            movie_t[0], movie_t[1], ALPHA, ALPHA, solver=SolverConfig(matvec=matvec), reps=1),
            card)
    return runs, oracle


def print_phases(label, phases, card):
    """One line of ``profile_solve_phases``' split (seconds) and the df32
    refinement's share of the solve."""
    print(f"{label} phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; refinement {phases['refinement'] / phases['total']:.3f} of the total  [{card}]",
          flush=True)


def _solve_to_host(movie, mesh, as_distinct=False, solver=None, **alphas):
    """``sharded_variational_solve`` with its results on the host: (wall s,
    solutions, iterations, converged, counts), the counters set to 0 just
    before and read just after.  ``as_distinct``: the same solve through
    the private ``batch._mesh_solve`` with the distinct-device routes
    forced on a mesh that names one card several times."""
    from opticalflow_tpu_torch import SolverConfig
    from opticalflow_tpu_torch.parallel.batch import _mesh_solve, sharded_variational_solve

    reset_counters()
    t0 = time.perf_counter()
    if as_distinct:
        m = torch.as_tensor(movie).to(device=mesh.device(), dtype=torch.float32)
        all_u, infos = _mesh_solve(m[:-1], m[1:], m.new_zeros((3,) + tuple(m.shape[1:])),
                                   alphas["speed_alpha"], alphas["remodelling_alpha"],
                                   solver or SolverConfig(), "compat", mesh, as_distinct=True)
    else:
        all_u, infos = sharded_variational_solve(movie, mesh=mesh, solver=solver, **alphas)
    all_u = all_u.cpu().numpy()  # synchronised
    wall = time.perf_counter() - t0
    return (wall, all_u, infos["iterations"].cpu().numpy(), infos["converged"].cpu().numpy(),
            read_counters())


def distinct_device_runs(large, oracle, movie, windows, dev, card):
    """Phase 6's distinct-device routes: on the one card, forced
    (``as_distinct=True``) on meshes that name it several times, each held
    bitwise against the one-device route; then over two GPUs where the
    machine has them.  ``windows``: the 1024x1024 (1, 2, 2) run of the
    windows route (solutions, iterations, counts).  Returns the counts of
    each run."""
    from opticalflow_tpu_torch import SolverConfig
    from opticalflow_tpu_torch.parallel import spmd
    from opticalflow_tpu_torch.parallel.mesh import make_mesh

    runs = {}
    # 1. the frames workers on one card: the bench movie's 12 pairs, cold,
    # on a (2, 1, 1) mesh over the card twice, in serial blocks and in two
    # worker threads, in turns
    frames_mesh = make_mesh([dev] * 2, frames=2, tx=1, ty=1)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA)
    first, walls = {}, {}
    for label in ("serial blocks", "workers", "workers", "serial blocks"):
        wall, u, its, conv, counts = _solve_to_host(movie, frames_mesh,
                                                    as_distinct=label == "workers", **kw)
        walls.setdefault(label, []).append(wall)
        first.setdefault(label, (u, its, counts))
        print(f"{DIM}x{DIM} bench movie, mesh (2, 1, 1) over the card twice, {label}: "
              f"{wall:.3f} s, iterations {its.tolist()}, converged {int(conv.sum())}/{conv.size}, "
              f"counts {counts}  [{card}]", flush=True)
        if not conv.all() or bypassed(counts, "B1"):
            raise AssertionError(f"frames {label}: not converged or bypassed B1: {counts}")
    (u_s, its_s, counts_s), (u_w, its_w, counts_w) = first["serial blocks"], first["workers"]
    equal = np.array_equal(u_s, u_w) and np.array_equal(its_s, its_w)
    print(f"frames workers vs serial blocks, one card: wall s workers {walls['workers']}, serial "
          f"{walls['serial blocks']}; B1 launches workers {counts_w['B1']}, serial "
          f"{counts_s['B1']}; solutions and iterations bitwise equal (rtol 0, atol 0) {equal}  "
          f"[{card}]", flush=True)
    if not equal or counts_w["B1"] != counts_s["B1"]:
        raise AssertionError("frames workers differ from serial blocks")
    runs[f"{DIM}x{DIM} frames (2, 1, 1) serial blocks"] = counts_s
    runs[f"{DIM}x{DIM} frames (2, 1, 1) workers"] = counts_w

    # 2. the exchange route on one card: the 1024x1024 pair on (1, 2, 2)
    tile_mesh = make_mesh([dev] * 4, frames=1, tx=2, ty=2)
    pallas = dict(kw, solver=SolverConfig(matvec="pallas"))
    spmd.SEAM_COPIES = 0
    wall, u_x, its_x, conv, counts = _solve_to_host(large, tile_mesh, as_distinct=True, **pallas)
    seams = spmd.SEAM_COPIES
    d = np.sqrt((u_x[:, 0] - oracle["v_x"]) ** 2 + (u_x[:, 1] - oracle["v_y"]) ** 2)
    e = float(d[0, 1:-1, 1:-1].max())
    u_w, its_w, counts_w = windows
    equal = np.array_equal(u_x, u_w) and its_x.tolist() == its_w
    print(f"1024 sharded_variational_solve matvec='pallas' mesh (1, 2, 2), exchange route on "
          f"one card: {wall:.3f} s, iterations {its_x.tolist()}, converged {conv.tolist()}, "
          f"counts {counts}, B3 launches {counts['B3']} (windows route {counts_w['B3']}, x4 = "
          f"{4 * counts_w['B3']}), seam copies {seams}, EPE {e:.3e} px vs the float64 oracle "
          f"(limit {EPE_LIMIT_PX:g}), bitwise equal to the windows route {equal}  [{card}]",
          flush=True)
    eager = bypassed(counts, "B3", graphs=False)  # the route's eager Krylov loop
    if not conv.all() or eager or counts["B3"] != 4 * counts_w["B3"]:
        raise AssertionError(f"exchange route: not converged, not the eager loop or not 4 B3 "
                             f"launches per application: {counts}")
    if not equal or not e < EPE_LIMIT_PX:
        raise AssertionError(f"exchange route differs from the windows route or EPE {e} px")
    runs[f"{LARGE_DIM}x{LARGE_DIM} sharded (1, 2, 2) exchange"] = counts

    # 3. the same over distinct GPUs, where the machine has two
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        print(f"distinct-device runs: they need two or more GPUs; this machine has {n_gpus}",
              flush=True)
        return runs
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    _, u, its, conv, counts = _solve_to_host(movie, make_mesh(two, frames=2, tx=1, ty=1), **kw)
    equal = np.array_equal(u, u_s) and np.array_equal(its, its_s)
    print(f"{DIM}x{DIM} bench movie, mesh (2, 1, 1) over cuda:0 and cuda:1: iterations "
          f"{its.tolist()}, counts {counts}, bitwise equal to one card's serial blocks {equal}  "
          f"[{card}]", flush=True)
    if not equal or not conv.all():
        raise AssertionError("frames over two GPUs differ from one card")
    runs[f"{DIM}x{DIM} frames (2, 1, 1) two GPUs"] = counts
    _, u_1, its_1, _, _ = _solve_to_host(large, make_mesh([dev] * 2, frames=1, tx=2, ty=1),
                                         **pallas)
    _, u, its, conv, counts = _solve_to_host(large, make_mesh(two, frames=1, tx=2, ty=1),
                                             **pallas)
    equal = np.array_equal(u, u_1) and np.array_equal(its, its_1)
    print(f"1024 mesh (1, 2, 1) over cuda:0 and cuda:1 ('pallas'): iterations {its.tolist()}, "
          f"counts {counts}, bitwise equal to one card's windows route {equal}  [{card}]",
          flush=True)
    if not equal or not conv.all() or bypassed(counts, "B3"):
        raise AssertionError("tiles over two GPUs differ from one card or bypassed B3")
    runs[f"{LARGE_DIM}x{LARGE_DIM} sharded (1, 2, 1) two GPUs"] = counts
    return runs


def sharded_path(large, oracle, movie, dev, card):
    """Phase 6's runs: the 1024x1024 pair through ``sharded_variational_solve``
    (``matvec='pallas'``) on the (1, 1, 1) and (1, 2, 2) meshes of the card,
    then the distinct-device routes (:func:`distinct_device_runs`), then
    ``distributed_variational_solve`` in a world of one on the bench
    movie, with ``'pallas'`` and with the default solver; returns the counts
    of each run."""
    import torch.distributed as dist

    from opticalflow_tpu_torch import SolverConfig
    from opticalflow_tpu_torch.parallel import distributed
    from opticalflow_tpu_torch.parallel.batch import sharded_variational_solve
    from opticalflow_tpu_torch.parallel.mesh import make_mesh

    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA, solver=SolverConfig(matvec="pallas"))
    runs = {}
    for mesh in (make_mesh(), make_mesh([dev] * 4, frames=1, tx=2, ty=2)):
        shape = tuple(mesh.shape.values())
        reset_counters()
        t0 = time.perf_counter()
        all_u, infos = sharded_variational_solve(large, mesh=mesh, **kw)
        all_u = all_u.cpu().numpy()  # synchronised
        wall = time.perf_counter() - t0
        counts = read_counters()
        d = np.sqrt((all_u[:, 0] - oracle["v_x"]) ** 2 + (all_u[:, 1] - oracle["v_y"]) ** 2)
        e = float(d[0, 1:-1, 1:-1].max())
        conv = infos["converged"].cpu().numpy()
        print(f"1024 sharded_variational_solve matvec='pallas' mesh {shape}: {wall:.3f} s, "
              f"iterations {infos['iterations'].tolist()}, converged {conv.tolist()}, counts "
              f"{counts}, EPE {e:.3e} px vs the float64 oracle (limit {EPE_LIMIT_PX:g})  [{card}]",
              flush=True)
        if not conv.all():
            raise AssertionError(f"sharded 1024 mesh {shape} did not converge")
        if bypassed(counts, "B3"):
            raise AssertionError(f"sharded 1024 mesh {shape} bypassed B3: {counts}")
        if all_u.shape != (1, 3, LARGE_DIM, LARGE_DIM) or not np.isfinite(all_u).all():
            raise AssertionError("sharded 1024: bad shape or non-finite values")
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"sharded 1024 mesh {shape}: EPE {e} px")
        runs[f"{LARGE_DIM}x{LARGE_DIM} sharded {shape}"] = counts
        windows = (all_u, infos["iterations"].tolist(), counts)
    runs.update(distinct_device_runs(large, oracle, movie, windows, dev, card))

    with socket.socket() as sock:  # a free port for the process group
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, cpu_devices=1)  # gloo; the solve runs on the card
    try:
        reset_counters()
        t0 = time.perf_counter()
        local_u, infos = distributed.distributed_variational_solve((movie[:-1], movie[1:]), **kw)
        wall = time.perf_counter() - t0
        counts = read_counters()
        # the default solver ('auto'): B1 untiled
        reset_counters()
        t0 = time.perf_counter()
        _, auto_infos = distributed.distributed_variational_solve(
            (movie[:-1], movie[1:]), speed_alpha=ALPHA, remodelling_alpha=ALPHA)
        auto_wall = time.perf_counter() - t0
        auto_counts = read_counters()
    finally:
        dist.destroy_process_group()
    ref_u, _ = sharded_variational_solve(movie, mesh=make_mesh(), **kw)
    ref_u = ref_u.cpu().numpy()
    d = np.sqrt((local_u[:, 0] - ref_u[:, 0]) ** 2 + (local_u[:, 1] - ref_u[:, 1]) ** 2)
    print(f"distributed_variational_solve, world of one (gloo), {DIM}x{DIM} bench movie: "
          f"{wall:.3f} s, iterations {infos['iterations'].tolist()}, converged "
          f"{int(infos['converged'].sum())}/{infos['converged'].size}, counts {counts}, max "
          f"|difference| vs sharded_variational_solve {float(d.max()):.3e} px (limit "
          f"{SAME_PX:g})  [{card}]", flush=True)
    if not infos["converged"].all() or bypassed(counts, "B3"):
        raise AssertionError(f"distributed solve: not converged or bypassed B3: {counts}")
    if local_u.shape != (N_FRAMES - 1, 3, DIM, DIM) or not float(d.max()) <= SAME_PX:
        raise AssertionError("distributed solve differs from sharded_variational_solve")
    runs[f"{DIM}x{DIM} distributed"] = counts
    print(f"distributed_variational_solve, world of one, default solver ('auto'): "
          f"{auto_wall:.3f} s, iterations {auto_infos['iterations'].tolist()}, converged "
          f"{int(auto_infos['converged'].sum())}/{auto_infos['converged'].size}, counts "
          f"{auto_counts}  [{card}]", flush=True)
    if not auto_infos["converged"].all() or bypassed(auto_counts, "B1"):
        raise AssertionError(f"distributed solve 'auto': not converged or bypassed B1: "
                             f"{auto_counts}")
    runs[f"{DIM}x{DIM} distributed auto"] = auto_counts
    return runs


def sweep_path(card):
    """Phase 7: the 300-solve regularisation sweep of BASELINE config 5 (one
    128x128 pair, 15 x 20 alphas on logspace(1, 5), rtol 1e-6) batched on
    the card, after a 2 x 2 warm-up of interior cells; B1 launched and no
    plain version, every statistic finite on the converged cells, and three
    interior cells equal to the serial path's; returns the timed run's
    counts."""
    from opticalflow_tpu_torch import SolverConfig
    from opticalflow_tpu_torch.analysis.sweeps import vary_regularisation
    from opticalflow_tpu_torch.utils import observability
    from opticalflow_tpu_torch.utils.sweep_chunks import REMODELLING_ALPHAS, SPEED_ALPHAS, sweep_movie

    movie = sweep_movie()
    cfg = SolverConfig(rtol=1e-6)
    t0 = time.perf_counter()
    vary_regularisation(movie, SPEED_ALPHAS[7:9], REMODELLING_ALPHAS[7:9], solver=cfg)
    warm_s = time.perf_counter() - t0
    reset_counters()
    t0 = time.perf_counter()
    res = vary_regularisation(movie + 1e-4, SPEED_ALPHAS, REMODELLING_ALPHAS, solver=cfg)
    wall = time.perf_counter() - t0  # returns host arrays: synchronised
    counts = read_counters()
    chunk_its = [int(v) for v in observability.values()["sweep/chunk_max_iterations"]]
    chunk_s = observability.span_statistics()["sweep/chunk"]
    conv = res["converged"]
    n = conv.size
    print(f"sweep path: {n} solves of 128x128 in {wall:.3f} s = {n / wall:.3f} solves/s "
          f"(warm-up 2x2 grid {warm_s:.3f} s), {len(chunk_its)} chunks of <= {sweep_chunk()} "
          f"solves, converged {int(conv.sum())}/{n}, chunk max iterations {chunk_its}, chunk "
          f"seconds max {chunk_s['max']:.3f}, B1 launches {counts['B1']}, B4 launches "
          f"{counts['B4']}, B5 {counts['B5']}, B6 {counts['B6']}, plain calls "
          f"{counts['B1 plain']}, host syncs {counts['host syncs']}  [{card}]", flush=True)
    print("  converged cells (rows: alpha_s, columns: alpha_r):\n" + "\n".join(
        "  " + "".join(str(int(c)) for c in row) for row in conv), flush=True)
    if bypassed(counts, "B1"):
        raise AssertionError(f"sweep path bypassed B1: {counts}")
    if conv.shape != (SPEED_ALPHAS.size, REMODELLING_ALPHAS.size) or not conv.any():
        raise AssertionError("sweep: bad shape or no cell converged")
    for key in ("speed_means", "speed_variances", "remodelling_means", "remodelling_variances",
                "functional", "functional_ref_compat"):
        if res[key].shape != conv.shape or not np.isfinite(res[key][conv]).all():
            raise AssertionError(f"sweep {key}: bad shape or non-finite on converged cells")
    for i, j in SWEEP_CELLS:
        t0 = time.perf_counter()
        serial = vary_regularisation(movie + 1e-4, SPEED_ALPHAS[i : i + 1],
                                     REMODELLING_ALPHAS[j : j + 1], batched=False, solver=cfg)
        rel = {}
        for field in ("speed", "remodelling"):
            mean, var = serial[f"{field}_means"][0, 0], serial[f"{field}_variances"][0, 0]
            rel[field] = abs(res[f"{field}_means"][i, j] - mean) / max(abs(mean), var**0.5)
        print(f"  cell ({i}, {j}) alpha_s {SPEED_ALPHAS[i]:.4g} alpha_r "
              f"{REMODELLING_ALPHAS[j]:.4g}: serial {time.perf_counter() - t0:.3f} s, |batched - "
              f"serial| of the means / max(|mean|, std): " + ", ".join(
                  f"{k} {v:.2e}" for k, v in rel.items()) + f" (limit {SWEEP_REL_TOL:g})",
              flush=True)
        if not (conv[i, j] and serial["converged"][0, 0]) or max(rel.values()) > SWEEP_REL_TOL:
            raise AssertionError(f"sweep cell ({i}, {j}) differs from the serial path: {rel}")
    def again():  # the statistics and each chunk's largest iteration count
        out = vary_regularisation(movie + 1e-4, SPEED_ALPHAS, REMODELLING_ALPHAS, solver=cfg)
        return dict(out, chunk_its=observability.values()["sweep/chunk_max_iterations"])

    graphed = dict(res, chunk_its=chunk_its)
    same_bits_uncaptured("sweep path", again, graphed, wall, tuple(graphed), card)
    return counts


def _max_rel_diff(a, b, finite=None):
    """max |a - b| / max |b| over the values finite in ``finite`` (``b``
    when None)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(b if finite is None else finite)
    return float(np.abs(a[ok] - b[ok]).max() / max(np.abs(b[ok]).max(), 1e-30))


def analysis_path(movie, dev, card):
    """Phase 8: the box-method flow, its box-size and blur-size sweeps,
    Liu-Shen, CLAHE, the adaptive threshold and the area resize on the
    bench movie (the sweeps on its pair (3, 4)), each on the card and then
    on the CPU from the same float32 input, NaNs in the same places.

    Where the float32 result is itself only as good as its conditioning
    (the box method's closed-form 2x2 and 3x3 solves lose ~1e-3 of the
    largest velocity in float32, and the 3x3 branch's remodelling far
    more), the card is held to the CPU's own accuracy: both against the
    float64 run on the CPU, the card's error at most twice the CPU's plus
    1e-6 of the largest value.  The others are held to a bound on max
    |card - cpu| / max |cpu|: CLAHE's bins and histograms are exact and
    its CDF a float32 scan (1.5e-5 of the 65535 range is 1), the threshold
    compares means of integers, exact in float32, and the resize is two
    float32 matrix products (1e-6).
    """
    from opticalflow_tpu_torch import conduct_optical_flow
    from opticalflow_tpu_torch.analysis.hyperparams import vary_blursize, vary_boxsize
    from opticalflow_tpu_torch.flow.liushen import conduct_variational_optical_flow_deprecated
    from opticalflow_tpu_torch.ops.clahe import apply_clahe
    from opticalflow_tpu_torch.ops.resize import area_resize_movie
    from opticalflow_tpu_torch.ops.threshold import apply_adaptive_threshold

    flow, sweep = ("v_x", "v_y", "speed"), ("mean_speeds", "speed_stds", "local_speeds")
    f = ANALYSIS_PAIR
    f32 = torch.float32
    # (name, run on a device in a dtype, outputs compared, None for the
    # accuracy rule or the bound on max |card - cpu| / max |cpu|)
    runs = [
        ("conduct_optical_flow boxsize 15", lambda d, t: conduct_optical_flow(
            movie, boxsize=15, device=d, dtype=t), flow, None),
        ("conduct_optical_flow boxsize 15 with remodelling", lambda d, t: conduct_optical_flow(
            movie, boxsize=15, include_remodelling=True, device=d, dtype=t),
         flow + ("net_remodelling",), None),
        (f"vary_boxsize (defaults, pair ({f}, {f + 1}))", lambda d, t: vary_boxsize(
            movie, frame_index=f, device=d, dtype=t), sweep, None),
        (f"vary_blursize (defaults, pair ({f}, {f + 1}))", lambda d, t: vary_blursize(
            movie, frame_index=f, device=d, dtype=t), sweep, None),
        ("Liu-Shen, 10 sweeps", lambda d, t: conduct_variational_optical_flow_deprecated(
            movie, use_liu_shen=True, max_iterations=10, device=d, dtype=t), flow, None),
        ("apply_clahe", lambda d, t: {"out": apply_clahe(movie, device=d).cpu().numpy()},
         ("out",), 1.5e-5),
        ("apply_adaptive_threshold", lambda d, t: {"out": apply_adaptive_threshold(
            movie, device=d).cpu().numpy()}, ("out",), 0.0),
        ("area_resize_movie to 128x128", lambda d, t: {"out": area_resize_movie(
            movie, 128, 128, device=d).cpu().numpy()}, ("out",), 1e-6),
    ]
    for name, run, keys, bound_rel in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = run(dev, f32)  # host arrays: synchronised
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = run("cpu", f32)
        cpu_s = time.perf_counter() - t0
        for key in keys:
            a, b = np.asarray(on_card[key]), np.asarray(on_cpu[key])
            if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"{name} {key}: shapes or NaN positions differ")
        diffs = {key: _max_rel_diff(on_card[key], on_cpu[key]) for key in keys}
        line = (f"{name}: card {card_s:.3f} s, CPU {cpu_s:.3f} s; max |card - cpu| / max |cpu| "
                + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
        if bound_rel is None:
            ref = run("cpu", torch.float64)
            errs = {}
            for key in keys:
                finite = np.asarray(ref[key]) + np.asarray(on_card[key]) + np.asarray(on_cpu[key])
                errs[key] = (_max_rel_diff(on_card[key], ref[key], finite),
                             _max_rel_diff(on_cpu[key], ref[key], finite))
            print(line + "; error vs the CPU's float64 run, card / CPU: " + ", ".join(
                f"{k} {c:.2e} / {p:.2e}" for k, (c, p) in errs.items())
                + f" (limit 2 x CPU + 1e-6)  [{card}]", flush=True)
            if any(c > 2.0 * p + 1e-6 for c, p in errs.values()):
                raise AssertionError(f"{name}: the card is less accurate than the CPU: {errs}")
        else:
            print(line + f" (limit {bound_rel:g})  [{card}]", flush=True)
            if max(diffs.values()) > bound_rel:
                raise AssertionError(f"{name}: the card differs from the CPU: {diffs}")


def host_packages():
    """Which host packages import here and which tools are on the PATH."""
    found = {m: importlib.util.find_spec(m) is not None for m in HOST_PACKAGES}
    found.update({t: shutil.which(t) is not None for t in ("ffmpeg", "g++")})
    return found


def cli_path(stack, dev, card):
    """Phase 9: the command line on files.  Returns the counts of the
    ``variational`` and ``sweep`` runs."""
    from opticalflow_tpu_torch import FlowResult, SolverConfig, conduct_optical_flow
    from opticalflow_tpu_torch import variational_optical_flow
    from opticalflow_tpu_torch.analysis import drivers
    from opticalflow_tpu_torch.io import native_loader, sequences
    from opticalflow_tpu_torch.utils.observability import TRACE_FILE, span_statistics

    found = host_packages()
    print("host packages: " + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in found.items()),
          flush=True)
    whole = found["matplotlib"]  # the one check that decides how the phase runs
    if not whole:
        print("matplotlib is not installed: the drivers' compute-and-save steps run; the plot "
              "steps not drawn: plot_variational (variational_joint.mp4), plot_sweep "
              "(regularisation_sweep.pdf)", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the input files
        tiff, pgm = os.path.join(tmp, "stack.tif"), os.path.join(tmp, "pgm")
        pgm_movie = counts_movie(PGM_FRAMES, PGM_DIM)
        t0 = time.perf_counter()
        write_tiff_stack(tiff, stack)
        write_pgm_folder(pgm, pgm_movie)
        mb = os.path.getsize(tiff) / 1e6
        print(f"wrote {tiff}: {stack.shape[0]} x {CLI_DIM}x{CLI_DIM} uint16, {mb:.1f} MB, and "
              f"{PGM_FRAMES} PGM frames of {PGM_DIM}x{PGM_DIM} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        # 2. loading: the native loader, built here with g++
        t0 = time.perf_counter()
        if not native_loader.available():
            raise AssertionError("the native loader did not build (g++) or load")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = native_loader.read_tiff_movie_native(tiff)  # raises if not parseable
        read_s = time.perf_counter() - t0
        loaded = sequences.read_tiff_movie(tiff)
        folder = sequences.read_image_sequence_as_movie(pgm)
        print(f"native loader: built and loaded in {build_s:.3f} s; TIFF read {read_s * 1e3:.3f} "
              f"ms = {mb / read_s:.1f} MB/s (float32 out); io.sequences equal to what was "
              f"written: TIFF {np.array_equal(loaded, stack)}, PGM "
              f"{np.array_equal(folder, pgm_movie)}  [{card}]", flush=True)
        if not (np.array_equal(native, stack) and np.array_equal(loaded, stack)
                and np.array_equal(folder, pgm_movie) and loaded.dtype == np.float64):
            raise AssertionError("the loaded movies differ from the written ones")

        # 3. variational, as a user runs it (no --device: the card)
        out = os.path.join(tmp, "variational")
        geometry = ["--delta-x", CLI_DELTA_X, "--delta-t", CLI_DELTA_T]
        reset_counters()
        t0 = time.perf_counter()
        if whole:
            result = drivers.main(["variational", tiff, "--output-dir", out, *geometry])
        else:
            result = drivers.compute_variational(tiff, out, delta_x=float(CLI_DELTA_X),
                                                 delta_t=float(CLI_DELTA_T))
        wall = time.perf_counter() - t0
        counts = read_counters()
        spans = {name: v["total"] for name, v in span_statistics().items()}
        n_pairs = stack.shape[0] - 1
        its, conv = result["iterations"], result["converged_all"]
        solve_s = spans["variational/solve"]
        print(f"variational CLI: {n_pairs} pairs {CLI_DIM}x{CLI_DIM} in {wall:.3f} s: load "
              f"{spans['drivers/load']:.3f}, solve {solve_s:.3f}, save "
              f"{spans['drivers/save']:.3f}, plot "
              + (f"{spans['drivers/plot']:.3f}" if whole else "not drawn")
              + f" s; {n_pairs / solve_s:.3f} pairs/s (solve), {n_pairs / wall:.3f} pairs/s "
              f"(command); iterations median {int(np.median(its))} max {int(its.max())}, "
              f"converged {int(conv.sum())}/{conv.size}, B4 launches {counts['B4']}, B5 "
              f"{counts['B5']}, B6 {counts['B6']}, B1 "
              f"launches {counts['B1']} "
              f"({counts['B1'] / n_pairs:.1f} per pair), plain calls {counts['B1 plain']}, host "
              f"syncs {counts['host syncs']}  [{card}]", flush=True)
        if conv.shape != (n_pairs,) or not conv.all():
            raise AssertionError(f"variational CLI: not every pair converged: {conv.tolist()}")
        if bypassed(counts, "B1"):
            raise AssertionError(f"variational CLI bypassed B1: {counts}")
        saved = FlowResult.load(os.path.join(out, "variational_result.npy"))
        for key in ("v_x", "v_y", "speed", "remodelling", "iterations", "converged_all"):
            if not np.array_equal(saved[key], result[key]):
                raise AssertionError(f"variational CLI: the saved {key} differs")
        runs[f"{CLI_DIM}x{CLI_DIM} CLI variational ({n_pairs} pairs)"] = counts

        kw = dict(delta_x=float(CLI_DELTA_X), delta_t=float(CLI_DELTA_T), speed_alpha=ALPHA,
                  remodelling_alpha=ALPHA)
        direct = variational_optical_flow(loaded[:4], **kw)
        same = max(_max_rel_diff(result[k][:3], direct[k]) for k in ("v_x", "v_y", "remodelling"))
        t0 = time.perf_counter()
        oracle = variational_optical_flow(loaded[:2], dtype=torch.float64, solver=SolverConfig(
            method="gmres", rtol=1e-10, refinement_restarts=0, matvec="xla"), **kw)
        oracle_s = time.perf_counter() - t0
        px = float(CLI_DELTA_T) / float(CLI_DELTA_X)  # physical units -> px per frame
        d = np.hypot(result["v_x"][0] - oracle["v_x"][0], result["v_y"][0] - oracle["v_y"][0])
        epe = float(d[1:-1, 1:-1].max()) * px
        print(f"  pairs 0-2 vs a direct variational_optical_flow of frames 0-3: max rel diff "
              f"{same:.3e} (limit {CLI_SAME_REL:g}); pair 0 EPE {epe:.3e} px vs the float64 "
              f"FGMRES oracle (rtol 1e-10, {oracle_s:.3f} s, {int(oracle['iterations'][0])} "
              f"iterations; limit {EPE_LIMIT_PX:g})", flush=True)
        if not same <= CLI_SAME_REL:
            raise AssertionError(f"variational CLI differs from the direct call: {same}")
        if not (oracle["converged_all"].all() and epe < EPE_LIMIT_PX):
            raise AssertionError(f"variational CLI pair 0: EPE {epe} px")

        # 4. sweep on frames 0:2, the CLI's default alphas (3 x 3)
        out = os.path.join(tmp, "sweep")
        reset_counters()
        t0 = time.perf_counter()
        if whole:
            sweep = drivers.main(["sweep", tiff, "--frames", "0:2", "--output-dir", out])
        else:
            sweep = drivers.compute_sweep(tiff, out, frames="0:2")
        wall = time.perf_counter() - t0
        counts = read_counters()
        print(f"sweep CLI: {sweep['converged'].size} solves of {CLI_DIM}x{CLI_DIM} in "
              f"{wall:.3f} s, converged {int(sweep['converged'].sum())}/"
              f"{sweep['converged'].size}, B1 launches {counts['B1']}, plain calls "
              f"{counts['B1 plain']}  [{card}]", flush=True)
        if bypassed(counts, "B1") or not os.path.exists(
                os.path.join(out, "regularisation_sweep.npy")):
            raise AssertionError(f"sweep CLI bypassed B1 or saved nothing: {counts}")
        runs[f"{CLI_DIM}x{CLI_DIM} CLI sweep (9 solves)"] = counts

        # 5. box under --profile
        out, prof = os.path.join(tmp, "box"), os.path.join(tmp, "profile")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box = drivers.main(["--profile", prof, "box", tiff, "--output-dir", out, *geometry])
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = conduct_optical_flow(loaded, boxsize=31, delta_x=float(CLI_DELTA_X),
                                   delta_t=float(CLI_DELTA_T), smoothing_sigma=3.0)
        direct_s = time.perf_counter() - t0  # returns host arrays: synchronised
        equal = all(np.array_equal(box[k], ref[k], equal_nan=True) for k in ("v_x", "v_y", "speed"))
        trace = os.path.join(prof, TRACE_FILE)
        print(f"box CLI (boxsize 31, sigma 3) under --profile: {wall:.3f} s (the direct "
              f"conduct_optical_flow of the loaded movie, unprofiled: {direct_s:.3f} s), equal to "
              f"it {equal}, trace {os.path.getsize(trace) / 1e6:.1f} MB  [{card}]", flush=True)
        if not equal:
            raise AssertionError("box CLI differs from conduct_optical_flow")
    return runs


def same_bits_uncaptured(label, run, graphed, graphed_s, keys, card):
    """``run()`` again with every Krylov step run on the card without
    capture (``krylov._uncaptured``, the private entry for this check), the
    counters set to 0 just before: each array of ``graphed`` under ``keys``
    (``graphed_s`` seconds, its Krylov steps replayed from CUDA graphs) must
    equal its uncaptured counterpart bit for bit (NaN where NaN), the
    iterations included; prints both walls and the uncaptured run's
    counts."""
    from opticalflow_tpu_torch.solve import krylov

    reset_counters()
    t0 = time.perf_counter()
    with krylov._uncaptured():
        eager = run()  # returns host arrays: synchronised
    wall = time.perf_counter() - t0
    counts = read_counters()
    same = {k: np.array_equal(np.asarray(graphed[k]), np.asarray(eager[k]),
                              equal_nan=np.asarray(eager[k]).dtype.kind == "f") for k in keys}
    print(f"{label}: CUDA graphs {graphed_s:.3f} s, the same steps uncaptured {wall:.3f} s "
          f"(counts {counts}); bitwise equal {all(same.values())} ({same})  [{card}]",
          flush=True)
    if not all(same.values()) or counts["graph captures"]:
        raise AssertionError(f"{label}: the graphed solve differs from its uncaptured steps")


def oracle_epe(movie, result, k):
    """EPE (px) of pair k against the float64 assembled direct solve, its
    planes built in float64 on the CPU."""
    from opticalflow_tpu_torch.ops import elop
    from opticalflow_tpu_torch.solve import direct

    frames = torch.from_numpy(movie[k : k + 2].astype(np.float64))
    pair = elop.compute_frame_pair_data(frames[:1], frames[1:], ALPHA, ALPHA, "compat")
    u_ref, _ = direct.direct_solve(elop.ELCoefficients(*[f[0] for f in pair.coeffs]),
                                   pair.rhs[0].numpy())
    d = np.sqrt((result["v_x"][k] - u_ref[0]) ** 2 + (result["v_y"][k] - u_ref[1]) ** 2)
    return float(d[1:-1, 1:-1].max())


def f32_reductions_run(movie_t, movie, kw, card):
    """Phase 4's second run: the bench solve in the reference's TPU mode,
    float32 Krylov reductions (``high_precision_reductions=False``): every
    pair converged, B1 launched, pairs 1 and 11 within the EPE limit of
    the float64 direct solve."""
    from opticalflow_tpu_torch import SolverConfig, variational_optical_flow

    reset_counters()
    t0 = time.perf_counter()
    result = variational_optical_flow(
        movie_t, solver=SolverConfig(high_precision_reductions=False), **kw)
    wall = time.perf_counter() - t0
    counts = read_counters()
    conv = np.asarray(result["converged_all"])
    epes = {k: oracle_epe(movie, result, k) for k in ORACLE_PAIRS}
    print(f"main path, float32 reductions: {conv.size} pairs in {wall:.3f} s, iterations "
          f"{np.asarray(result['iterations']).tolist()}, converged {int(conv.sum())}/{conv.size}, "
          f"counts {counts}, EPE " + ", ".join(f"pair {k} {e:.3e}" for k, e in epes.items())
          + f" px vs the f64 direct solve (limit {EPE_LIMIT_PX:g})  [{card}]", flush=True)
    if conv.shape != (N_FRAMES - 1,) or not conv.all():
        raise AssertionError(f"float32 reductions: not every pair converged: {conv.tolist()}")
    if bypassed(counts, "B1"):
        raise AssertionError(f"float32 reductions: the run bypassed B1: {counts}")
    if not max(epes.values()) < EPE_LIMIT_PX:
        raise AssertionError(f"float32 reductions: EPE {epes} px")


def main():
    # 1. the device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from opticalflow_tpu_torch import variational_optical_flow
    from opticalflow_tpu_torch.ops import cuda_kernels as ck

    # 2. build
    t0 = time.perf_counter()
    ck.load_library()
    print(f"build: {', '.join(sorted(ck.ENTRY_POINTS))} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {ck.BUILD_SECONDS} s, one process per source)")
    for line in ck.BUILD_LOG.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions
    movie = bench_movie()
    large = embryo_pair()
    stack = counts_movie(CLI_FRAMES, CLI_DIM)
    entries = check_kernels(movie, large, stack[:1].astype(np.float32), dev, smi)
    check_extended_kernel(movie, large, dev, smi, entries["el_matvec_extended"])
    check_df32_kernel(movie, large, stack[:2].astype(np.float32), dev, smi, entries["el_df32"])
    check_mg_kernels(dev, smi, entries)
    check_gs_kernel(dev, smi, entries["gram_schmidt"])
    usage = kernel_usage()
    for kernel, entry in entries.items():
        used = usage.get(os.path.basename(KERNELS[kernel][1]))
        entry.setdefault("registers",
                         {_short(fn): u["registers"] for fn, u in used.items()} if used else None)

    # 4. the main path
    movie_t = torch.from_numpy(movie).to(dev)
    kw = dict(speed_alpha=ALPHA, remodelling_alpha=ALPHA, warm_start="two-pass")
    t0 = time.perf_counter()
    variational_optical_flow(movie_t, **kw)
    warm_s = time.perf_counter() - t0
    reset_counters()
    t0 = time.perf_counter()
    result = variational_optical_flow(movie_t, **kw)  # returns host arrays: synchronised
    solve_s = time.perf_counter() - t0
    counts = read_counters()
    launches, plain, syncs = counts["B1"], counts["B1 plain"], counts["host syncs"]

    n_pairs = N_FRAMES - 1
    conv = np.asarray(result["converged_all"])
    its = np.asarray(result["iterations"])
    print(f"main path: {n_pairs} pairs {DIM}x{DIM} in {solve_s:.3f} s (warm-up run "
          f"{warm_s:.3f} s) = {n_pairs / solve_s:.3f} pairs/s [{smi}]")
    print(f"  iterations per pair {its.tolist()}, converged {int(conv.sum())}/{conv.size}, "
          f"el_matvec launches {launches} ({launches / n_pairs:.1f} per pair), plain-version "
          f"calls {plain}, host syncs {syncs}, counts {counts}", flush=True)
    if conv.shape != (n_pairs,) or not conv.all():
        raise AssertionError(f"not every pair converged: {conv.tolist()}")
    if bypassed(counts, "B1"):
        raise AssertionError(f"main path bypassed the kernel: {counts}")
    for key in ("v_x", "v_y", "remodelling"):
        if result[key].shape != (n_pairs, DIM, DIM) or not np.isfinite(result[key]).all():
            raise AssertionError(f"{key}: bad shape or non-finite values")
    for k in ORACLE_PAIRS:
        e = oracle_epe(movie, result, k)
        print(f"  pair {k}: EPE {e:.3e} px vs the f64 direct solve (limit {EPE_LIMIT_PX:g})",
              flush=True)
        if not e < EPE_LIMIT_PX:
            raise AssertionError(f"pair {k}: EPE {e} px")
    same_bits_uncaptured("main path", lambda: variational_optical_flow(movie_t, **kw), result,
                         solve_s, ("v_x", "v_y", "remodelling", "iterations", "converged_all",
                                   "residual_norms"), smi)
    f32_reductions_run(movie_t, movie, kw, smi)
    from opticalflow_tpu_torch.flow.variational import profile_solve_phases

    print_phases(f"{DIM} pair 0", profile_solve_phases(movie_t[0], movie_t[1], ALPHA, ALPHA,
                                                       reps=2), smi)

    # 5. the large-grid path
    large_runs, oracle = large_grid_path(large, dev, smi)
    # 6. the sharded path
    sharded_runs = sharded_path(large, oracle, movie, dev, smi)
    # 7. the sweep path
    sweep_counts = sweep_path(smi)
    # 8. the other analyses, card against CPU
    analysis_path(movie, dev, smi)
    # 9. the command line on files
    cli_runs = cli_path(stack, dev, smi)
    runs = {f"{DIM}x{DIM} two-pass": counts, **large_runs, **sharded_runs,
            "128x128 sweep (300 solves)": sweep_counts, **cli_runs}

    for kernel, entry in entries.items():
        label = KERNELS[kernel][0]
        entry["launches_by_path"] = {path: c[label] for path, c in runs.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
