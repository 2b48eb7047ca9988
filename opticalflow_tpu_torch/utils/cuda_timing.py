"""Timing on the card with CUDA events, and the work each kernel does.

* :func:`call_ms`: milliseconds per call of back-to-back calls, the host's
  launch included (a call shorter than its launch measures the launch);
* :func:`device_ms`: milliseconds per call on the device alone: the calls
  captured once in a CUDA graph and the graph replayed, so no host launch
  sits between them.  Warm by default: the calls replay on the same
  operands, which stay in the card's L2 cache wherever they fit (50 MB on
  an H100).  With ``cold=True`` every call in the graph follows an L2
  eviction, a read of ``L2_EVICT_BYTES`` (more than twice the L2), as a
  solve loop that walks other vectors between two calls finds it; the
  same graph of evictions alone is timed too and subtracted.  The
  eviction reads rather than writes: a write would leave up to an L2 of
  dirty lines, whose write-back the timed call would then pay.

Both warm up first and return the median of ``rounds`` timed runs.

* :func:`busy_share`: one call of a function under ``torch.profiler``,
  with the card's kernel time (the union of the kernels' intervals in the
  trace, graph replays' kernels included) over the host's wall time of the
  call.  The profiler records every host op, so the wall, and with it the
  idle share, is somewhat larger than without it.

The timers need a card; the rest is plain arithmetic, which a CPU test
holds to fixed values: the one account of what a launch of each kernel
moves and computes, in bytes and float32 operations, from which
``chip_smoke.py``'s ``bound_ms`` and :mod:`kernel_ab`'s bounds come:

* :func:`el_matvec_work` (B1, B2, B3), :func:`df32_work` (B4),
  :func:`mg_work` (B5, B6), :func:`gram_schmidt_work` (B7),
  :func:`arnoldi_givens_work` (B8);
* :func:`bound`: the least time of a launch, its bytes over the card's
  memory rate or its operations over the float32 rate, whichever is
  larger; :func:`issue_ceiling`: its operations at one issue slot each.

The card's rates are from the H100 SXM data sheet.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from typing import Callable, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12  # device memory rate (HBM3)
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, an FMA counted as two
# float32 instructions issued a second without fused multiply-adds:
# 132 SMs x 128 lanes x ~1.98 GHz
F32_ISSUE_PER_S = 33.5e12

# float32 operations per output pixel of el_stencil.cuh (B1-B3)
EL_FLOPS_PER_PIXEL = 110
# float32 operations per interior pixel of B4, counted from its source
# (csrc/el_df32.cu): 43 terms of 29 (two_prod 17, the small terms 4, two_sum 6, the
# tail 2; negations are free) and the rounding of each of the three
# channels' pairs
DF32_FLOPS_PER_PIXEL = 43 * 29 + 3


def bound(nbytes: int, flops: int) -> Tuple[float, str]:
    """(seconds, bound_by) of a launch that moves ``nbytes`` and computes
    ``flops`` float32 operations: its bytes over the memory rate
    ("bytes") or its operations over the float32 rate ("operations"),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_ceiling(flops: int) -> float:
    """Seconds of ``flops`` float32 operations at one issue slot each, as
    ``-fmad=false`` leaves them."""
    return flops / F32_ISSUE_PER_S


def el_matvec_work(N: int, K: int, m: int, n: int, lines: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one B1, B2 or B3 launch on N frame blocks of
    (m+2, n+2) and K field stacks of (m, n) each: I and the scalars read
    once, the field planes and, with ``lines``, each stack's four halo
    lines (2 (n + 2) + 2 m values a plane) read once, every output plane
    written once; the stencil's operations on every output pixel."""
    halo = 2 * (n + 2) + 2 * m if lines else 0
    nbytes = 4 * (N * (m + 2) * (n + 2) + 2 * N + 3 * N * K * (2 * m * n + halo))
    return nbytes, EL_FLOPS_PER_PIXEL * N * K * m * n


def df32_work(B: int, m: int, n: int, P: int, residual: bool) -> Tuple[int, int]:
    """(bytes, operations) of one B4 launch on B pairs of (m, n) with P
    planes: the P coefficient planes, the per-pair scalars and x read once,
    y written once, and in residual mode x_lo and the two rhs planes read
    too."""
    planes = P + 3 + 3 + (9 if residual else 0)
    return 4 * (B * m * n * planes + 6 * B), DF32_FLOPS_PER_PIXEL * B * m * n


def mg_work(kind: str, B: int, K: int, M: int, N: int) -> Tuple[int, int]:
    """(bytes, operations) of one B5 or B6 launch of ``kind`` (a key of
    ``mg_cases.KINDS``) on B pairs of K probes, fine grid (M, N): S and
    the block inverse read once a pair, fields once a probe, the output
    written once.  Operations a pixel: the stencil 27 products and 26 sums
    for each of 3 fields, the block row 5 for each, the damped update 2.
    A fused stage moves what its two stages move less what stays on chip:
    x1 is written once and read by no one, S read once."""
    fine, coarse = B * K * M * N, B * K * ((M + 1) // 2) * ((N + 1) // 2)
    stencil, pairs = 3 * 53, B * M * N
    sweep = stencil + 3 + 15 + 6
    floats, ops = {
        "sweep-residual-restrict": (99 * pairs + 3 * coarse,
                                    sweep * pairs + (stencil + 3) * fine + 24 * coarse),
        "prolong-add-sweep": (99 * pairs + 3 * coarse, 12 * fine + sweep * pairs),
        "sweep": (99 * pairs, sweep * pairs),
        "zero guess": (15 * pairs, 18 * pairs),
        "fine": (21 * pairs, 24 * pairs),
        "apply": (81 * pairs + 6 * fine, stencil * fine),
        "residual-restrict": (81 * pairs + 6 * fine + 3 * coarse,
                              (stencil + 3) * fine + 24 * coarse),
        "restrict b - y": (6 * fine + 3 * coarse, 3 * fine + 24 * coarse),
        "restrict y": (3 * fine + 3 * coarse, 24 * coarse),
        "restrict S x": (81 * pairs + 3 * fine + 3 * coarse, stencil * fine + 24 * coarse),
        "prolong-add": (6 * fine + 3 * coarse, 12 * fine),
        "prolong": (3 * fine + 3 * coarse, 9 * fine),
    }[kind]
    return 4 * floats, ops


def gram_schmidt_work(B: int, N: int, rows: int, column: bool = True) -> Tuple[int, int]:
    """(bytes with each input read once and the output written once, the
    bytes B7 moves) of one launch on B pairs of length N, float32 storage:
    a column reads ``rows`` rows of V and w and writes w2, in three passes
    over the rows, w twice and w1 once, w1 and w2 written; an update reads
    ``rows`` rows of Z and x and writes its sum.  Its sums are float64, so
    its bound is its bytes alone."""
    if column:
        return 4 * B * N * (rows + 2), 4 * B * N * (3 * rows + 5)
    return (4 * B * N * (rows + 2),) * 2


def arnoldi_givens_work(B: int, rows: int, j: int) -> Tuple[int, int]:
    """(bytes, operations) of one launch of B8 on B active pairs at column
    ``j`` of a restart of ``rows`` - 1, float32 storage and float64 sums:
    each pair reads its two dots (16 rows bytes), norms and tol (24), the j
    rotations below the column (16 j), g_j, j, act, k_cycle and rmax (21),
    and writes R's column (4 rows), its rotation (16), g_j and g_j+1, est,
    rmax, brk, j and act (26) and the outputs hj1, j1, jz and was (21); it
    computes rows sums, 6 operations a rotation and about 20 more (the new
    rotation, g, the guards)."""
    return B * (20 * rows + 16 * j + 108), B * (rows + 6 * j + 20)


def call_ms(fn: Callable, reps: int, rounds: int = 5) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


L2_EVICT_BYTES = 128 * 2**20  # > 2 x the 50 MB L2 of an H100


def device_ms(fn: Callable, launches: int = 100, rounds: int = 5, cold: bool = False) -> float:
    if not cold:
        return _graph_ms(fn, launches, rounds)
    scrub = torch.ones(L2_EVICT_BYTES // 4, device=torch.cuda.current_device())
    sink = torch.empty((), device=scrub.device)

    def evict():
        torch.sum(scrub, dim=0, out=sink)

    def cold_call():
        evict()
        fn()

    both = _graph_ms(cold_call, launches, rounds)
    return both - _graph_ms(evict, launches, rounds)


def _graph_ms(fn: Callable, launches: int, rounds: int) -> float:
    """Device ms per call of ``fn``: ``launches`` calls captured in one CUDA
    graph, the median of ``rounds`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as graphs ask
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def busy_share(fn: Callable) -> Tuple[object, float, float]:
    """``(fn(), wall seconds, kernel seconds)`` of one call of ``fn`` under
    ``torch.profiler`` (CPU and CUDA activity), the card synchronised
    before and after; kernel seconds are the union of the intervals of the
    trace's kernels, so kernels that overlap count once."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return out, wall, busy * 1e-6
