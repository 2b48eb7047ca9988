"""Timing on the card with CUDA events (imported only where a card is).

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

The card's rates, from the H100 SXM data sheet, for the bounds of the
kernels (``chip_smoke.py``, :mod:`kernel_ab`, :mod:`df32_cases`):
``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S`` and ``F32_ISSUE_PER_S``.
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
