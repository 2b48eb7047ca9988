"""Timing on the card with CUDA events (imported only where a card is).

* :func:`call_ms`: milliseconds per call of back-to-back calls, the host's
  launch included (a call shorter than its launch measures the launch);
* :func:`device_ms`: milliseconds per call on the device alone: the calls
  captured once in a CUDA graph and the graph replayed, so no host launch
  sits between them.

Both warm up first and return the median of ``rounds`` timed runs.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


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


def device_ms(fn: Callable, launches: int = 100, rounds: int = 5) -> float:
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
