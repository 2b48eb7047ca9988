"""Module logger, named wall-clock spans, event counters and traces.

Counterpart of ``opticalflow_tpu.utils.observability``: the logger,
``span`` / :class:`Timer` (named wall-clock spans in a process-wide
registry), ``format_elapsed_time`` (the reference's minutes / seconds /
milliseconds), ``reset_spans`` and ``profile_trace``, here a
``torch.profiler`` trace in place of ``jax.profiler``'s.  A span measures
host time: around CUDA work it measures the enqueue unless the block ends
in a synchronisation (the variational solve's span does, since it copies
its results to the host).  Counters count host events, such as the
device-to-host reads of the Krylov loop condition (``krylov/host_syncs``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

logger = logging.getLogger("opticalflow_tpu_torch")

_SPANS: Dict[str, List[float]] = defaultdict(list)
_COUNTS: Dict[str, int] = defaultdict(int)
_VALUES: Dict[str, List[float]] = defaultdict(list)


def add_count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    return dict(_COUNTS)


def record_value(name: str, value: float) -> None:
    """Append one reading to a named series (such as the largest iteration
    count of each chunk of a sweep, ``sweep/chunk_max_iterations``)."""
    _VALUES[name].append(float(value))


def values() -> Dict[str, List[float]]:
    return {name: list(v) for name, v in _VALUES.items()}


def format_elapsed_time(time_difference: float) -> Tuple[int, int, int]:
    """(minutes, seconds, milliseconds) of a wall-clock difference, as the
    reference reports it."""
    minutes = int(time_difference // 60)
    seconds = int(time_difference % 60)
    milliseconds = int((time_difference - int(time_difference)) * 1000)
    return minutes, seconds, milliseconds


def reset_spans() -> None:
    """Clear the spans (counters and series stay)."""
    _SPANS.clear()


def reset() -> None:
    """Clear all spans, counters and series."""
    _SPANS.clear()
    _COUNTS.clear()
    _VALUES.clear()


def record_span(name: str, seconds: float) -> None:
    """Record an externally measured duration as a span."""
    _SPANS[name].append(float(seconds))


@contextlib.contextmanager
def span(name: str, log: bool = False) -> Iterator[None]:
    """Record a named wall-clock span into the process registry."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _SPANS[name].append(elapsed)
        if log:
            logger.info("%s: %.3fs", name, elapsed)


def span_statistics() -> Dict[str, Dict[str, float]]:
    """count / total / mean / min / max of every recorded span."""
    return {
        name: {"count": len(v), "total": sum(v), "mean": sum(v) / len(v),
               "min": min(v), "max": max(v)}
        for name, v in _SPANS.items()
    }


TRACE_FILE = "trace.json"  # the Chrome trace profile_trace writes into its log_dir


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Trace a block with ``torch.profiler`` and write it as a Chrome trace
    (chrome://tracing, Perfetto, TensorBoard) to ``log_dir/trace.json``.
    It records CPU activity, and CUDA activity where a CUDA device exists."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Timer:
    """Reusable timer with the reference's print format; each use records a
    span under its name."""

    def __init__(self, name: str = "elapsed"):
        self.name = name
        self.start = None
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        _SPANS[self.name].append(self.elapsed)
        return False

    def report(self) -> str:
        minutes, seconds, milliseconds = format_elapsed_time(self.elapsed)
        return f"{self.name}: {minutes} minutes, {seconds} seconds, {milliseconds} milliseconds"
