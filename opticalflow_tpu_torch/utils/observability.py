"""Module logger, named wall-clock spans, event counters and traces.

Counterpart of ``opticalflow_tpu.utils.observability``: the logger,
``span`` / :class:`Timer` (named wall-clock spans in a process-wide
registry), ``format_elapsed_time`` (the reference's minutes / seconds /
milliseconds), ``reset_spans`` and ``profile_trace``, here a
``torch.profiler`` trace in place of ``jax.profiler``'s.  A span measures
host time: around CUDA work it measures the enqueue, and the host's waits
for the card inside it.  While a ``torch.profiler`` profile runs, a span
also opens a ``record_function`` range of its name, so the program's spans
sit on the device trace's clock, nested as in the code; otherwise it costs
two clock reads and an append under the lock.

What the port records, and where (the benchmark's readers in
``portbench/metrics/`` name what reads each):

* spans ``pair/pair_data``, ``pair/mg_setup``, ``pair/krylov_main``,
  ``pair/refinement``, ``pair/finish``: the five phases of each
  ``flow.variational.solve_frame_pair`` call, which cover it;
  ``variational/solve`` (the movie's solve) and within it
  ``variational/to_host`` (every device-to-host copy of a call);
* span ``solve/host_wait`` (:func:`host_wait`): every synchronising call on
  a call's path outside ``variational/to_host``, the host waiting for the
  card: the Krylov loops' and the refinement's reads, the refinement's
  index copy, the multigrid LU's error check, the copies of scalar alphas
  and of the movie to the card;
* span ``krylov/capture``: each CUDA graph capture's host time;
  counters ``krylov/host_syncs`` (the Krylov loops' and the refinement
  loop's reads of the card) and ``krylov/graph_captures``, see
  solve.krylov;
* counters ``refinement/steps`` (the refinement loop's reads of its active
  set) and ``refinement/retakes`` (its re-slices of the operators and
  hierarchy to a smaller active set);
* series ``variational/pair_s`` (each pair's host wall in the sequential
  loop); per sweep chunk the series ``sweep/chunk_max_iterations``,
  ``sweep/chunk_cell_iterations`` and ``sweep/chunk_cells``, the counter
  ``sweep/unconverged_cells`` and the span ``sweep/chunk``
  (analysis.sweeps);
* the command line's and the workflows' spans (``drivers/load``,
  ``drivers/save``, ``drivers/plot``; ``flow:<method>``, ``viz:*`` and
  others in analysis.workflows).

Spans, counters and series are recorded under a lock, so several threads
may record at once (the sharded solve's workers): a span keeps its own
start time, so spans opened in different threads need no common nesting.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, List, Tuple

import torch

logger = logging.getLogger("opticalflow_tpu_torch")

_SPANS: Dict[str, List[float]] = defaultdict(list)
_COUNTS: Dict[str, int] = defaultdict(int)
_VALUES: Dict[str, List[float]] = defaultdict(list)
_LOCK = threading.Lock()


def add_count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def record_value(name: str, value: float) -> None:
    """Append one reading to a named series (such as the largest iteration
    count of each chunk of a sweep, ``sweep/chunk_max_iterations``)."""
    with _LOCK:
        _VALUES[name].append(float(value))


def values() -> Dict[str, List[float]]:
    with _LOCK:
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
    with _LOCK:
        _SPANS.clear()


def reset() -> None:
    """Clear all spans, counters and series."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        _VALUES.clear()


def record_span(name: str, seconds: float) -> None:
    """Record an externally measured duration as a span."""
    with _LOCK:
        _SPANS[name].append(float(seconds))


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Record a named wall-clock span into the process registry; while a
    ``torch.profiler`` profile runs, inside a ``record_function`` range of
    the same name."""
    profiled = torch.autograd.profiler._is_profiler_enabled  # a flag the profiler keeps for this
    with torch.profiler.record_function(name) if profiled else contextlib.nullcontext():
        start = time.perf_counter()
        try:
            yield
        finally:
            record_span(name, time.perf_counter() - start)


HOST_WAIT = "solve/host_wait"


def host_wait() -> ContextManager[None]:
    """The span ``solve/host_wait``, around one call that synchronises with
    the card: a read of a device value, or a copy between pageable host
    memory and the card.  Its total is the host's wall spent waiting."""
    return span(HOST_WAIT)


def span_statistics() -> Dict[str, Dict[str, float]]:
    """count / total / mean / min / max of every recorded span."""
    with _LOCK:
        spans = {name: list(v) for name, v in _SPANS.items()}
    return {
        name: {"count": len(v), "total": sum(v), "mean": sum(v) / len(v),
               "min": min(v), "max": max(v)}
        for name, v in spans.items()
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
        record_span(self.name, self.elapsed)
        return False

    def report(self) -> str:
        minutes, seconds, milliseconds = format_elapsed_time(self.elapsed)
        return f"{self.name}: {minutes} minutes, {seconds} seconds, {milliseconds} milliseconds"
