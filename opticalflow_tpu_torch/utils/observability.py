"""Module logger, named wall-clock spans and event counters.

Counterpart of ``opticalflow_tpu.utils.observability`` (logger and
``span``).  A span measures host time: around CUDA work it measures the
enqueue unless the block ends in a synchronisation (the variational solve's
span does, since it copies its results to the host).  Counters count host
events, such as the device-to-host reads of the Krylov loop condition
(``krylov/host_syncs``).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, List

logger = logging.getLogger("opticalflow_tpu_torch")

_SPANS: Dict[str, List[float]] = defaultdict(list)
_COUNTS: Dict[str, int] = defaultdict(int)


def add_count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset() -> None:
    """Clear all spans and counters."""
    _SPANS.clear()
    _COUNTS.clear()


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
