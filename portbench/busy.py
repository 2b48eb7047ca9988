"""Device busy time: the union of intervals, frozen.

The arithmetic of ``opticalflow_tpu_torch/utils/cuda_timing.py::busy_share``
as of commit 8e4d725 (sort the intervals, count each stretch of time that
some interval covers once), here on (start, end) pairs clipped to a
window, with the gaps between the covered stretches.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def union(intervals: Iterable[Tuple[float, float]], lo: float = float("-inf"),
          hi: float = float("inf")) -> Tuple[float, List[Tuple[float, float]]]:
    """``(covered, gaps)``: the length of [lo, hi] that the intervals cover,
    each moment once, and the uncovered stretches between the first
    covered moment and the last."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    busy, end, gaps = 0.0, float("-inf"), []
    for a, b in spans:
        if b > end:
            if a > end and end != float("-inf"):
                gaps.append((end, a))
            busy += b - max(a, end)
            end = b
    return busy, gaps
