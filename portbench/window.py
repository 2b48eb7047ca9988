"""The measured window: whole calls back to back, and the rate over them.

Calls run one after another, the next as soon as the last returns (a
closed loop with one caller).  The window ends with the first call that
ends at or after ``seconds`` from the window's start; no call is cut and
none is left out, so the rate is every pair of every call over the whole
wall from the first call's start to the last call's end.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, NamedTuple


class Call(NamedTuple):
    start: float
    end: float
    pairs: int
    result: Any
    cpu_s: float  # the process's CPU seconds during the call, all threads


def run(call: Callable[[int], Any], pairs_of: Callable[[Any], int], seconds: float,
        clock: Callable[[], float] = time.perf_counter,
        cpu_clock: Callable[[], float] = time.process_time) -> List[Call]:
    """Calls ``call(0)``, ``call(1)``, ... until one ends ``seconds`` or more
    after the first began; ``pairs_of(result)`` counts a call's pairs."""
    calls: List[Call] = []
    t0 = clock()
    while True:
        start, cpu = clock(), cpu_clock()
        result = call(len(calls))
        end = clock()
        calls.append(Call(start, end, pairs_of(result), result, cpu_clock() - cpu))
        if end - t0 >= seconds:
            return calls


def wall(calls: List[Call]) -> float:
    """From the first call's start to the last call's end."""
    return calls[-1].end - calls[0].start


def pairs_per_s(calls: List[Call]) -> float:
    return sum(c.pairs for c in calls) / wall(calls)
