"""The traced window: ``torch.profiler`` around the calls, reduced in memory.

Nothing is written to disk: the profiler's raw events are read as it
holds them.  Device operations (kernels, copies, sets) give the device's busy
time (``busy.union``), their time by name, and each kernel family's time
(``kernel_families.json``); host operations name the idle gaps, each by
the innermost host operation open at the gap's middle, or else the last
one that ended before it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

from portbench import busy, files

TOP = 10  # entries of each breakdown list


def traced(run_window: Callable[[], list]):
    """``(calls, device_ops, host_ops)`` of ``run_window()`` under the
    profiler: device and host operations as (name, start us, end us), read
    from the profiler's raw events (building its per-event Python objects
    takes minutes for a window of a few hundred thousand launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls = run_window()
        torch.cuda.synchronize()
    device_ops: List[Tuple[str, float, float]] = []
    host_ops: List[Tuple[str, float, float]] = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():  # a host range the profiler also draws on the device
            continue
        item = (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
        (device_ops if e.device_type() == DeviceType.CUDA else host_ops).append(item)
    return calls, device_ops, host_ops


def reduce(device_ops, host_ops, fams: Dict[str, List[str]]) -> dict:
    """Busy seconds, seconds by family and the breakdown lists."""
    busy_us, gaps = busy.union((a, b) for _, a, b in device_ops)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in device_ops:
        by_name[name] += (b - a) * 1e-6
    by_family: Dict[str, float] = defaultdict(float)
    for name, seconds in by_name.items():
        family = files.family_of(name, fams)
        if family is not None:
            by_family[family] += seconds
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "family_s": dict(by_family),
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[n, (g[1] - g[0]) * 1e-6]
                          for n, g in zip(name_gaps(longest, host_ops), longest)]}


def name_gaps(gaps: List[Tuple[float, float]], host_ops) -> List[str]:
    """For each gap, the innermost host operation open at its middle, or
    ``after <op>`` for the last one that ended before it, or ``host``."""
    if not host_ops:
        return ["host"] * len(gaps)
    starts = np.array([a for _, a, _ in host_ops])
    ends = np.array([b for _, _, b in host_ops])
    names = []
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        if inside.size:
            names.append(host_ops[inside[np.argmin(ends[inside] - starts[inside])]][0])
            continue
        before = np.flatnonzero(ends < mid)
        names.append("after " + host_ops[before[np.argmax(ends[before])]][0]
                     if before.size else "host")
    return names
