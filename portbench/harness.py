"""One run of one cell: set-up, the window, the trace, the check, the line.

``run_cell`` does everything but look for the card, so that the tests
can drive it on the CPU with the program broken underneath.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Dict, Optional

from portbench import compare, files, profiled, window

FORBIDDEN = ("jax", "jaxlib", "flax", "opticalflow_tpu")  # top-level names, compared whole


def forbidden_modules():
    """The forbidden top-level modules that this process has loaded."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _kernel_counters() -> Dict[str, int]:
    from opticalflow_tpu_torch.ops import cuda_kernels

    return {k: v for k, v in vars(cuda_kernels).items()
            if isinstance(v, int) and (k.endswith("LAUNCHES") or k.endswith("PLAIN_CALLS"))}


def _log(message: str, t0: float) -> None:
    print(f"portbench: {time.perf_counter() - t0:8.2f} s {message}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", root: str = files.ROOT, here: str = files.HERE,
             solver_overrides: Optional[dict] = None) -> dict:
    """The result line of one run, as a dict (``check`` last)."""
    bench = files.benchmark(root)
    w = files.workload(bench, cell)
    config, traffic = files.config(w["config"], here), files.traffic(w["traffic"], here)
    limits = files.limits(cell, here)
    split = {}

    import torch

    from opticalflow_tpu_torch.ops import cuda_kernels
    from opticalflow_tpu_torch.utils import observability

    split["import_s"] = time.perf_counter() - t_start  # the interpreter's own start excluded
    cuda = torch.device(device).type == "cuda"
    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    split["context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        cuda_kernels.load_library()
    split["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    entry = files.entry(traffic["entry"], here)(config, traffic, seed, device, solver_overrides)
    split["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    entry.warm_up()
    _sync(device)
    split["warm_up_s"] = time.perf_counter() - t
    _log(f"set up {split}", t_start)

    before = _kernel_counters()
    gc_before = sum(g["collections"] for g in gc.get_stats())
    observability.reset()
    window_start = time.perf_counter()
    setup_s = window_start - t_start

    def run_window():
        return window.run(entry, lambda r: r["pairs"], seconds)

    if trace:
        seconds = min(seconds, traffic["trace_seconds"])
        calls, device_ops, host_ops = profiled.traced(run_window)
    else:
        calls = run_window()
    _log(f"window of {len(calls)} calls closed", t_start)
    gc_collections = sum(g["collections"] for g in gc.get_stats()) - gc_before
    after = _kernel_counters()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = {k: after[k] - before[k] for k in after}
    counters.update(observability.counts())
    pairs = sum(c.pairs for c in calls)
    wall = window.wall(calls)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}

    out = {}
    if trace:
        t = time.perf_counter()
        reduced = profiled.reduce(device_ops, host_ops, files.families(here))
        del device_ops, host_ops
        iterations = [c.result["iterations"] for c in calls]
        spans = {name: st["total"] for name, st in observability.span_statistics().items()}
        readings = {
            "pairs": pairs, "calls": len(calls), "window_s": wall, "busy_s": reduced["busy_s"],
            "family_s": reduced["family_s"], "counters": counters,
            "span_s": spans, "series": observability.values(),
            "iterations": None if None in iterations else sum(iterations),
        }
        metrics = {}
        for m in files.per_layer(bench, cell):
            value = files.metric_reader(m["name"], here)(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=reduced["busy_s"], window_s=wall)
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        _log("trace read", t_start)
    else:
        # an end-to-end metric is named by what it measures, then by its cells
        measured = {"pairs_per_s": window.pairs_per_s(calls), "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in files.end_to_end(bench, cell)}

    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {found}")

    # each call's wall and the process's CPU seconds in it, to tell a slow
    # host from more work when runs of one seed differ
    call_s = [c.end - c.start for c in calls]
    call_cpu_s = [c.cpu_s for c in calls]
    # the reference runs after the program's state is freed
    results = [c.result for c in calls]
    del calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = entry.numbers(results, device)
    numbers["plain_calls"] = sum(v for k, v in counters.items() if k.endswith("PLAIN_CALLS"))
    check = compare.judge(numbers, limits)
    check_s = time.perf_counter() - t
    _log("compared with the reference", t_start)
    correct = all(v["ok"] for v in check.values())
    line = {"correct": correct, "attempted": pairs, "failed": entry.failed(numbers),
            "metrics": metrics, "device": device_info, **out,
            "window": {"calls": len(results), "wall_s": wall, "call_s": call_s,
                       "call_cpu_s": call_cpu_s, "gc_collections": gc_collections,
                       "setup_split": split, "check_s": check_s, "counters": counters},
            "check": {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in check.items()}}
    return line


def _finite(value):
    """JSON has no infinity: a non-finite number compared is written null."""
    return value if math.isfinite(value) else None


def emit(line: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line of standard output."""
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
