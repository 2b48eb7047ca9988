"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the limits of its comparison
``limits/<cell>.json``; the mix's ``entry`` is the class ``Entry`` of
``entries/<entry>.py``, which drives the program; each per-layer metric
is read by the ``read`` of ``metrics/<stem>.py``, the longest leading
part of its name, cut at dots, that has such a file
(``krylov.host_syncs_per_pair.sequential`` is read by
``krylov.host_syncs_per_pair.py``); ``kernel_families.json`` maps kernel
names to the families of the program's kernels.  A cell, a configuration,
a mix, an entry or a metric is added by adding its files and its entry in
``BENCHMARK.json``, with no other file edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "configs", f"{name}.json"))


def traffic(name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "traffic", f"{name}.json"))


def limits(cell: str, here: str = HERE) -> Dict[str, float]:
    return _json(os.path.join(here, "limits", f"{cell}.json"))


def families(here: str = HERE) -> Dict[str, List[str]]:
    """Family -> the kernel names (as compiled: a substring of the mangled
    or demangled name) that belong to it."""
    return _json(os.path.join(here, "kernel_families.json"))


def family_of(kernel: str, fams: Dict[str, List[str]]) -> Optional[str]:
    for family, names in fams.items():
        if any(n in kernel for n in names):
            return family
    return None


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str, here: str = HERE):
    """The class ``Entry`` of ``entries/<name>.py``: built from (config,
    traffic, seed, device, solver_overrides), it makes the inputs, warms
    up, runs call k of the window when called with k, and works out the
    compared numbers (``numbers``) and the failed count (``failed``)."""
    return _load(os.path.join(here, "entries", f"{name}.py"), f"portbench_entry_{name}").Entry


def metric_reader(name: str, here: str = HERE) -> Callable:
    """``read`` of ``metrics/<stem>.py``, the longest leading part of
    ``name`` cut at dots that has a file: it takes the traced window's
    readings and returns the metric, or None where it finds nothing."""
    parts = name.split(".")
    for end in range(len(parts), 0, -1):
        stem = ".".join(parts[:end])
        path = os.path.join(here, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _load(path, f"portbench_metric_{stem}").read
    raise FileNotFoundError(f"no reader in metrics/ for {name!r}")


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", (cell,))]
