"""Device milliseconds a pair in kernels B5 and B6, the V-cycle's sweeps and grid transfers
(profiler time of the family's kernels, ``kernel_families.json``)."""


def read(r):
    seconds = r["family_s"].get("multigrid")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
