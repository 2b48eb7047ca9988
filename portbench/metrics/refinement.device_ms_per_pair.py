"""Device milliseconds a pair in kernel B4, the df32 residual and correction operator
(profiler time of the family's kernels, ``kernel_families.json``)."""


def read(r):
    seconds = r["family_s"].get("refinement")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
