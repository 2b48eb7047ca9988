"""Device milliseconds a pair in kernels B1 to B3, the fine-level matvec
(profiler time of the family's kernels, ``kernel_families.json``)."""


def read(r):
    seconds = r["family_s"].get("matvec")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
