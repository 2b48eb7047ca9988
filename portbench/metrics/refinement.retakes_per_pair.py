"""Re-slices of the operators and the multigrid hierarchy to a smaller
active set of the refinement a pair, each followed by a fresh capture (the
program's counter ``refinement/retakes``)."""


def read(r):
    counters = r["counters"]
    retakes = counters.get("refinement/retakes")
    if retakes is None and "refinement/steps" in counters:
        retakes = 0  # a program that counts the loop's steps counts its re-slices too
    return None if retakes is None else retakes / r["pairs"]
