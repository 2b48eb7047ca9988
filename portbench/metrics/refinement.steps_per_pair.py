"""Passes of the df32 refinement loop a pair, each a read of its active set
(the program's counter ``refinement/steps``)."""


def read(r):
    steps = r["counters"].get("refinement/steps")
    return None if steps is None else steps / r["pairs"]
