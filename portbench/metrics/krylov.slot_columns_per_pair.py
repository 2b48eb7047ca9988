"""FGMRES's Arnoldi columns run a pair, counted once for every pair of the
batch each column step covers (the program's counter ``krylov/slot_columns``):
the work the main solves ran, which a restart's compaction to the pairs still
going cuts; None where the program has no such counter."""


def read(r):
    columns = r["counters"].get("krylov/slot_columns")
    return None if columns is None else columns / r["pairs"]
