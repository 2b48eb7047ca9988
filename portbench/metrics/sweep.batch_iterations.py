"""Iterations a sweep runs to: over the traced window's sweeps, the mean of
the sum of each chunk's largest iteration count (the program's series
``sweep/chunk_max_iterations``); a chunk runs until its slowest cell stops."""


def read(r):
    chunks = r["series"].get("sweep/chunk_max_iterations")
    return sum(chunks) / r["calls"] if chunks else None
