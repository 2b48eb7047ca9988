"""The share of a sweep chunk's slot-iterations spent on cells that had
already stopped: 1 - sum of the chunks' cell iteration sums (the program's
series ``sweep/chunk_cell_iterations``) over the sum of each chunk's
largest count times its cells (``sweep/chunk_max_iterations``,
``sweep/chunk_cells``); a chunk runs until its slowest cell stops."""


def read(r):
    series = r["series"]
    used = series.get("sweep/chunk_cell_iterations")
    cells = series.get("sweep/chunk_cells")
    if not used or not cells:
        return None
    run = sum(m * c for m, c in zip(series["sweep/chunk_max_iterations"], cells))
    return 1.0 - sum(used) / run if run else None
