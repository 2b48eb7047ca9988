"""Krylov iterations a sweep cell, main solve and refinement's correction
solves, over the traced window's sweeps: the sum of the chunks' cell
iteration sums (the program's series ``sweep/chunk_cell_iterations``) over
their cells (``sweep/chunk_cells``)."""


def read(r):
    series = r["series"]
    used = series.get("sweep/chunk_cell_iterations")
    cells = series.get("sweep/chunk_cells")
    return sum(used) / sum(cells) if used and cells else None
