"""Share of the traced window's sweep cells that end unconverged: the
program's counter ``sweep/unconverged_cells`` over the cells of its chunks
(series ``sweep/chunk_cells``).  The slowest cell of a chunk is most often
one of them, so they set how long its converged cells wait."""


def read(r):
    unconverged = r["counters"].get("sweep/unconverged_cells")
    cells = r["series"].get("sweep/chunk_cells")
    return unconverged / sum(cells) if unconverged is not None and cells else None
