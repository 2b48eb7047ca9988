"""Reads of the card by the Krylov loops and the refinement loop a pair
(the program's counter ``krylov/host_syncs``)."""


def read(r):
    syncs = r["counters"].get("krylov/host_syncs")
    return None if syncs is None else syncs / r["pairs"]
