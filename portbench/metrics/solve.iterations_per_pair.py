"""Krylov iterations a pair, main solve and refinement's correction solves
(the entry's returned ``iterations``), over the traced window."""


def read(r):
    return None if r["iterations"] is None else r["iterations"] / r["pairs"]
