"""Host milliseconds a pair in the multigrid set-up phase of the frame-pair
solve: the comb probes of every level and the coarsest LU
(the program's span ``pair/mg_setup``)."""


def read(r):
    seconds = r["span_s"].get("pair/mg_setup")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
