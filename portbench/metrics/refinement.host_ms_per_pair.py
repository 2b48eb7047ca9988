"""Host milliseconds a pair in the df32 refinement phase of the frame-pair
solve: its correction solves, re-slices and reads of the active set
(the program's span ``pair/refinement``)."""


def read(r):
    seconds = r["span_s"].get("pair/refinement")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
