"""Host milliseconds a pair in the pair data phase of the frame-pair solve:
normalisation, derivative and coefficient planes, the matvec
(the program's span ``pair/pair_data``)."""


def read(r):
    seconds = r["span_s"].get("pair/pair_data")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
