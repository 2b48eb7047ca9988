"""Host milliseconds a pair in the last phase of the frame-pair solve: the
boundary embedded, the functionals, the info dict
(the program's span ``pair/finish``)."""


def read(r):
    seconds = r["span_s"].get("pair/finish")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
