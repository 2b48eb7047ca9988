"""Host milliseconds a pair spent capturing the Krylov steps' CUDA graphs
(the program's span ``krylov/capture``)."""


def read(r):
    seconds = r["span_s"].get("krylov/capture")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
