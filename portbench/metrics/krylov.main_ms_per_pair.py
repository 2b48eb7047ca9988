"""Host milliseconds a pair in the main Krylov solve of the frame-pair solve,
its graph captures and reads of the card included
(the program's span ``pair/krylov_main``)."""


def read(r):
    seconds = r["span_s"].get("pair/krylov_main")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
