"""Host milliseconds a pair spent waiting for the card in a synchronising
call: reads of device values and copies from pageable host memory
(the program's span ``solve/host_wait``)."""


def read(r):
    seconds = r["span_s"].get("solve/host_wait")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
