"""Host milliseconds a pair in the entry point's copies to the host: the
solutions, the infos, the movie and the blurred movie
(the program's span ``variational/to_host``)."""


def read(r):
    seconds = r["span_s"].get("variational/to_host")
    return None if seconds is None else seconds * 1e3 / r["pairs"]
