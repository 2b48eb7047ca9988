"""Chunks of the batched pass a call, over the traced window (the program's
counter ``variational/batch_chunks``, one a ``solve_frame_pair`` call of
the batched pass); None where the program has no such counter."""


def read(r):
    chunks = r["counters"].get("variational/batch_chunks")
    return None if chunks is None else chunks / r["calls"]
