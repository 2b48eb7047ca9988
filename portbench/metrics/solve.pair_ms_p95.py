"""95th percentile of the pairs' host wall in the sequential loop, ms: each
pair from the previous pair's end (the call's first from the loop's start)
to its own (the program's series ``variational/pair_s``), the pace a user
of the command line watches."""

import statistics


def read(r):
    seconds = r["series"].get("variational/pair_s", [])
    if len(seconds) < 2:  # no quantiles of fewer
        return None
    return statistics.quantiles(seconds, n=20)[-1] * 1e3
