"""Launches of the program's hand-written kernels a pair (the sum of
``ops.cuda_kernels``' launch counters, exact under graph replay)."""


def read(r):
    launches = [v for k, v in r["counters"].items() if k.endswith("LAUNCHES")]
    return sum(launches) / r["pairs"] if launches else None
