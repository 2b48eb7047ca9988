"""Share of the traced window's wall in which no operation ran on the
device: 1 - the union of the device operations' intervals over the wall."""


def read(r):
    return 1.0 - r["busy_s"] / r["window_s"] if r["busy_s"] > 0 else None
