"""KLT trips per ``klt_track`` call in the staged scan: the program's
``klt.trips`` (iterations over every level, each set by the slowest
feature of the batch) over ``klt.calls``."""

from vobench.program import per_call


def read(ctx):
    return per_call(("klt.trips",), "klt.calls")
