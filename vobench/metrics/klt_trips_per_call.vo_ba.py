"""KLT trips per ``klt_track`` call in the integrated engine's track
tables (one call per window frame of a group): the program's
``klt.trips`` over ``klt.calls``."""

from vobench.program import per_call


def read(ctx):
    return per_call(("klt.trips",), "klt.calls")
