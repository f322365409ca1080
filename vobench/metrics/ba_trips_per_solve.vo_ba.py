"""Trips of windowed BA's loop per ``ba_solve`` call in the integrated
engine (the batch runs until its slowest window is done): the program's
``ba.trips`` over ``ba.calls``."""

from vobench.program import per_call


def read(ctx):
    return per_call(("ba.trips",), "ba.calls")
