"""Trips of the stereo solve's LM per ``lm_solve`` call: the program's
``lm.trips`` (outer iterations, set by the slowest step of the batch) and
``lm.inner_trips`` (damping retries) over ``lm.calls``."""

from vobench.program import per_call


def read(ctx):
    return per_call(("lm.trips", "lm.inner_trips"), "lm.calls")
