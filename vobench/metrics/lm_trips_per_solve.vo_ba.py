"""Trips of the per-motion stereo solve's LM per ``lm_solve`` call in
the integrated engine: the program's ``lm.trips`` and ``lm.inner_trips``
over ``lm.calls``."""

from vobench.program import per_call


def read(ctx):
    return per_call(("lm.trips", "lm.inner_trips"), "lm.calls")
