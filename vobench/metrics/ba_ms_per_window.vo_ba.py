"""Milliseconds per BA window in windowed BA: the fenced span around
``models/smoother._group_ba`` (the window start and ``ba_solve``)."""


def read(ctx):
    s = None if ctx.trace is None else ctx.trace.spans.get("ba")
    if s is None or not ctx.windows_per_pass:
        return None
    return 1e3 * s / (ctx.passes * ctx.windows_per_pass)
