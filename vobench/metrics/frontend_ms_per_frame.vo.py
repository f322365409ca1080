"""Milliseconds per stereo step in the front end: the fenced span around
``models/frontend.quad_match_frames`` as the staged scan calls it."""


def read(ctx):
    s = None if ctx.trace is None else ctx.trace.spans.get("frontend")
    return None if s is None else 1e3 * s / (ctx.passes * ctx.work_per_pass)
