"""Milliseconds per stereo step in the stereo pose solve: the fenced span
around ``models/pipeline.stereo_vo_solve`` as the staged scan calls it."""


def read(ctx):
    s = None if ctx.trace is None else ctx.trace.spans.get("solve")
    return None if s is None else 1e3 * s / (ctx.passes * ctx.work_per_pass)
