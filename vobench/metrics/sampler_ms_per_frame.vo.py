"""Host milliseconds per stereo step in the RANSAC sampler: the program's
``vo.sample`` span around the staged scan's per-step sampler stack
(``models/pipeline._step``)."""

from vobench.program import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "vo.sample")
