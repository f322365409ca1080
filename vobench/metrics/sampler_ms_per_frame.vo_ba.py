"""Host milliseconds per stereo step in the integrated engine's RANSAC
sampler: the program's ``unified.sample`` span
(``models/smoother._group_samples``, one generator per motion)."""

from vobench.program import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "unified.sample")
