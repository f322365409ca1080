"""Host milliseconds per stereo step in the integrated engine's float64
composition: the program's ``unified.compose`` span
(``models/smoother._compose_from_chunks``)."""

from vobench.program import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "unified.compose")
