"""Host milliseconds per stereo step in the host pose chain: the
program's ``vo.chain`` span (``models/pipeline.OdometryPipeline._chain``)."""

from vobench.program import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "vo.chain")
