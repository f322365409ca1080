"""Stream syncs (host reads of device values) of one staged-VO pass, per
stereo step: torch's sync debug mode over a pass without spans."""


def read(ctx):
    return None if ctx.syncs is None else ctx.syncs / ctx.work_per_pass
