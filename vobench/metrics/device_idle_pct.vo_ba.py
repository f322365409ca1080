"""Share of the traced window in which no kernel, copy or set ran on the
card (``torch.profiler``'s device intervals, their union against the
window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:  # no device operation seen
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
