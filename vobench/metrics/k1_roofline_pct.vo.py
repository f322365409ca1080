"""K1's share of its roofline over the traced passes: the time the card's
HBM needs for the bytes each launch must move (``vobench/roofline.py``, at
3.35 TB/s) over K1's device time in the profiler's trace, per launch on
average (so a launch the profiler drops does not bias it)."""

from vobench.roofline import H100_HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None or not ctx.k1_bytes:
        return None
    times = [t for name, ts in ctx.trace.kernel_times.items() if "gather_tiles" in name for t in ts]
    if not times:
        return None
    bound = sum(ctx.k1_bytes) / len(ctx.k1_bytes) / H100_HBM_BYTES_PER_S
    return 100.0 * bound / (sum(times) / len(times))
