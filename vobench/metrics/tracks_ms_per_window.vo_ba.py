"""Milliseconds per BA window in the integrated engine's track tables: the
fenced span around ``models/smoother._build_window_tracks``."""


def read(ctx):
    s = None if ctx.trace is None else ctx.trace.spans.get("tracks")
    if s is None or not ctx.windows_per_pass:
        return None
    return 1e3 * s / (ctx.passes * ctx.windows_per_pass)
