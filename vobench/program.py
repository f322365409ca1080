"""What the program records about itself: the spans and counters of
``uasl_motion_estimation_tpu_torch/utils/profiling.py``. The program
records them exactly while a ``torch.profiler`` records, so in a
``--trace 1`` run they cover the traced passes and nothing else. A program
without that recorder, or a span or counter it never recorded, reads None.
"""

from __future__ import annotations


def recorder():
    try:
        from uasl_motion_estimation_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorder", None)
    return None if read is None else read()


def ms_per_step(ctx, name: str):
    """Host milliseconds in the span ``name`` per step of the traced passes."""
    rec = recorder()
    s = None if rec is None else rec.host_s().get(name)
    return None if s is None else 1e3 * s / (ctx.passes * ctx.work_per_pass)


def per_call(trips: tuple[str, ...], calls: str):
    """The counters ``trips`` summed, over the counter ``calls``."""
    rec = recorder()
    n = None if rec is None else rec.counters.get(calls)
    if not n or trips[0] not in rec.counters:
        return None
    return sum(rec.counters.get(t, 0) for t in trips) / n
