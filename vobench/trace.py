"""Reading a ``torch.profiler`` trace of the traced passes.

Device intervals are the CUDA events (kernels, copies, sets); host spans
are the ``span:<name>`` ranges the benchmark's wrappers record, and the
traced window runs from the first ``pass`` range's start to the last one's
end. ``busy_s`` is the union of the device intervals inside the window, an
idle gap is a stretch of the window with none, and a gap is laid to the
span the host was in at its midpoint (``host`` outside every span; the
spans of one run do not nest).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    spans: dict  # span name -> total seconds
    idle_by_span: dict  # span name -> idle seconds while the host was in it
    device_ops: list  # [(kernel name, seconds)] by total time, all of them
    kernel_times: dict  # kernel name -> list of durations (s)


def read(prof) -> Trace:
    dev, ranges, passes = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        on_device = e.device_type().name == "CUDA"
        # the profiler mirrors the host's ranges on the device: those are not work
        if name == "pass":
            if not on_device:
                passes.append((a, b))
        elif name.startswith("span:"):
            if not on_device:
                ranges.append((a, b, name[5:]))
        elif on_device:
            dev.append((a, b, name))
    if not passes:
        raise RuntimeError("the trace holds no pass")
    w0, w1 = min(p[0] for p in passes), max(p[1] for p in passes)
    inside = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1)
    busy, gaps, cur_end = 0, [], w0
    for a, b, _ in inside:
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if cur_end < w1:
        gaps.append((cur_end, w1))

    spans = defaultdict(float)
    for a, b, n in ranges:
        spans[n] += (b - a) * 1e-9
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        owner = ranges[i][2] if i >= 0 and ranges[i][1] >= mid else "host"
        idle[owner] += (b - a) * 1e-9

    per_kernel = defaultdict(list)
    for a, b, n in dev:
        if a >= w0 and b <= w1:
            per_kernel[n].append((b - a) * 1e-9)
    ops = sorted(((n, sum(v)) for n, v in per_kernel.items()), key=lambda x: -x[1])
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, spans=dict(spans),
                 idle_by_span=dict(idle), device_ops=ops,
                 kernel_times=dict(per_kernel))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by the span the host was in."""
    gaps = sorted(tr.idle_by_span.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:64], s] for n, s in tr.device_ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps]}
