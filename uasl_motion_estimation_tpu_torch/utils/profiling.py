"""Tracing and timing hooks around the port's engines.

Port of ``uasl_motion_estimation_tpu/utils/profiling.py`` with the same
names: ``torch.profiler`` traces with named scopes, and a wall-clock stage
timer. PyTorch returns before the card finishes, so every timing here ends
on the device: ``force`` copies to the host, and ``StageTimer``
synchronises the card at both ends of a stage.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


def force(tree):
    """Every tensor of a nested tuple, list, dict or NamedTuple brought to
    the host as numpy: the fence of every timing (a copy to the host waits
    for the work that makes the tensor). Other leaves pass through."""

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(host(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    return host(tree)


def timeit_forced(fn, *args, reps: int = 5, warmup: int = 2, **kwargs):
    """Median wall-clock seconds of ``force(fn(*args))`` over ``reps`` runs,
    after ``warmup`` untimed ones (kernel builds, allocator warm-up).
    Returns (median_seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = force(fn(*args, **kwargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = force(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


@contextlib.contextmanager
def trace(path: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card, written as a Chrome trace to ``path`` (open it in
    chrome://tracing or Perfetto):

        with profiling.trace("/tmp/vo_trace.json"):
            pipe.run_staged(ls, rs)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named scope visible in profiler timelines."""
    return torch.profiler.record_function(name)


def _fence() -> None:
    # only where this process already holds a CUDA context: work on the card
    # creates one, and timing CPU work must not open one.
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock per-stage accumulator that synchronises the current card,
    where this process has used one, at the boundaries of each stage.

    Usage:
        t = StageTimer()
        with t("frontend"): out = frontend(...)
        with t("solve"):    res = solve(...)
        print(t.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        _fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _fence()
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = []
        for stage, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[stage]
            lines.append(
                f"{stage:24s} {total:8.3f} s total  {total / n * 1e3:8.2f} ms/call"
                f"  x{n}"
            )
        return "\n".join(lines)
