"""Tracing and timing hooks around the port's engines.

- ``span(name)`` and ``count(name, n)``: the program's own spans and
  counters. They are recorded in memory (``recorder()``) exactly while a
  ``torch.profiler`` is recording, and cost one flag read otherwise. A span
  is stamped with ``time.time_ns()``, the clock of the profiler's events,
  so spans and device intervals share one timeline. Spans are not profiler
  ranges: the profiler mirrors ``record_function`` ranges onto the card,
  where a trace reader would take them for device work.
- ``trace(path)``: a ``torch.profiler`` trace written as a Chrome trace,
  with the spans on a track of their own.
- ``breakdown(prof)``: a finished profile and the recorder read together:
  per span name its calls, host time, self time, the card's idle time and
  the launches while the host was in it.
- ``StageTimer``: a wall-clock stage timer fenced on the card.

    with profiling.trace("/tmp/vo_trace.json") as prof:
        pipe.run_staged(ls, rs)
    print(profiling.breakdown(prof))
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

# True while a torch.profiler (or autograd profiler) is recording
_profiling = torch._C._autograd._profiler_enabled

# host-side runtime calls that put work on the card
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span of the same thread in Recorder.spans, -1 at the top


class Recorder:
    """Spans and counters recorded while a profiler was recording.

    ``spans`` holds one slot per span in the order the spans opened; a slot
    is None while its span is open. ``counters`` maps a name to its total."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self.spans: list[SpanRecord | None] = []
            self.counters: dict[str, int] = defaultdict(int)

    def closed(self) -> list[SpanRecord]:
        return [s for s in self.spans if s is not None]

    def host_s(self) -> dict[str, float]:
        """Seconds by span name, summed over its calls."""
        out: dict[str, float] = defaultdict(float)
        for s in self.closed():
            out[s.name] += (s.end_ns - s.start_ns) * 1e-9
        return dict(out)

    def self_s(self) -> dict[str, float]:
        """Seconds by span name less the time its child spans cover."""
        return _self_s(self.spans)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    __slots__ = ("name", "spans", "slot", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORDER
        with rec._lock:
            self.spans = rec.spans  # a span open across clear() closes into the old list
            self.slot = len(self.spans)
            self.spans.append(None)
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.slot if top is not None and top.spans is self.spans else -1
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _RECORDER._stack().pop()
        self.spans[self.slot] = SpanRecord(self.name, self.start, end, self.parent)
        return False


_RECORDER = Recorder()
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """Context manager that records a span named ``name`` while a profiler
    is recording, and does nothing otherwise."""
    return _Span(name) if _profiling() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler is recording."""
    if _profiling():
        with _RECORDER._lock:
            _RECORDER.counters[name] += int(n)


def recorder() -> Recorder:
    return _RECORDER


def _self_s(spans: list) -> dict[str, float]:
    kids = defaultdict(list)
    for s in spans:
        if s is not None and s.parent >= 0:
            kids[s.parent].append((s.start_ns, s.end_ns))
    out: dict[str, float] = defaultdict(float)
    for i, s in enumerate(spans):
        if s is not None:
            covered = _union_ns(kids.get(i, []), s.start_ns, s.end_ns)
            out[s.name] += (s.end_ns - s.start_ns - covered) * 1e-9
    return dict(out)


def _union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total


def _owners(spans: list[SpanRecord]) -> tuple[list[int], list[int]]:
    """(times, owners): from times[k] on, the innermost open span is
    spans[owners[k]] (-1: none). Innermost is the latest to open; a span
    that covers no time owns nothing."""
    timed = [i for i, s in enumerate(spans) if s.end_ns > s.start_ns]
    bounds = sorted([(spans[i].end_ns, 0, i) for i in timed]
                    + [(spans[i].start_ns, 1, i) for i in timed])
    open_: list[int] = []
    times: list[int] = []
    owners: list[int] = []
    for t, opens, i in bounds:
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        owner = max(open_, key=lambda j: (spans[j].start_ns, j)) if open_ else -1
        if times and times[-1] == t:
            owners[-1] = owner
        else:
            times.append(t)
            owners.append(owner)
    return times, owners


def attribute(device: list[tuple[int, int]], launches: list[int], spans: list[SpanRecord | None],
              window: tuple[int, int]) -> dict:
    """Lay the card's idle gaps and the host's launches on the program's
    spans (times in ns on one clock).

    ``device``: (start, end) intervals of work on the card; ``launches``:
    host times of launch calls; ``spans``: the recorder's slots (None while
    a span is open); ``window``:
    (start, end) of the stretch read. An idle gap is a stretch of the window
    with no device interval; it and each launch in the window go to the
    innermost span open at the gap's midpoint or at the launch, else to
    ``outside``. Returns the window's and the busy seconds, per span name
    ``calls``, ``host_s``, ``self_s``, ``idle_s`` and ``launches``, the
    and the ``outside`` bucket (``host_s``: the window's time outside every
    span)."""
    own = _self_s(spans)
    spans = [s for s in spans if s is not None]
    w0, w1 = window
    busy, gaps, cur = 0, [], w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))

    names = sorted({s.name for s in spans})
    per = {n: {"calls": 0, "host_s": 0.0, "self_s": 0.0, "idle_s": 0.0, "launches": 0}
           for n in names}
    for s in spans:
        per[s.name]["calls"] += 1
        per[s.name]["host_s"] += (s.end_ns - s.start_ns) * 1e-9
    for n, v in own.items():
        per[n]["self_s"] = v
    in_spans = _union_ns([(s.start_ns, s.end_ns) for s in spans], w0, w1)
    outside = {"host_s": (w1 - w0 - in_spans) * 1e-9, "idle_s": 0.0, "launches": 0}

    times, owners = _owners(spans)

    def bucket(t: float) -> dict:
        k = bisect.bisect_right(times, t) - 1
        i = owners[k] if k >= 0 else -1
        return per[spans[i].name] if i >= 0 else outside

    for a, b in gaps:
        bucket(0.5 * (a + b))["idle_s"] += (b - a) * 1e-9
    for t in launches:
        if w0 <= t <= w1:
            bucket(t)["launches"] += 1
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "spans": per,
            "outside": outside}


def profile_intervals(prof) -> tuple[list[tuple[int, int]], list[int]]:
    """(device intervals, launch times) of a finished ``torch.profiler``
    profile. Device intervals are the card's events without the ranges the
    profiler mirrors there from the host's ``record_function`` ranges: a
    mirror bears the name of a host event, a kernel, copy or set never
    does."""
    host_names, dev, launches = set(), [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CUDA":
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        else:
            host_names.add(name)
            if name in LAUNCHES:
                launches.append(e.start_ns())
    return [(a, b) for a, b, n in dev if n not in host_names], launches


def breakdown(prof, window: tuple[int, int] | None = None) -> dict:
    """``attribute`` over a finished profile and the recorder's spans, with
    the recorder's ``counters``. ``window`` (ns, ``time.time_ns()``'s clock)
    defaults to the stretch from the first to the last device interval,
    launch or span."""
    device, launches = profile_intervals(prof)
    spans = _RECORDER.spans
    if window is None:
        edges = ([t for ab in device for t in ab] + launches
                 + [t for s in _RECORDER.closed() for t in (s.start_ns, s.end_ns)])
        window = (min(edges), max(edges)) if edges else (0, 0)
    return {**attribute(device, launches, spans, window), "counters": dict(_RECORDER.counters)}


def _write_spans(path: str, spans: list[SpanRecord]) -> None:
    """Add the spans to the Chrome trace at ``path`` as complete events of
    a process of their own ("program spans")."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(path: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card, written as a Chrome trace to ``path`` (open it in
    chrome://tracing or Perfetto) with the program's spans beside the
    kernels. Clears the recorder when it starts."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _RECORDER.clear()
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    prof.export_chrome_trace(path)
    _write_spans(path, _RECORDER.closed())


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
