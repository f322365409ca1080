"""Where a benchmark cell's time goes, read from the program's own spans.

    python3 tools/program_trace.py --workload kitti-vo-offline --seed 7 --passes 3 \
        [--syncs] [--cost 4] [--device cpu --small]

Builds the cell's ``vobench`` engine (``BENCHMARK.json``), warms it with
one pass, then runs ``--passes`` passes back to back under
``torch.profiler`` without the benchmark's fenced spans, and prints one
JSON object: ``profiling.breakdown`` over those passes (per program span:
calls, host and self seconds, the card's idle seconds while the host was
in it, launches; ``outside`` every span) and the counters per pass.

- ``--syncs``: two more passes under torch's sync debug mode with the
  recorder on: the first pass's host reads by the line of the port that
  made them, the second's as ``vobench.spans.count_syncs`` counts them, and
  beside each the sum of the program's ``sync.*`` counters.
- ``--cost R``: what tracing costs. Off: the ``span``/``count`` calls of a
  pass and one such call's time with no profiler recording. On: a traced
  pass's wall time with the recorder against the same pass with ``span``
  and ``count`` stubbed out, in R turns (on, stub, stub, on).

Needs a CUDA card unless ``--device cpu`` (with ``--small``: the harness
tests' small sizes), which serves rehearsals: on the CPU there are no
device intervals, so every second of the window reads as idle.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
import timeit
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from uasl_motion_estimation_tpu_torch.utils import profiling  # noqa: E402
from vobench import harness, spans  # noqa: E402

# the sizes vobench/tests/test_vobench_harness.py runs the cells at
SMALL = {"rig": {"fu": 160.0, "fv": 160.0, "cu": 160.0, "cv": 48.0, "height": 96, "width": 320},
         "pipeline": {"max_features": 64, "max_disparity": 32}, "scene": {"hall_half_width": 12.0},
         "traffic": {"frames": 9, "chunk": 4, "wchunk": 2, "windows": 8, "trace_passes": 2}}


def build(workload: str, seed: int, device: str, small: dict):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, _ = harness.find_cell(bench, ROOT, workload)
    eng = importlib.import_module(f"vobench.engines.{traffic['engine']}").Engine(
        config, traffic, seed, device, small)
    eng.capture.on = False
    return eng


def traced(run, activities):
    """Run ``run`` under a profiler with the recorder cleared: (profile,
    window (ns), wall seconds)."""
    profiling.recorder().clear()
    with torch.profiler.profile(activities=activities) as prof:
        t0, w0 = time.perf_counter(), time.time_ns()
        run()
        w1, t1 = time.time_ns(), time.perf_counter()
    return prof, (w0, w1), t1 - t0


def sync_sites(run) -> Counter:
    """Host reads of ``run`` (torch's sync debug mode, as
    ``vobench.spans.count_syncs`` counts them) by the innermost line of the
    port on the stack, or by the warning's own file and line where the port
    is not on it."""
    port = str(ROOT / "uasl_motion_estimation_tpu_torch")
    sites = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(port)]
        f = frames[-1] if frames else None
        sites[f"{f.filename.replace(f'{ROOT}/', '')}:{f.lineno}" if f else
              f"{filename}:{lineno} ({message})"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def gate_calls(run) -> dict:
    """``span`` and ``count`` calls of ``run`` with no profiler recording."""
    n = Counter()
    span, count = profiling.span, profiling.count

    def counted_span(name):
        n["span"] += 1
        return span(name)

    def counted_count(name, k=1):
        n["count"] += 1
        return count(name, k)

    profiling.span, profiling.count = counted_span, counted_count
    try:
        run()
    finally:
        profiling.span, profiling.count = span, count
    return dict(n)


def stubbed(run):
    def go():
        span, count = profiling.span, profiling.count
        profiling.span = lambda name: profiling._NO_SPAN
        profiling.count = lambda name, k=1: None
        try:
            run()
        finally:
            profiling.span, profiling.count = span, count
    return go


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--cost", type=int, default=0, metavar="R")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("program_trace: no CUDA card (use --device cpu for a rehearsal)", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    eng = build(args.workload, args.seed, args.device, SMALL if args.small else {})

    def one_pass():
        eng.run_pass()
        sync()

    def passes():
        for _ in range(args.passes):
            one_pass()

    t = time.perf_counter()
    one_pass()  # warms every shape
    out = {"workload": args.workload, "seed": args.seed, "passes": args.passes,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "warm_pass_s": time.perf_counter() - t}
    prof, window, wall = traced(passes, activities)
    b = profiling.breakdown(prof, window)
    b["counters_per_pass"] = {k: v / args.passes for k, v in sorted(b.pop("counters").items())}
    out.update(wall_s=wall, work_per_pass=eng.work_per_pass, breakdown=b)

    if args.syncs and cuda:
        # the process's first pass in sync debug mode (the benchmark counts
        # that one), by site, then a second one as the benchmark counts it;
        # each beside the program's sync counters of the same pass
        out["syncs"] = []
        for count in (sync_sites, spans.count_syncs):
            profiling.recorder().clear()
            sync()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                n = count(eng.run_pass)
            sync()
            counters = {k: v for k, v in profiling.recorder().counters.items()
                        if k.startswith("sync.")}
            out["syncs"].append({
                "count_syncs": sum(n.values()) if isinstance(n, Counter) else n,
                "sync_counters": sum(counters.values()),
                "by_counter": dict(sorted(counters.items())),
                **({"by_site": dict(n.most_common())} if isinstance(n, Counter) else {})})

    if args.cost:
        calls = gate_calls(one_pass)
        reps = 200_000

        def off_span_call():
            with profiling.span("x"):
                pass

        off_span = timeit.timeit(off_span_call, number=reps) / reps
        off_count = timeit.timeit(lambda: profiling.count("x", 3), number=reps) / reps
        on, stub = [], []
        for _ in range(args.cost):
            on.append(traced(one_pass, activities)[2])
            stub.append(traced(stubbed(one_pass), activities)[2])
            stub.append(traced(stubbed(one_pass), activities)[2])
            on.append(traced(one_pass, activities)[2])
        out["cost"] = {"gate_calls_per_pass": calls, "span_off_s": off_span,
                       "count_off_s": off_count,
                       "off_s_per_pass": calls.get("span", 0) * off_span
                       + calls.get("count", 0) * off_count,
                       "traced_pass_s": on, "stubbed_pass_s": stub,
                       "traced_median_s": statistics.median(on),
                       "stubbed_median_s": statistics.median(stub)}
    eng.release()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
