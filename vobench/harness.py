"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one piece is found by name:

- the cell: its entry in ``BENCHMARK.json``'s ``workloads``;
- its configuration: the ``file`` of its ``configs`` entry;
- its traffic mix: ``vobench/traffic/<traffic>.json``, whose ``engine``
  names the general driver in ``vobench/engines/<engine>.py``;
- its limits: ``vobench/limits/<workload>.json``;
- a per-layer metric: ``vobench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the value or None.

A run builds the world and the program from ``--seed``, warms every shape
with one pass (set-up), then runs passes back to back until ``--seconds``
have passed; the rate is the work of every completed pass over the time
from the window's start to the last pass's end. With ``--trace 1`` it
instead counts one pass's stream syncs, then traces ``trace_passes`` passes
with the benchmark's spans and reports the per-layer metrics. Either way it
then judges one pass drawn from the seed (``spans.Capture``, the only pass
whose outputs it keeps whole) against the plain reference.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uasl_motion_estimation_tpu")


class Ctx(NamedTuple):
    """What a per-layer metric reads."""

    trace: object  # trace.Trace of the traced passes
    syncs: int  # stream syncs of one pass
    work_per_pass: int  # steps (VO) or windows (BA)
    windows_per_pass: int | None  # BA windows of a pass
    passes: int  # traced passes
    k1_bytes: list  # bytes each K1 launch of the traced passes must move
    lm_iters: list  # per traced solve, the largest LM iteration count


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic mix, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(root / conf["file"]), load_json(PKG / "traffic" / f"{cell['traffic']}.json"),
            load_json(PKG / "limits" / f"{workload}.json"))


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name}",
                                                  PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def rate(n_passes: int, work_per_pass: int, span_s: float) -> float:
    """Work of every completed pass over the whole span it took."""
    return n_passes * work_per_pass / span_s


def run_window(run_pass, seconds: float, capture=None) -> tuple[int, float]:
    """Passes back to back until ``seconds`` have passed: (passes, span)."""
    n, t_start = 0, time.perf_counter()
    while True:
        if capture is not None:
            capture.start_pass()
        run_pass()
        n += 1
        span = time.perf_counter() - t_start
        if span >= seconds:
            return n, span


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (at most the limit; NaN fails)."""
    checks = {k: {"value": float(numbers[k]), "limit": float(lim)} for k, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", small: dict | None = None) -> dict:
    """One run; returns the result object. ``device="cpu"`` and ``small``
    serve the tests: the CPU stands in for the card, and ``small`` overrides
    sizes of the configuration and traffic."""
    import torch

    bench = load_json(root / "BENCHMARK.json")
    cell, config, traffic, limits = find_cell(bench, root, workload)
    if device != "cpu":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"vobench: {workload} needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(3)
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = [("imports and the device", time.perf_counter())]
    eng_mod = importlib.import_module(f"vobench.engines.{traffic['engine']}")
    eng = eng_mod.Engine(config, traffic, seed, device, small or {})
    sync()
    marks.append(("the program and its inputs", time.perf_counter()))
    eng.capture.on = False
    eng.run_pass()  # warms every shape the window uses
    sync()
    marks.append(("the warm pass", time.perf_counter()))
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (name, b), (_, a)
                                in zip(marks, [("", t0)] + marks)), file=sys.stderr)
    ctx_syncs = None
    if traced and cuda:
        from . import spans

        ctx_syncs = spans.count_syncs(eng.run_pass)
    setup_s = time.perf_counter() - t0
    eng.capture.on = True

    k1, prof = [], None
    if traced:
        from . import spans

        undo = [spans.patch(m, a, spans.fenced_span(n)) for m, a, n in eng.SPANS]
        if eng.K1 is not None:
            undo.append(spans.patch(*eng.K1, lambda fn: _k1_recorder(fn, k1)))
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        n_passes = int(traffic["trace_passes"])
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(n_passes):
                eng.capture.start_pass()
                with torch.profiler.record_function("pass"):
                    eng.run_pass()
                    sync()
        for u in undo:
            u()
    else:
        n_passes, span_s = run_window(eng.run_pass, seconds, eng.capture)
    sync()
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    attempted = n_passes * eng.work_per_pass
    failed = eng.failed()
    eng.release()

    numbers = eng.judge(eng.capture.judged)
    correct, checks = judge(numbers, limits)
    for line in eng.sanity(eng.capture.judged):
        print(line, file=sys.stderr)

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if traced:
        from . import trace as tr

        trc = tr.read(prof)
        ctx = Ctx(trace=trc, syncs=ctx_syncs,
                  work_per_pass=eng.work_per_pass,
                  windows_per_pass=getattr(eng, "windows_per_pass", None), passes=n_passes,
                  k1_bytes=[_k1_bytes(x) for x in k1], lm_iters=eng.lm_iters())
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        name = traffic["rate_metric"]
        metrics = {name: {"value": rate(n_passes, eng.work_per_pass, span_s),
                          "unit": e2e[name]["unit"]},
                   "setup_s": {"value": setup_s, "unit": e2e["setup_s"]["unit"]}}

    found = forbidden_modules()
    if found:
        print(f"vobench: the run loaded {found}, which the port must not use", file=sys.stderr)
        raise SystemExit(4)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": mem_peak}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if traced and cuda:
        from . import trace as tr

        dev["busy_s"] = trc.busy_s
        dev["window_s"] = trc.window_s
        result["breakdown"] = tr.breakdown(trc)
    for name, c in checks.items():
        verdict = "ok" if np.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    result["checks"] = checks
    return result


def _k1_recorder(fn, out: list):
    def wrapper(img, anchors, tile_h, tile_w=None):
        tile_w = tile_h if tile_w is None else tile_w
        out.append((anchors.clone(), tuple(img.shape[-2:]), tile_h, tile_w))
        return fn(img, anchors, tile_h, tile_w)
    return wrapper


def _k1_bytes(rec) -> int:
    from .roofline import gather_bytes

    anchors, (h, w), th, tw = rec
    return gather_bytes(anchors, h, w, th, tw)


def main(argv: list[str] | None = None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        print("vobench: run from the checkout's root (no BENCHMARK.json here)", file=sys.stderr)
        return 2
    cache = root / ".vobench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    torch.set_num_threads(4)
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
