"""The batch sweep: for each value of one traffic parameter (``chunk``,
``wchunk``), the rate over a short window, the device's idle share over two
untraced-by-span passes under the profiler, and the peak device memory.

    python3 -m vobench.sweep --workload <name> --param chunk --values 64 128 256 512 \
        --seconds 6 --seed <n>

Prints one JSON line per value (and appends it to ``chiprun_out/sweep.jsonl``).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from pathlib import Path

from . import trace as tr
from .harness import find_cell, load_json, rate, run_window


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--param", required=True)
    ap.add_argument("--values", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    root = Path.cwd()
    cell, config, traffic, _ = find_cell(load_json(root / "BENCHMARK.json"), root, args.workload)
    eng_mod = importlib.import_module(f"vobench.engines.{traffic['engine']}")
    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    for v in args.values:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        eng = eng_mod.Engine(config, traffic, args.seed, "cuda", {"traffic": {args.param: v}})
        eng.capture.on = False
        t_build = time.perf_counter() - t
        t = time.perf_counter()
        eng.run_pass()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
        n, span = run_window(eng.run_pass, args.seconds)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                with torch.profiler.record_function("pass"):
                    eng.run_pass()
                    torch.cuda.synchronize()
        trc = tr.read(prof)
        rec = {"workload": args.workload, args.param: v, "rate": rate(n, eng.work_per_pass, span),
               "passes": n, "idle_pct": 100.0 * (1.0 - trc.busy_s / trc.window_s),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
               "build_s": t_build, "first_pass_s": t_first,
               "top_ops": [[k[:60], s] for k, s in trc.device_ops[:5]]}
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out / "sweep.jsonl", "a") as f:
            f.write(line + "\n")
        eng.release()
        del eng, prof, trc


if __name__ == "__main__":
    main()
