"""Readings for the limits of ``correct``: the compared numbers of the
program and of its control (the reference in the program's place in TF32)
on many seeds at a cell's own size, one pass each, in one process.

    python3 -m vobench.readings --workload <name> --seeds 1 2 3 [--control]

Prints one JSON line per seed (and appends it to
``chiprun_out/readings.jsonl``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from pathlib import Path

from .harness import find_cell, load_json


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    root = Path.cwd()
    cell, config, traffic, _ = find_cell(load_json(root / "BENCHMARK.json"), root, args.workload)
    eng_mod = importlib.import_module(f"vobench.engines.{traffic['engine']}")
    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        eng = eng_mod.Engine(config, traffic, seed, args.device, {})
        eng.capture.start_pass()
        eng.run_pass()
        if args.device != "cpu":
            torch.cuda.synchronize()
        eng.release()
        t_prog = time.perf_counter() - t
        cap = eng.capture.judged
        t = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, "program": eng.judge(cap)}
        rec["judge_s"] = time.perf_counter() - t
        rec["sanity"] = eng.sanity(cap)
        if args.control:
            t = time.perf_counter()
            rec["control"] = eng.control(cap)
            rec["control_s"] = time.perf_counter() - t
        rec["pass_and_setup_s"] = t_prog
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out / "readings.jsonl", "a") as f:
            f.write(line + "\n")
        del eng, cap
        if args.device != "cpu":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
