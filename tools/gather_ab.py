"""Compare the tile-gather kernel K1 of two checkouts of the port on one CUDA card.

    python3 tools/gather_ab.py --trees PARENT_DIR CHANGE_DIR [--runs 5]

Builds ``csrc/gather_tiles.cu`` of each tree (the same nvcc flags, this
checkout's ``_build.py``) and loads both into one process, so that each
comparison runs on one card and host, in turns (A, B, B, A):
- the staged stereo path on ``chip_smoke.py``'s world (``bench.py``'s:
  376x1241, 40 frames, seed 0, chunk 13), this checkout's port with each
  tree's kernel swapped in, three rounds of turns: median frames/s over
  ``--runs`` runs after one warm-up run, and K1's device time summed over
  the launches of one run (``torch.profiler``);
- K1 alone at every main-path tile shape and pyramid level, on the anchors
  that the stereo path gives it on its first chunk and on uniform random
  anchors (``chip_smoke.gather_cases``): cold, the median of 30 launches,
  each after the L2 is flushed, between CUDA events (``chip_smoke.cold_ms``).
  Both kernels must equal the plain version exactly on every case first.
Needs a card; prints one JSON object per stereo turn and per case, and a
summary object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops.kernels import _build  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg  # noqa: E402

KERNEL_SOURCE = "uasl_motion_estimation_tpu_torch/csrc/gather_tiles.cu"
ROUNDS = 3  # of A, B, B, A for the stereo path, whose host time drifts within a call


def stereo_world(dev):
    """``chip_smoke.py``'s stereo world, staged on the card, and its pipeline."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import (
        OdometryPipeline, default_config)
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=cs.N_FRAMES, rig=rig, seed=0)
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    pipe = OdometryPipeline(cfg, seed=0, device=dev)
    ls, rs = pipe.stage_frames([seq.frame(i) for i in range(cs.N_FRAMES)])

    def run():
        pipe.reset()
        return pipe.run_staged(ls, rs, chunk=cs.CHUNK)

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    trees = [str(Path(t).resolve()) for t in args.trees]
    sources = [Path(t) / KERNEL_SOURCE for t in trees]
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(_build.build_library, sources))
    fns = dict(zip("AB", (kg.bind(lib) for lib in libs)))
    for name, lib in zip("AB", libs):
        print(f"{name}: {lib.name}\n{Path(f'{lib}.log').read_text().strip()}", flush=True)

    t0 = time.perf_counter()
    stereo_run = stereo_world(dev)
    print(f"rendered and staged {cs.N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stereo = {"A": [], "B": []}
    calls = None
    for name in "ABBA" * ROUNDS:
        kg.GATHER._fn = fns[name]
        stereo_run()
        times = cs.timed_runs(stereo_run, args.runs)
        with cs.GatherShim(keep=cs.K1_PER_CHUNK) as shim:
            stereo_run()
        calls = shim.calls
        k1_ms = cs.kernel_times_ms(stereo_run, cs.K1_KERNEL, sum(shim.counts.values()))
        turn = {"tree": name, "frames_per_s": (cs.N_FRAMES - 1) / float(np.median(times)),
                "run_s": times, "k1_per_run_ms": None if k1_ms is None else sum(k1_ms)}
        stereo[name].append(turn)
        print(json.dumps(turn), flush=True)

    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = {}
    for case in cs.gather_cases(dev, calls):
        img, anc, (th, tw) = case["img"], case["anc"], case["tile"]

        def kernel(fn):
            def call():
                kg.GATHER._fn = fn
                return kg.gather_tiles(img, anc, th, tw)
            return call

        want = kg.gather_tiles_plain(img, anc, th, tw)
        for name, fn in fns.items():
            if not torch.equal(kernel(fn)(), want):
                raise AssertionError(f"tree {name}'s K1 differs from plain: {cs.case_name(case)}")
        runs = {"A": [], "B": []}
        for name in "ABBA":
            runs[name].append(cs.cold_ms(kernel(fns[name]), flush))
        nbytes = kg.gather_bytes(anc, *img.shape[-2:], th, tw)
        cases[cs.case_name(case)] = {
            "shape": [*anc.shape[:2], th, tw], "A_ms": runs["A"], "B_ms": runs["B"],
            "bound_ms": 1e3 * nbytes / cs.HBM_BYTES_PER_S, "bytes": nbytes}
        print(json.dumps({cs.case_name(case): cases[cs.case_name(case)]}), flush=True)

    summary = {"card": card, "trees": dict(zip("AB", trees))}
    for name in "AB":
        summary[name] = {"frames_per_s": [t["frames_per_s"] for t in stereo[name]],
                         "k1_per_run_ms": [t["k1_per_run_ms"] for t in stereo[name]]}
    summary["cold_ms"] = {key: {"A": min(c["A_ms"]), "B": min(c["B_ms"]),
                                "bound": c["bound_ms"]} for key, c in cases.items()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
