"""Compare the cross-modal session of two checkouts of the port on one CUDA card.

    python3 tools/cross_modal_ab.py --trees PARENT_DIR CHANGE_DIR [--runs 5]

Renders ``chip_smoke.py``'s cross-modal world once (``CameraRig()`` 376x1241,
40 frames, seed 0, right images in the second modality, uint8), then runs
each tree in its own process, in turns (A, B, B, A), so that both see the
same card and host. Each process imports the port from its tree, stages the
frames on the card and reports:
- the median wall time of ``run_cross_modal_staged(chunk=13)`` over
  ``--runs`` runs after one warm-up run, and the frames/s it gives;
- the MI matcher's time on the first 13-step chunk (500 grid features per
  step, 128 disparities), fenced with ``torch.cuda.synchronize``, median
  of 5;
- K2's launches in one session run, and its strip-mode launches where the
  tree counts them.
Needs a card; prints one JSON object per process and a summary object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_FRAMES, CHUNK = 40, 13

CHILD = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from uasl_motion_estimation_tpu_torch.models import frontend as fe
from uasl_motion_estimation_tpu_torch.models.cross_modal import (
    CrossModalConfig, run_cross_modal_staged)
from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
from uasl_motion_estimation_tpu_torch.models.scale import ScaleConfig
from uasl_motion_estimation_tpu_torch.ops import geometry as geo
from uasl_motion_estimation_tpu_torch.ops import image as im
from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
from uasl_motion_estimation_tpu_torch.utils import synthetic

frames = np.load(sys.argv[2])
runs, chunk = int(sys.argv[3]), int(sys.argv[4])
dev = torch.device("cuda:0")
ls = torch.from_numpy(frames["left"]).to(dev)
rs = torch.from_numpy(frames["right"]).to(dev)
rig = synthetic.CameraRig()
intr = geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
cfg = CrossModalConfig(vo=MonoVOParams(intr=intr), scale=ScaleConfig(intr=intr, baseline=rig.baseline))


def session():
    return run_cross_modal_staged((ls, rs), cfg, seed=0, chunk=chunk, device=dev)


session()
kmi.MI.launches = 0
if hasattr(kmi.MI, "strip_launches"):
    kmi.MI.strip_launches = 0
session()
launches = kmi.MI.launches
strip = getattr(kmi.MI, "strip_launches", None)
times = []
for _ in range(runs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session()
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
left = ls[1:chunk + 1].float()
right = rs[1:chunk + 1].float()
feats, _, valid = im.detect_features_grid(left, max_features=cfg.max_features)
matcher = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe.match_stereo(left, right, feats, valid, cfg.matcher, use_mi=True)
    torch.cuda.synchronize()
    matcher.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({"tree": sys.argv[1], "session_s": times,
                  "frames_per_s": (ls.shape[0] - 1) / float(np.median(times)),
                  "matcher_ms": float(np.median(matcher[1:])), "k2_launches": launches,
                  "k2_strip_launches": strip}))
"""


def render(path: Path) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=synthetic.CameraRig(),
                                            seed=0, cross_modal=True)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    np.savez(path, left=np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8),
             right=np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    trees = [str(Path(t).resolve()) for t in args.trees]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "frames.npz"
        t0 = time.perf_counter()
        render(path)
        print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s", flush=True)
        results = []
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            out = subprocess.run([sys.executable, "-c", CHILD, tree, str(path), str(args.runs),
                                  str(CHUNK)], capture_output=True, text=True,
                                 env={**os.environ, "PYTHONPATH": tree})
            if out.returncode != 0:
                print(out.stdout, out.stderr, file=sys.stderr)
                return out.returncode
            results.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(results[-1]), flush=True)
    summary = {"card": card}
    for name, tree in zip("AB", trees):
        mine = [r for r in results if r["tree"] == tree]
        summary[name] = {"tree": tree, "frames_per_s": [r["frames_per_s"] for r in mine],
                         "matcher_ms": [r["matcher_ms"] for r in mine],
                         "k2_launches": mine[0]["k2_launches"],
                         "k2_strip_launches": mine[0]["k2_strip_launches"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
