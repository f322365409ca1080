"""The latency mode (``OdometrySystem``) solved with the JAX reference's RANSAC
draws: does the port read JAX's ATE seed for seed?

    JAX_PLATFORMS=cpu python3 tools/jax_latency_reference.py --seeds 0 1 2 \
        --dump-draws DIR
    python3 tools/latency_witness.py DIR [--device cuda] [--seeds 0 1 2]

The port draws its RANSAC samples from torch generators keyed on (seed,
frame), so on its own it cannot reproduce JAX's trajectory for one seed;
``chip_smoke.py`` holds it to JAX's medians over seeds. Here the port's
sampler seam takes JAX's draws instead: for each frame and hypothesis the
first 3 valid slots of the dumped order (descending Gumbel noise), which is
what JAX's ``_sample_hypotheses`` picks on the same valid mask. On
``bench.py``'s world (``CameraRig()`` 376x1241, 40 frames, world seed 0,
``OdometryConfig`` at its defaults) it prints, per seed and mode (VO only,
with BA), the port's ATE with JAX's draws, JAX's own
(``chip_smoke.JAX_LATENCY``, from ``tools/jax_latency_reference.py`` on the
CPU) and the port's with its own
draws, then one JSON line with the largest difference from JAX's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import JAX_LATENCY, DrawsSampler  # noqa: E402

from uasl_motion_estimation_tpu_torch.models.odometry import (  # noqa: E402
    OdometryConfig, OdometrySystem)
from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic  # noqa: E402

N_FRAMES = 40


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("draws", help="directory of latency_draws_seed{seed}.npy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--modes", nargs="+", choices=("vo", "ba"), default=["vo", "ba"])
    args = ap.parse_args()
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    gt = seq.gt_positions()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = OdometryConfig(vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline))
    rows = []
    for mode in args.modes:
        for seed in args.seeds:
            orders = np.load(Path(args.draws) / f"latency_draws_seed{seed}.npy")
            row = {"mode": mode, "seed": seed, "jax_ate_m": JAX_LATENCY[mode][seed]}
            for name, sampler in (("port_jax_draws_ate_m", DrawsSampler(orders, args.device)),
                                  ("port_own_draws_ate_m", None)):
                system = OdometrySystem(cfg, seed=seed, use_ba=mode == "ba",
                                        device=args.device, sampler=sampler)
                traj = system.run(frames)
                row[name] = float(metrics.ate_rmse(traj[:, :3, 3], gt))
            rows.append(row)
            print(json.dumps(row), flush=True)
    card = "cpu"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    diff = [abs(r["port_jax_draws_ate_m"] - r["jax_ate_m"]) for r in rows]
    print(json.dumps({"card": card, "seeds": args.seeds, "rows": rows,
                      "max_abs_diff_jax_draws_m": max(diff)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
