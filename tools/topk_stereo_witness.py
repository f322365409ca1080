"""Staged stereo VO with the top-k detector, solved with the JAX reference's
RANSAC draws: does the port read JAX's ATE seed for seed?

    JAX_PLATFORMS=cpu python3 tools/jax_mono_reference.py --stereo-topk \
        --seeds 0 1 2 3 4 --dump-draws DIR
    python3 tools/topk_stereo_witness.py DIR [--device cuda]

The port draws its RANSAC samples from torch generators, so on its own it
cannot reproduce JAX's trajectory for one seed; ``chip_smoke.py`` holds it
to JAX's median over seeds. Here the port's sampler seam takes JAX's
draws instead: for each step and hypothesis the first 3 valid entries of
the dumped index order (descending Gumbel noise), which is what JAX's
``_sample_hypotheses`` picks on the same valid mask. On ``bench.py``'s
world (``CameraRig()`` 376x1241, 40 frames, seed 0, ``default_config`` with
``detector="topk"``, chunk 13) it prints, per seed, the port's ATE with
JAX's draws, JAX's own (``tools/jax_mono_reference.py --stereo-topk``, on
the CPU) and the port's with its own draws, then one JSON line. Where the
front end and the solver are JAX's, the first two agree closely, and the
spread between seeds comes from the draws alone.
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

from chip_smoke import DrawsSampler  # noqa: E402
from uasl_motion_estimation_tpu_torch.models.pipeline import (  # noqa: E402
    OdometryPipeline, default_config)
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic  # noqa: E402

N_FRAMES, CHUNK = 40, 13
# tools/jax_mono_reference.py --stereo-topk --seeds 0 1 2 3 4, on the CPU
JAX_TOPK_ATE = [0.14897930153217467, 0.19743871820214268, 0.10794871517741095,
                0.1599980819142645, 0.1135857873009703]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("draws", help="directory of topk_draws_seed{seed}.npy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    gt = seq.gt_positions()
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)._replace(
        detector="topk")
    rows = []
    for seed in args.seeds:
        orders = np.load(Path(args.draws) / f"topk_draws_seed{seed}.npy")
        row = {"seed": seed, "jax_ate_m": JAX_TOPK_ATE[seed]}
        for name, sampler in (("port_jax_draws_ate_m", DrawsSampler(orders, args.device)),
                              ("port_own_draws_ate_m", None)):
            pipe = OdometryPipeline(cfg, seed=seed, device=args.device, sampler=sampler)
            traj = pipe.run_staged(*pipe.stage_frames(frames), chunk=CHUNK)
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
