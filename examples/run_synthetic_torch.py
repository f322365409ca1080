"""End-to-end demo of the PyTorch/CUDA port on the built-in synthetic world:
the latency-mode loop (stereo odometry with windowed BA), per-frame metrics
as JSONL, ATE and RPE, and result plots. No dataset required.

    python examples/run_synthetic_torch.py [n_frames] [out_dir] [--device cpu]

Runs on the CUDA card unless given ``--device cpu``. ``run`` does the
odometry and the metrics and needs no matplotlib; ``main`` adds the plots.
The port's counterpart of ``examples/run_synthetic.py``.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig, OdometrySystem
from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.utils.metrics import MetricsLogger, ate_rmse, rpe
from uasl_motion_estimation_tpu_torch.utils.synthetic import CameraRig, SyntheticStereoSequence


def run(n_frames: int, out_dir: str | Path, device=None) -> dict:
    """Odometry on ``n_frames`` of the 192x320 world (seed 4) on ``device``
    (default: the card), logging each frame to ``out_dir/metrics.jsonl``.
    Returns the trajectory, the ground truth and the figures."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    seq = SyntheticStereoSequence(n_frames=n_frames, rig=rig, seed=4)
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)

    metrics_path = out_dir / "metrics.jsonl"
    with open(metrics_path, "w") as fh:
        system = OdometrySystem(
            OdometryConfig(
                vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline),
                max_tracks=256, window=5, ba_rate=5,
                matcher=MatcherConfig(max_disparity=96),
            ),
            seed=0, logger=MetricsLogger(stream=fh), device=device,
        )
        traj = system.run(seq.frame(i) for i in range(n_frames))

    gt = seq.gt_positions()
    t_err, r_err = rpe(traj, seq.poses)
    return {"trajectory": traj, "gt": gt, "metrics_path": metrics_path,
            "ate_m": ate_rmse(traj[:, :3, 3], gt),
            "path_m": float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()),
            "rpe_t_m": t_err, "rpe_r_rad": r_err}


def main() -> None:
    from uasl_motion_estimation_tpu_torch.utils import viz

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=20)
    ap.add_argument("out_dir", nargs="?", default="/tmp/vo_demo")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()

    res = run(args.n_frames, args.out_dir, args.device)
    print(f"ATE: {res['ate_m']:.4f} m over {res['path_m']:.1f} m")
    print(f"RPE: {res['rpe_t_m'] * 100:.2f} cm/frame, "
          f"{np.degrees(res['rpe_r_rad']):.4f} deg/frame")
    out_dir = Path(args.out_dir)
    viz.plot_trajectories({"estimate": res["trajectory"], "ground truth": res["gt"]},
                          path=str(out_dir / "trajectory.png"))
    records = [json.loads(line) for line in open(res["metrics_path"])]
    viz.plot_metrics(records, path=str(out_dir / "metrics.png"))
    print(f"wrote {out_dir}/trajectory.png, metrics.png, metrics.jsonl")


if __name__ == "__main__":
    main()
