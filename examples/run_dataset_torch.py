"""Stereo odometry of the PyTorch/CUDA port on an on-disk dataset described
by a reference-format YML config (the schema the C++ library reads;
utils/io.py).

    python examples/run_dataset_torch.py config.yml [out_dir] [--device cpu]

The dataset directory must use one of the supported layouts (KITTI
L_/R_*.png or cam{N}_image{NNNNN}.png). Frames come from the native async
frame loader where it builds (g++ and OpenCV's headers), else from the
pure-Python reader. Runs on the CUDA card unless given ``--device cpu``.
The port's counterpart of ``examples/run_dataset.py``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig, OdometrySystem
from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams
from uasl_motion_estimation_tpu_torch.native import AsyncFrameLoader, native_available
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.utils import io as uio
from uasl_motion_estimation_tpu_torch.utils.checkpoint import checkpoint_every
from uasl_motion_estimation_tpu_torch.utils.metrics import MetricsLogger


def main() -> None:
    from uasl_motion_estimation_tpu_torch.utils import viz

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("out_dir", nargs="?", default="/tmp/vo_run")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    session = uio.load_yml(args.config)
    cal = session.calib
    intr = Intrinsics(cal.fu1, cal.fv1, cal.cu1, cal.cv1)
    logger = MetricsLogger(path=str(out_dir / "metrics.jsonl"))
    system = OdometrySystem(
        OdometryConfig(
            vo=StereoVOParams(
                intr1=intr,
                intr2=Intrinsics(cal.fu2, cal.fv2, cal.cu2, cal.cv2),
                baseline=cal.baseline,
                inlier_threshold=cal.inlier_threshold,
                use_lm=(cal.method == "LM"),
                ransac=cal.ransac,
            ),
            max_tracks=session.tracking.nb_feats,
            window=session.tracking.window_size,
            ba_rate=session.tracking.ba_rate,
            # TrackingInfo.parallax drives the keyframe gate (file_IO.h:73)
            parallax=session.tracking.parallax,
            n_fixed=cal.nb_fixed_frames,
            matcher=MatcherConfig(),
        ),
        logger=logger, device=args.device,
    )
    controller = uio.RunController(str(out_dir / "control"))

    if native_available():
        frames = ((left, right) for _, left, right in AsyncFrameLoader(
            session.dataset.dir, start=session.frames.start, stop=session.frames.stop,
            skip=session.frames.skip, appendix=session.appendix))
    else:
        frames = uio.ImageSequenceReader(session.dataset.dir, session.frames,
                                         appendix=session.appendix)
    try:
        for left, right in frames:
            if not controller.checkpoint():
                print("stopped by controller")
                break
            system.process_pair(left, right)
            checkpoint_every(system, str(out_dir / "ckpt"), every=100)
    finally:
        logger.close()

    traj = np.asarray(system.trajectory)
    np.savetxt(out_dir / "trajectory.txt", traj[:, :3, :].reshape(len(traj), 12))
    viz.plot_trajectories({"estimate": traj}, path=str(out_dir / "trajectory.png"))
    print(f"{len(traj)} poses -> {out_dir}/trajectory.txt, trajectory.png")


if __name__ == "__main__":
    main()
