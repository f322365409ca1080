"""JAX reference figures for the full-size cross-modal metric-scale session.

Runs the JAX package's ``run_cross_modal_staged`` on the CPU on the world
``chip_smoke.py`` drives the port through: ``CameraRig()`` 376x1241, 40
frames, seed 0, ``cross_modal=True``, ``CrossModalConfig`` at its defaults
(500 features, 128 disparities, 200 pencil8 RANSAC samples, 6 refine steps,
20 LM iterations). For each RANSAC seed it prints one JSON line: steps that
succeeded, the relative scale errors against the true per-step travel, and
the metric ATE; then one line with the medians over the seeds.

    JAX_PLATFORMS=cpu python3 tools/jax_cross_modal_reference.py [--seeds 0 1 2 3 4]
        [--engine staged|step] [--solver pencil8|5point|hybrid]
        [--dump-draws DIR]

``--solver`` sets ``MonoVOParams.solver`` (default ``pencil8``, the
configuration's own default).

The seed keys only the RANSAC samples (the world is always seed 0). The
port cannot draw JAX's samples, so its accuracy is compared with the spread
over seeds rather than with one draw.

``--chunk`` only sets how many steps are vmapped together; each step's key
is folded from its global index, so the chunk changes no result beyond
vectorisation rounding. A small chunk keeps the CPU's memory low: the jnp
MI path materialises a (500, 128, 121, 20) one-hot per step.

``--dump-draws DIR`` writes instead, for each seed, the RANSAC draws of
the session's staged engine (step i keyed ``fold_in(key(seed), i)``, split
into one key per hypothesis, one Gumbel vector over the 500 feature slots
each: ``mono_vo._mono_vo_impl``) as index orders:
``DIR/cross_modal_draws_seed{seed}.npy``, (39 steps, 200 hypotheses, N)
uint16, each row the slots by descending Gumbel noise, the first N = 64
of them (``KEEP``). The first 8 valid slots of a row are the pencil8
sample JAX draws on that valid mask (the first 5 the ``5point`` solver's:
it keys its draws alike; the hybrid's escalation draws from another key).
``tools/cross_modal_witness.py`` runs the port with them.

``--engine step`` runs the same steps through the jitted per-frame
``cross_modal_step`` instead, with ``s_prev`` fixed at 1.0 as the staged
scan fixes it, and composes them as ``run_cross_modal_staged`` does: the
same algorithm, keys and samples, compiled another way. How far its
figures lie from the staged engine's shows how much rounding alone moves
them on this world.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uasl_motion_estimation_tpu.models.cross_modal import (  # noqa: E402
    CrossModalConfig, CrossModalResult, cross_modal_step, run_cross_modal_staged)
from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams  # noqa: E402
from uasl_motion_estimation_tpu.models.scale import ScaleConfig  # noqa: E402
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, SyntheticStereoSequence)
from jax_stress_reference import fold_in_orders  # noqa: E402

KEEP = 64  # slots kept of each dumped order: the port's picks reach slot 31 at most


def run_steps(frames, cfg, seed: int) -> CrossModalResult:
    """Every step through the per-frame jit with s_prev 1.0, composed as the
    staged engine composes its steps (a failed scale inherits the last)."""
    base = jax.random.key(seed)
    wire = [[jnp.asarray(np.clip(x, 0, 255).astype(np.uint8), jnp.float32) for x in f]
            for f in frames]
    pose, traj, scales, s0s, records = np.eye(4), [np.eye(4)], [], [], []
    s_prev = 1.0
    for i in range(len(frames) - 1):
        out = jax.device_get(cross_modal_step(wire[i][0], wire[i + 1][0], wire[i + 1][1],
                                              jax.random.fold_in(base, i), cfg, 1.0))
        scale = float(out.scale) if bool(out.s0_valid) else s_prev
        if bool(out.vo_success):
            motion = np.eye(4)
            motion[:3, :3] = np.asarray(out.R, np.float64)
            motion[:3, 3] = scale * np.asarray(out.t, np.float64)
            pose = pose @ np.linalg.inv(motion)
            s_prev = scale
        traj.append(pose.copy())
        scales.append(scale)
        s0s.append(float(out.s0))
        records.append({"success": bool(out.vo_success)})
    return CrossModalResult(trajectory=np.asarray(traj), scales=np.asarray(scales),
                            s0=np.asarray(s0s), records=records)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--engine", choices=("staged", "step"), default="staged")
    ap.add_argument("--solver", choices=("pencil8", "5point", "hybrid"), default="pencil8")
    ap.add_argument("--dump-draws", metavar="DIR")
    args = ap.parse_args()

    rig = CameraRig()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = CrossModalConfig(vo=MonoVOParams(intr=intr, solver=args.solver),
                           scale=ScaleConfig(intr=intr, baseline=rig.baseline))
    if args.dump_draws:
        Path(args.dump_draws).mkdir(parents=True, exist_ok=True)
        for seed in args.seeds:
            o = fold_in_orders(seed, args.frames - 1, cfg.vo.n_ransac, cfg.max_features)
            path = Path(args.dump_draws) / f"cross_modal_draws_seed{seed}.npy"
            np.save(path, o[..., :KEEP].astype(np.uint16))
            print(json.dumps({"seed": seed, "draws": str(path),
                              "shape": list(o[..., :KEEP].shape)}), flush=True)
        return 0
    seq = SyntheticStereoSequence(n_frames=args.frames, rig=rig, seed=0, cross_modal=True)
    frames = [seq.frame(i) for i in range(args.frames)]
    gt_speed = np.linalg.norm(np.diff(seq.poses[:, :3, 3], axis=0), axis=1)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.engine == "staged":
            res = run_cross_modal_staged(frames, cfg, seed=seed, chunk=args.chunk)
        else:
            res = run_steps(frames, cfg, seed)
        seconds = time.perf_counter() - t0
        err = np.abs(res.scales - gt_speed) / gt_speed
        success = [bool(r["success"]) for r in res.records]
        rows.append({
            "world": f"CameraRig() {rig.height}x{rig.width}, {args.frames} frames, seed 0, "
                     f"cross_modal",
            "ransac_seed": seed,
            "engine": args.engine,
            "solver": args.solver,
            "chunk": args.chunk,
            "n_success": int(sum(success)),
            "n_steps": len(success),
            "success": success,
            "scale_err_median": float(np.median(err)),
            "scale_err_max": float(err.max()),
            "ate_m": float(ate_rmse(res.trajectory[:, :3, 3], seq.gt_positions())),
            "scales": [float(s) for s in res.scales],
            "seconds_cpu": seconds,
        })
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"seeds": args.seeds, **{
        f"median_{k}": float(np.median([r[k] for r in rows]))
        for k in ("n_success", "scale_err_median", "scale_err_max", "ate_m")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
