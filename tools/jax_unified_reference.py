"""JAX reference figures for the full-size integrated VO+BA engine.

Runs the JAX package's unified track-table engine (``unified_system_scan``
then ``compose_unified``, as ``bench.py`` times it) on the CPU on the world
``chip_smoke.py`` drives the port through: ``CameraRig()`` 376x1241, 40
frames, world seed 0, ``SmootherConfig(pipe=default_config(...))`` at its
defaults (window 5, ba_rate 4, 500 features, 25 BA iterations), 10 windows.
For each RANSAC seed it prints one JSON line: the ATE of the VO chain and of
the BA-refined chain, BA convergence and the gated observations per window,
the successful motions; then one line with the medians over the seeds.

    JAX_PLATFORMS=cpu python3 tools/jax_unified_reference.py [--seeds 0 1 2]
        [--corrupted] [--wchunk 1] [--frames 40] [--small] [--track-gate-px PX]

``--corrupted`` renders the world of ``benchmarks/full_system.py``
(``CorruptionConfig()``: photometric corruption, moving objects, an
occluder). The seed keys only the RANSAC samples. The port cannot draw
JAX's samples, so its accuracy is compared with JAX's over seeds rather
than with one draw.

``--small`` runs instead the 192x320 world of the JAX package's own
integrated tests (``tests/test_smoother.py``: fu = fv = 320, 256 features,
world seed 4; ``--wchunk 4`` groups its windows as ``run_unified_system``
does there); ``--track-gate-px`` sets
``SmootherConfig.track_gate_px`` (1e6 turns the pre-BA track gate off, as
``tests/test_smoother.py``'s gate test does).

``--wchunk`` only sets how many windows are vmapped together (``bench.py``
uses 5); each motion's key is folded from its global index, so it changes
no result beyond vectorisation rounding. One window at a time keeps the
CPU's memory low.
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

from uasl_motion_estimation_tpu.models.pipeline import default_config  # noqa: E402
from uasl_motion_estimation_tpu.models.smoother import (  # noqa: E402
    SmootherConfig, compose_unified, unified_system_scan)
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, CorruptionConfig, SyntheticStereoSequence)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--wchunk", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--corrupted", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--track-gate-px", type=float, default=None)
    args = ap.parse_args()

    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54, height=192,
                    width=320) if args.small else CameraRig()
    world_seed = 4 if args.small else 0
    seq = SyntheticStereoSequence(n_frames=args.frames, rig=rig, seed=world_seed,
                                  corruption=CorruptionConfig() if args.corrupted else None)
    frames = [seq.frame(i) for i in range(args.frames)]
    gt = seq.gt_positions()
    ls = jnp.asarray(np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8))
    rs = jnp.asarray(np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8))
    pipe = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    cfg = SmootherConfig(pipe=pipe._replace(max_features=256) if args.small else pipe)
    if args.track_gate_px is not None:
        cfg = cfg._replace(track_gate_px=args.track_gate_px)
    world = (f"{rig.height}x{rig.width}, {args.frames} frames, seed {world_seed}"
             + (", CorruptionConfig()" if args.corrupted else "")
             + (f", track_gate_px {cfg.track_gate_px}" if args.track_gate_px else ""))
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = jax.device_get(unified_system_scan(ls, rs, jax.random.key(seed), cfg,
                                                 wchunk=args.wchunk))
        res = compose_unified(out, args.frames, cfg)
        seconds = time.perf_counter() - t0
        rows.append({
            "world": world,
            "ransac_seed": seed,
            "wchunk": args.wchunk,
            "ate_vo_m": float(ate_rmse(res.traj_vo[:, :3, 3], gt)),
            "ate_ba_m": float(ate_rmse(res.traj_ba[:, :3, 3], gt)),
            "ba_converged": [bool(c) for c in res.ba_converged],
            "n_track_obs": [int(n) for n in res.n_track_obs],
            "n_success": int(np.sum(res.per_frame[:, 16] > 0.5)),
            "n_motions": int(res.per_frame.shape[0]),
            "seconds_cpu": seconds,
        })
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"world": world, "seeds": args.seeds, **{
        f"median_{k}": float(np.median([r[k] for r in rows]))
        for k in ("ate_vo_m", "ate_ba_m", "n_success")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
