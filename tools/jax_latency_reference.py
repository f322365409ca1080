"""JAX reference figures for the full-size latency mode (``OdometrySystem``).

Runs the JAX package's ``OdometrySystem`` (persistent track table, per-frame
VO, windowed BA) on the CPU on the world ``chip_smoke.py`` drives the port
through: ``bench.py``'s ``CameraRig()`` 376x1241, 40 frames, world seed 0,
``OdometryConfig`` at its defaults (500 tracks, window 5, ba_rate 5, n_fixed
2, grid detection at quality 1e-4, ``MatcherConfig()``, ``KLTConfig()``,
``hyp_solver="3pt"``). For each RANSAC seed and mode (VO only, with BA) it
prints one JSON line: the ATE, the successful steps, the keyframes and the
BA costs; then one line with the medians over the seeds per mode.

    JAX_PLATFORMS=cpu python3 tools/jax_latency_reference.py [--seeds 0 1 2]
        [--p3p] [--dump-draws DIR]

``--p3p`` also runs the staged stereo engine with ``hyp_solver="p3p"``
(``default_config``, chunk 13) on the same world and seeds and prints its
ATE and their median.

``--dump-draws DIR`` writes, per seed, the RANSAC draws of JAX's key chain
(``OdometrySystem`` splits its key once per frame after the first, and
``stereo_vo_solve`` draws one Gumbel vector per hypothesis from that key)
as index orders: ``latency_draws_seed{seed}.npy``, (39 steps, 200
hypotheses, 500 slots) uint16, each row the slots by descending Gumbel
noise. The first 3 valid slots of a row are the hypothesis JAX samples on
that valid mask. ``tools/latency_witness.py DIR`` runs the port with them.

The seed keys only the RANSAC samples; the port cannot draw JAX's, so
``chip_smoke.py`` compares its medians over seeds with these.
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

from uasl_motion_estimation_tpu.models.odometry import (  # noqa: E402
    OdometryConfig, OdometrySystem)
from uasl_motion_estimation_tpu.models.pipeline import (  # noqa: E402
    OdometryPipeline, default_config)
from uasl_motion_estimation_tpu.models.stereo_vo import StereoVOParams  # noqa: E402
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import MetricsLogger, ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, SyntheticStereoSequence)

CHUNK = 13  # the staged p3p run's chunk, as chip_smoke.py runs stereo


def draw_orders(seed: int, n_steps: int, n_ransac: int, n_slots: int) -> np.ndarray:
    """(n_steps, n_ransac, n_slots) slot orders by descending Gumbel noise,
    from OdometrySystem's key chain (odometry.py:286) and
    ``_sample_hypotheses``'s per-hypothesis keys (stereo_vo.py:201-218)."""

    @jax.jit
    def orders(sub):
        g = jax.vmap(lambda k: jax.random.gumbel(k, (n_slots,)))(
            jax.random.split(sub, n_ransac))
        return jnp.argsort(-g, axis=-1, stable=True)

    key = jax.random.key(seed)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(orders(sub)))
    return np.stack(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--modes", nargs="+", choices=("vo", "ba"), default=["vo", "ba"])
    ap.add_argument("--p3p", action="store_true")
    ap.add_argument("--dump-draws", metavar="DIR")
    args = ap.parse_args()

    rig = CameraRig()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = OdometryConfig(vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline))
    world = f"CameraRig() {rig.height}x{rig.width}, {args.frames} frames, seed 0"
    if args.dump_draws:
        Path(args.dump_draws).mkdir(parents=True, exist_ok=True)
        for seed in args.seeds:
            o = draw_orders(seed, args.frames - 1, cfg.vo.n_ransac, cfg.max_tracks)
            path = Path(args.dump_draws) / f"latency_draws_seed{seed}.npy"
            np.save(path, o.astype(np.uint16))
            print(json.dumps({"seed": seed, "draws": str(path), "shape": list(o.shape)}),
                  flush=True)

    seq = SyntheticStereoSequence(n_frames=args.frames, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(args.frames)]
    gt = seq.gt_positions()
    rows = []
    for mode in args.modes:
        for seed in args.seeds:
            log = MetricsLogger()
            system = OdometrySystem(cfg, seed=seed, logger=log, use_ba=mode == "ba")
            t0 = time.perf_counter()
            traj = system.run(frames)
            rows.append({
                "world": world, "mode": mode, "ransac_seed": seed,
                "ate_m": float(ate_rmse(traj[:, :3, 3], gt)),
                "n_success": sum(bool(r.get("success")) for r in log.records),
                "n_steps": args.frames - 1,
                "n_keyframes": system.n_keyframes,
                "ba_cost": [r["ba_cost"] for r in log.records if "ba_cost" in r],
                "seconds_cpu": time.perf_counter() - t0,
            })
            print(json.dumps(rows[-1]), flush=True)
    summary = {"world": world, "seeds": args.seeds}
    for mode in args.modes:
        mine = [r for r in rows if r["mode"] == mode]
        summary[f"median_ate_{mode}_m"] = float(np.median([r["ate_m"] for r in mine]))
        summary[f"min_success_{mode}"] = min(r["n_success"] for r in mine)
    if args.p3p:
        pcfg = default_config(intr, rig.baseline, hyp_solver="p3p")
        ates = []
        for seed in args.seeds:
            pipe = OdometryPipeline(pcfg, seed=seed)
            traj = pipe.run_staged(*pipe.stage_frames(frames), chunk=CHUNK)
            ates.append(float(ate_rmse(traj[:, :3, 3], gt)))
            print(json.dumps({"world": world, "engine": "staged stereo", "hyp_solver": "p3p",
                              "ransac_seed": seed, "ate_m": ates[-1]}), flush=True)
        summary["p3p_ate_m"] = ates
        summary["median_p3p_ate_m"] = float(np.median(ates))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
