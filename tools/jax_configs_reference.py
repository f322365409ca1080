"""JAX reference figures for the JAX package's published configurations 2-4
(``benchmarks/extra_configs.py``) and its engine-covariance check
(``benchmarks/cov_circuit.py:141-200``), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_configs_reference.py [--blocks config2 config3
        config4 cov] [--seeds 0 1 2 3 4] [--cov-seeds 1] [--dump-draws DIR]
        [--ba-out FILE]

Blocks, each exactly as its source builds it:

- ``config2`` (``extra_configs.py:33-106``): the EuRoC-like rig (fu 458.65,
  fv 457.3, cu 367.2, cv 248.4, baseline 0.11 m, 480x752), 17 frames, world
  seed 1; ``default_config`` without ``image_shape`` (so ``min_spread_area``
  stays KITTI's 1000 px^2) with ``MatcherConfig(max_disparity=64)``. Per
  RANSAC seed: staged VO (``run_staged(chunk=8)``) and the unified VO+BA
  engine (``run_unified_system(..., wchunk=4)``, which is
  ``unified_system_scan`` keyed ``key(seed)`` and ``compose_unified``).
- ``config3`` (``extra_configs.py:109-209``, the accuracy block, and
  ``:293-333``, the bad-init recovery of ``bench_mi_scale``): one
  ``match_stereo(use_mi=True)`` on the 192x320 world of seed 2 with the
  right image ``255 - right``, 256 top-k features, 64 disparities; then
  ``estimate_scale`` from ``s_init`` 0.5 and 2.8 on frame 0 of the
  cross-modal world of seed 3 (``coarse_candidates=13``, true scale 1.4).
- ``config4`` (``extra_configs.py:357-392``): 16 windows of 10 frames x 256
  points, noise 0.3 px, built by ``tests/test_ba.py``'s ``make_window`` and
  ``perturb``, solved by ``jax.vmap(ba_solve)``; ``--ba-out`` writes each
  window's cameras, cost, convergence and iteration count as ``.npz``.
- ``cov`` (``cov_circuit.py:141-200``): the unified engine on the corrupted
  40-frame KITTI-size world (world seed 0) per ``--cov-seeds`` RANSAC seed
  (the block's own is 1): the emitted motion and pose covariances against
  the truth.

``--dump-draws DIR`` writes config 2's unified draws for seeds 0-2
(``DIR/unified_euroc_draws_seed{seed}.npy``: (16 motions, 200 hypotheses,
``KEEP``) uint16, each row the track table's 500 rows by descending Gumbel
noise, cut to its first ``KEEP``), as ``tools/jax_stress_reference.py``
dumps turn_10deg's; ``tools/north_star_witness.py`` runs the port on them.
Each block prints one JSON line per seed and one with its medians.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (its numpy helpers and constants; no torch call)
from jax_stress_reference import fold_in_orders  # noqa: E402
from uasl_motion_estimation_tpu.models import frontend as fe  # noqa: E402
from uasl_motion_estimation_tpu.models.pipeline import (  # noqa: E402
    OdometryPipeline, default_config)
from uasl_motion_estimation_tpu.models.smoother import (  # noqa: E402
    SmootherConfig, run_unified_system)
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import MetricsLogger, ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, CorruptionConfig, SyntheticStereoSequence)

KEEP = 64  # slots kept of each dumped order: the port's picks reach slot 21 at most


def config2_setup():
    """(rig, sequence, frames, PipelineConfig) of extra_configs.py's config 2."""
    rig = CameraRig(**smoke.EUROC_RIG)
    seq = SyntheticStereoSequence(n_frames=smoke.EUROC_FRAMES, rig=rig, seed=smoke.EUROC_WORLD)
    frames = [seq.frame(i) for i in range(smoke.EUROC_FRAMES)]
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)._replace(
        matcher=fe.MatcherConfig(max_disparity=smoke.EUROC_DISP))
    return rig, seq, frames, cfg


def block_config2(seeds, dump_draws) -> dict:
    _, seq, frames, cfg = config2_setup()
    gt = seq.gt_positions()
    if dump_draws:
        Path(dump_draws).mkdir(parents=True, exist_ok=True)
        for seed in smoke.EUROC_WITNESS_SEEDS:
            o = fold_in_orders(seed, smoke.EUROC_FRAMES - 1, cfg.vo.n_ransac, cfg.max_features)
            o = o[..., :KEEP].astype(np.uint16)  # 500 rows: two bytes each
            path = Path(dump_draws) / f"unified_euroc_draws_seed{seed}.npy"
            np.save(path, o)
            print(json.dumps({"seed": seed, "draws": str(path), "shape": list(o.shape)}),
                  flush=True)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        log = MetricsLogger()
        pipe = OdometryPipeline(cfg, seed=seed, logger=log)
        traj = pipe.run_staged(*pipe.stage_frames(frames), chunk=smoke.EUROC_CHUNK)
        res = run_unified_system(frames, SmootherConfig(pipe=cfg), seed=seed,
                                 wchunk=smoke.EUROC_WCHUNK)
        row = {"block": "config2", "ransac_seed": seed,
               "staged_ate_m": float(ate_rmse(traj[:, :3, 3], gt)),
               "staged_success": sum(bool(r["success"]) for r in log.records),
               "unified_ate_vo_m": float(ate_rmse(res.traj_vo[:, :3, 3], gt)),
               "unified_ate_ba_m": float(ate_rmse(res.traj_ba[:, :3, 3], gt)),
               "vo_success": int(np.sum(res.per_frame[:, 16] > 0.5)),
               "ba_converged": int(np.sum(res.ba_converged)),
               "n_windows": int(len(res.ba_converged)),
               "ba_cost": [float(c) for c in res.ba_cost],
               "seconds_cpu": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = ("staged_ate_m", "unified_ate_vo_m", "unified_ate_ba_m")
    out = {"block": "config2", "seeds": list(seeds), **{k: [r[k] for r in rows] for k in keys},
           **{f"median_{k}": float(np.median([r[k] for r in rows])) for k in keys}}
    print(json.dumps(out), flush=True)
    return out


def block_config3() -> dict:
    from uasl_motion_estimation_tpu.models.scale import ScaleConfig, estimate_scale
    from uasl_motion_estimation_tpu.ops import image as im

    rig = CameraRig(*smoke.small_rig())
    seq = SyntheticStereoSequence(n_frames=1, rig=rig, seed=smoke.MI_WORLD)
    left, right = seq.frame(0)
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(255.0 - right, jnp.float32)
    feats, _, v0 = im.detect_features(left, max_features=smoke.MI_FEATURES)
    cfg = fe.MatcherConfig(max_disparity=smoke.MI_DISP)
    fr, _, v = fe.match_stereo(left, right, feats, v0, cfg, use_mi=True)
    out = {"block": "config3", **smoke.mi_accuracy(
        np.asarray(feats), np.asarray(v0), np.asarray(fr), np.asarray(v), seq.gt_disparity(0),
        cfg.min_disparity, cfg.max_disparity)}

    # bench_mi_scale's bad-init recovery (extra_configs.py:293-333)
    cseq = SyntheticStereoSequence(n_frames=smoke.RECOVERY_FRAMES, rig=rig,
                                   seed=smoke.RECOVERY_WORLD, cross_modal=True)
    left0, right0 = map(jnp.asarray, cseq.frame(0))
    feats, _, v0 = im.detect_features_grid(left0, max_features=smoke.MI_FEATURES,
                                           quality_level=1e-4)
    pts, ok = smoke.recovery_points(np.asarray(feats), np.asarray(v0), cseq.gt_disparity(0), rig)
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    scfg = ScaleConfig(intr=intr, baseline=rig.baseline)._replace(coarse_candidates=13)
    rec = {}
    for s_init in smoke.JAX_RECOVERY:
        s, lm = estimate_scale(left0, right0, jnp.asarray(pts), jnp.asarray(ok),
                               jnp.asarray(s_init), scfg)
        rec[str(s_init)] = {"recovered": float(s), "n_iter": int(lm.n_iter)}
    out["bad_init_recovery"] = rec
    print(json.dumps(out), flush=True)
    return out


def block_config4(ba_out) -> dict:
    from test_ba import BASELINE, INTR, make_window, perturb
    from uasl_motion_estimation_tpu.solvers.ba import BAConfig, BAProblem, ba_solve

    problems = []
    for s in range(smoke.BA4_WINDOWS):
        cams, pts, obs, mask = make_window(n_frames=smoke.BA4_FRAMES, n_pts=smoke.BA4_POINTS,
                                           noise=smoke.BA4_NOISE, seed=s)
        cams_p, pts_p = perturb(cams, pts, seed=s + 100)
        problems.append(BAProblem(jnp.asarray(cams_p), jnp.asarray(pts_p), jnp.asarray(obs),
                                  jnp.asarray(mask)))
    batch = jax.tree.map(lambda *x: jnp.stack(x), *problems)
    res = jax.device_get(jax.jit(jax.vmap(lambda p: ba_solve(p, BAConfig(
        intr=INTR, baseline=BASELINE))))(batch))
    out = {"block": "config4", "cost": [float(c) for c in res.cost],
           "converged": [bool(c) for c in res.converged],
           "n_iter": [int(n) for n in res.n_iter], "mean_cost": float(np.mean(res.cost))}
    if ba_out:
        np.savez(ba_out, cam=np.asarray(res.cam), cost=np.asarray(res.cost),
                 converged=np.asarray(res.converged), n_iter=np.asarray(res.n_iter))
        out["ba_out"] = str(ba_out)
    print(json.dumps(out), flush=True)
    return out


def block_cov(seeds) -> list:
    rig = CameraRig()
    seq = SyntheticStereoSequence(n_frames=smoke.N_FRAMES, rig=rig, seed=0,
                                  corruption=CorruptionConfig())
    frames = [seq.frame(i) for i in range(smoke.N_FRAMES)]
    cfg = SmootherConfig(pipe=default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                                             rig.baseline))
    rows = []
    for seed in seeds:
        res = run_unified_system(frames, cfg, seed=seed, wchunk=smoke.COV_WCHUNK)
        row = {"block": "cov", "ransac_seed": seed, **smoke.covariance_figures(res, seq.poses)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", nargs="+", default=["config2", "config3", "config4", "cov"],
                    choices=["config2", "config3", "config4", "cov"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--cov-seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--dump-draws", metavar="DIR")
    ap.add_argument("--ba-out", metavar="FILE")
    args = ap.parse_args()
    if "config2" in args.blocks:
        block_config2(args.seeds, args.dump_draws)
    if "config3" in args.blocks:
        block_config3()
    if "config4" in args.blocks:
        block_config4(args.ba_out)
    if "cov" in args.blocks:
        block_cov(args.cov_seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
