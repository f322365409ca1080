"""JAX reference figures for the monocular VO engine at full width.

Runs the JAX package's ``run_mono_staged`` on the CPU on
``benchmarks/extra_configs.py``'s ``bench_mono`` world: ``CameraRig(fu=458.65,
fv=457.3, cu=367.2, cv=248.4, baseline=0.11)`` 480x752, 13 frames, seed 3,
left camera only; ``MonoPipelineConfig(vo=MonoVOParams(intr,
inlier_threshold=2.0, solver=...), max_features=256)``, ``initial_speed=0.8``,
chunk 8. For each solver and RANSAC seed it prints one JSON line: the
steps the staged scan solved, the steps the engine-level hybrid escalated
to the exact 5-point and how many of those it kept, and the ATE; then one
line per solver with the medians over the seeds.

    JAX_PLATFORMS=cpu python3 tools/jax_mono_reference.py [--seeds 0 1 2 3 4]
        [--solvers pencil8 5point hybrid] [--hybrid-ratio R] [--per-frame]
        [--stereo-topk] [--dump-draws DIR]

The seed keys only the RANSAC samples (the world is always seed 3). The
port cannot draw JAX's samples, so its accuracy is compared with the
median over seeds rather than with one draw. The escalation figures repeat
``run_mono_staged``'s own rule on its scan's outputs (the function returns
the trajectory only); the trajectory and ATE are the function's own.

``--hybrid-ratio`` sets ``MonoVOParams.hybrid_ratio`` (1.5 escalates every
step of this world). ``--per-frame`` runs instead the per-frame loop
(``MonoOdometryPipeline.run``, on the unquantised frames) for each solver
and seed.

``--stereo-topk`` runs instead the other user of the top-k detector: staged
stereo VO (``OdometryPipeline.run_staged``, chunk 13) with
``detector="topk"`` on ``bench.py``'s world (``CameraRig()`` 376x1241, 40
frames, seed 0, ``default_config``), printing the ATE per RANSAC seed and
their median. ``--dump-draws DIR`` writes instead, for each seed, the
random draws of that run's RANSAC sampler (``stereo_vo._sample_hypotheses``
with the key ``fold_in(key(seed), step)``): ``DIR/topk_draws_seed{seed}.npy``,
(39, 200, 500) uint16, for step and hypothesis the 500 match indices in
descending order of their Gumbel noise (ties: the lower index first, as
``top_k`` breaks them). The first 3 valid entries of a row are JAX's
sample on that valid mask; ``tools/topk_stereo_witness.py`` feeds them to
the port.
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

from uasl_motion_estimation_tpu.models.mono_pipeline import (  # noqa: E402
    MonoPipelineConfig, mono_sequence_scan, mono_vo_step, run_mono_staged)
from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams  # noqa: E402
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, SyntheticStereoSequence)

INITIAL_SPEED = 0.8
CHUNK = 8


def scan_figures(frames, cfg, seed: int) -> dict:
    """The staged scan's per-step success and inliers, and for ``hybrid``
    the steps ``run_mono_staged`` escalates and which of them its 5-point
    re-solve replaces (its rule, on the same scan outputs)."""
    solver = cfg.vo.solver
    scan_cfg = cfg._replace(vo=cfg.vo._replace(solver="pencil8")) if solver == "hybrid" else cfg
    ls = jnp.asarray(np.clip(np.stack(frames), 0, 255).astype(np.uint8))
    b = len(frames) - 1
    g = -(-b // CHUNK)
    base = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(g * CHUNK, dtype=jnp.int32))
    out = jax.device_get(mono_sequence_scan(ls, keys, scan_cfg, chunk=CHUNK))
    succ = np.asarray(out.success, bool)
    ninl = np.asarray(out.n_inliers)
    fig = {"scan_success": succ.tolist(), "n_inliers": ninl.tolist(),
           "n_matches": np.asarray(out.n_matches).tolist(),
           "rel_scale": np.asarray(out.rel_scale).tolist(), "escalated": [], "replaced": []}
    if solver == "hybrid":
        need = ~succ | (ninl < cfg.vo.hybrid_ratio * np.maximum(out.n_matches, 1))
        cfg5 = cfg._replace(vo=cfg.vo._replace(solver="5point"))
        final = succ.copy()
        for i in np.nonzero(need)[0]:
            key5 = jax.random.fold_in(jax.random.fold_in(base, int(i)), 5)
            res = jax.device_get(mono_vo_step(ls[i].astype(jnp.float32),
                                              ls[i + 1].astype(jnp.float32), key5, cfg5).result)
            better = (bool(res.success) and not succ[i]) or (
                bool(res.success) == bool(succ[i]) and int(res.n_inliers) > int(ninl[i]))
            fig["escalated"].append(int(i))
            if better:
                fig["replaced"].append(int(i))
                final[i] = bool(res.success)
        succ = final
    fig["n_success"] = int(succ.sum())
    return fig


def stereo_topk(seeds) -> None:
    """Staged stereo VO with the top-k detector on bench.py's world."""
    from uasl_motion_estimation_tpu.models.pipeline import OdometryPipeline, default_config

    rig = CameraRig()
    seq = SyntheticStereoSequence(n_frames=40, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(40)]
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)._replace(
        detector="topk")
    ates = []
    for seed in seeds:
        pipe = OdometryPipeline(cfg, seed=seed)
        traj = pipe.run_staged(*pipe.stage_frames(frames), chunk=13)
        ates.append(float(ate_rmse(traj[:, :3, 3], seq.gt_positions())))
        print(json.dumps({"world": "bench.py: CameraRig() 376x1241, 40 frames, seed 0",
                          "detector": "topk", "ransac_seed": seed, "ate_m": ates[-1]}), flush=True)
    print(json.dumps({"detector": "topk", "seeds": list(seeds), "ate_m": ates,
                      "median_ate_m": float(np.median(ates))}))


def dump_draws(seeds, out_dir: str) -> None:
    """The stereo sampler's Gumbel noise of every step, as index orders."""
    from uasl_motion_estimation_tpu.models.pipeline import default_config

    rig = CameraRig()
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    n_steps, n_ransac, n = 39, cfg.vo.n_ransac, cfg.max_features

    @jax.jit
    def orders(key):
        g = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jax.random.split(key, n_ransac))
        return jnp.argsort(-g, axis=-1, stable=True)

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    for seed in seeds:
        base = jax.random.key(seed)
        o = np.stack([np.asarray(orders(jax.random.fold_in(base, i))) for i in range(n_steps)])
        path = Path(out_dir) / f"topk_draws_seed{seed}.npy"
        np.save(path, o.astype(np.uint16))
        print(json.dumps({"seed": seed, "draws": str(path), "shape": list(o.shape)}), flush=True)


def per_frame(frames, gt, cfg, seed: int) -> dict:
    """The per-frame loop's ATE and successful steps."""
    from uasl_motion_estimation_tpu.models.mono_pipeline import MonoOdometryPipeline
    from uasl_motion_estimation_tpu.utils.metrics import MetricsLogger

    log = MetricsLogger()
    traj = MonoOdometryPipeline(cfg, seed=seed, initial_speed=INITIAL_SPEED, logger=log).run(frames)
    return {"ate_m": float(ate_rmse(traj[:, :3, 3], gt)),
            "n_success": sum(bool(r.get("success")) for r in log.records)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=13)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--solvers", nargs="+", default=["pencil8", "5point", "hybrid"])
    ap.add_argument("--hybrid-ratio", type=float, default=0.45)
    ap.add_argument("--per-frame", action="store_true")
    ap.add_argument("--stereo-topk", action="store_true")
    ap.add_argument("--dump-draws", metavar="DIR")
    args = ap.parse_args()
    if args.stereo_topk:
        if args.dump_draws:
            dump_draws(args.seeds, args.dump_draws)
        else:
            stereo_topk(args.seeds)
        return 0

    rig = CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                    height=480, width=752)
    seq = SyntheticStereoSequence(n_frames=args.frames, rig=rig, seed=3)
    frames = [seq.frame(i)[0] for i in range(args.frames)]
    gt = seq.gt_positions()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    for solver in args.solvers:
        cfg = MonoPipelineConfig(vo=MonoVOParams(intr=intr, inlier_threshold=2.0, solver=solver,
                                                 hybrid_ratio=args.hybrid_ratio),
                                 max_features=256)
        rows = []
        for seed in args.seeds:
            if args.per_frame:
                rows.append({"engine": "per_frame", "solver": solver, "ransac_seed": seed,
                             **per_frame(frames, gt, cfg, seed)})
                print(json.dumps(rows[-1]), flush=True)
                continue
            t0 = time.perf_counter()
            traj = run_mono_staged(frames, cfg, seed=seed, initial_speed=INITIAL_SPEED,
                                   chunk=CHUNK)
            seconds = time.perf_counter() - t0
            rows.append({
                "world": f"bench_mono: {rig.height}x{rig.width}, {args.frames} frames, seed 3",
                "solver": solver, "hybrid_ratio": args.hybrid_ratio, "ransac_seed": seed,
                "chunk": CHUNK,
                "n_steps": args.frames - 1,
                "ate_m": float(ate_rmse(traj[:, :3, 3], gt)),
                **scan_figures(frames, cfg, seed),
                "seconds_cpu": seconds,
            })
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps({"solver": solver, "seeds": args.seeds,
                          "ate_m": [r["ate_m"] for r in rows],
                          "median_ate_m": float(np.median([r["ate_m"] for r in rows])),
                          "n_success": [r["n_success"] for r in rows],
                          "escalated": [r.get("escalated") for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
