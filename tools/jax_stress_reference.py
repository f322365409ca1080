"""JAX reference figures for the five stress worlds of ``benchmarks/stress_worlds.py``.

Runs the JAX package on the CPU on exactly the worlds and configurations of
``benchmarks/stress_worlds.py`` (``stress_r05.json``): the 192x320 rig, 30
frames, world seed 7; turn_5deg and turn_10deg (a 90-degree corner at 5 and
10 deg/frame in the widened hall), near_stop, pure_rotation and low_texture;
``default_config(...)._replace(max_features=256)``, and for turn_10deg the
stress KLT profile (5 pyramid levels, 14 and 6 iterations, tile margin 7,
150 px displacement). Each regime runs staged VO (``run_staged(chunk=8)``)
and the unified VO+BA engine (``run_unified_system``), turn_10deg staged
also on the default profile, for each RANSAC seed. ``stress_worlds.py``
itself runs staged VO with seed 0 and the unified engine with seed 1; here
both take the seed of the row. It prints one JSON line per regime and
seed, then one line per regime with the medians over the seeds, and the
gates (``stress_worlds.py:102-108``: VO ATE under the regime's gate, the
unified engine's ATE after BA under 1.5x it).

    JAX_PLATFORMS=cpu python3 tools/jax_stress_reference.py [--seeds 0 1 2 3 4 5]
        [--regimes turn_10deg ...] [--dump-draws DIR]

``--dump-draws DIR`` writes, per seed, the RANSAC draws of turn_10deg's
unified run (motion i keyed ``fold_in(key(seed), i)``, split into one key
per hypothesis, one Gumbel vector over the track table's 256 rows each) as
index orders: ``DIR/unified_turn10_draws_seed{seed}.npy``, (29 motions, 200
hypotheses, N) uint8, each row the table rows by descending Gumbel noise,
the first N = 128 of them (``KEEP``). The first 3 valid rows of an order
are the triple JAX samples on that valid mask; ``tools/unified_witness.py``
runs the port with them.
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

from uasl_motion_estimation_tpu.models.frontend import KLTConfig  # noqa: E402
from uasl_motion_estimation_tpu.models.pipeline import (  # noqa: E402
    OdometryPipeline, default_config)
from uasl_motion_estimation_tpu.models.smoother import (  # noqa: E402
    SmootherConfig, run_unified_system)
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics  # noqa: E402
from uasl_motion_estimation_tpu.utils.metrics import ate_rmse  # noqa: E402
from uasl_motion_estimation_tpu.utils.synthetic import (  # noqa: E402
    CameraRig, SyntheticStereoSequence, stress_trajectory)

N = 30  # frames, as stress_worlds.py
CHUNK = 8  # its staged chunk
KEEP = 128  # slots kept of each dumped order: the port's picks reach slot 107 at most
REGIMES = ("turn_5deg", "turn_10deg", "near_stop", "pure_rotation", "low_texture")
GATES = {"turn_5deg": 0.15, "turn_10deg": 0.60, "near_stop": 0.08, "pure_rotation": 0.08,
         "low_texture": 0.12}  # stress_worlds.py:102-108


def world(kind: str) -> SyntheticStereoSequence:
    """stress_worlds.py's world of one regime."""
    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54, height=192,
                    width=320)
    if kind == "low_texture":
        return SyntheticStereoSequence(n_frames=N, rig=rig, seed=7,
                                       low_texture_band=(12.0, 22.0))
    if kind.startswith("turn_"):
        rate = float(kind.split("_")[1].rstrip("deg"))
        return SyntheticStereoSequence(n_frames=N, rig=rig, seed=7, hall_half_width=45.0,
                                       trajectory=stress_trajectory("sharp_turn", N,
                                                                    turn_rate_deg=rate))
    return SyntheticStereoSequence(n_frames=N, rig=rig, seed=7,
                                   trajectory=stress_trajectory(kind, N))


def configs():
    """(the default configuration, the stress KLT profile), as stress_worlds.py."""
    rig = world("near_stop").rig
    base = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                          rig.baseline)._replace(max_features=256)
    stress = base._replace(klt=KLTConfig(n_levels=5, iters=14, iters_coarse=6, tile_margin=7,
                                         max_displacement=150.0))
    return base, stress


def fold_in_orders(seed: int, n_steps: int, n_ransac: int, n_slots: int) -> np.ndarray:
    """(n_steps, n_ransac, n_slots) slot orders by descending Gumbel noise:
    step i keyed ``fold_in(key(seed), i)`` and split into one key per
    hypothesis, as the staged engines key their RANSAC draws
    (``stereo_vo._sample_hypotheses``, ``mono_vo._mono_vo_impl``)."""

    @jax.jit
    def orders(key):
        g = jax.vmap(lambda k: jax.random.gumbel(k, (n_slots,)))(jax.random.split(key, n_ransac))
        return jnp.argsort(-g, axis=-1, stable=True)

    base = jax.random.key(seed)
    return np.stack([np.asarray(orders(jax.random.fold_in(base, i))) for i in range(n_steps)])


def run_vo(frames, cfg, seed: int) -> np.ndarray:
    pipe = OdometryPipeline(cfg, seed=seed)
    ls, rs = pipe.stage_frames(frames)
    return pipe.run_staged(ls, rs, chunk=CHUNK)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--regimes", nargs="+", choices=REGIMES, default=list(REGIMES))
    ap.add_argument("--dump-draws", metavar="DIR")
    args = ap.parse_args()
    base, stress = configs()
    if args.dump_draws:
        Path(args.dump_draws).mkdir(parents=True, exist_ok=True)
        for seed in args.seeds:
            o = fold_in_orders(seed, N - 1, stress.vo.n_ransac, stress.max_features)
            o = o[..., :KEEP].astype(np.uint8)  # 256 rows: one byte each
            path = Path(args.dump_draws) / f"unified_turn10_draws_seed{seed}.npy"
            np.save(path, o)
            print(json.dumps({"seed": seed, "draws": str(path), "shape": list(o.shape)}),
                  flush=True)
    summary = {}
    for kind in args.regimes:
        seq = world(kind)
        frames = [seq.frame(i) for i in range(N)]
        gt = seq.gt_positions()
        cfg = stress if kind == "turn_10deg" else base
        rows = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            row = {"regime": kind, "ransac_seed": seed,
                   "profile": "stress" if kind == "turn_10deg" else "default",
                   "vo_ate_m": float(ate_rmse(run_vo(frames, cfg, seed)[:, :3, 3], gt))}
            if kind == "turn_10deg":
                row["vo_ate_default_cfg_m"] = float(ate_rmse(
                    run_vo(frames, base, seed)[:, :3, 3], gt))
            res = run_unified_system(frames, SmootherConfig(pipe=cfg), seed=seed)
            row.update(unified_ate_vo_m=float(ate_rmse(res.traj_vo[:, :3, 3], gt)),
                       unified_ate_ba_m=float(ate_rmse(res.traj_ba[:, :3, 3], gt)),
                       vo_success=int(np.sum(res.per_frame[:, 16] > 0.5)),
                       ba_converged=int(np.sum(res.ba_converged)),
                       n_windows=int(len(res.ba_converged)),
                       seconds_cpu=time.perf_counter() - t0)
            rows.append(row)
            print(json.dumps(row), flush=True)
        keys = [k for k in rows[0] if k.endswith("_m")]
        summary[kind] = {"seeds": args.seeds, "gate_ate_m": GATES[kind],
                         **{k: [r[k] for r in rows] for k in keys},
                         **{f"median_{k}": float(np.median([r[k] for r in rows])) for k in keys}}
        print(json.dumps({"regime": kind, **summary[kind]}), flush=True)
    print(json.dumps({"world": "benchmarks/stress_worlds.py: 192x320, 30 frames, seed 7",
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
