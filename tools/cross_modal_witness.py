"""The staged cross-modal session solved with the JAX reference's RANSAC
draws: does the port read JAX's ATE seed for seed?

    JAX_PLATFORMS=cpu python3 tools/jax_cross_modal_reference.py \
        --seeds 0 1 2 3 4 --dump-draws tools/jax_draws
    python3 tools/cross_modal_witness.py [--devices cuda [cpu]] [--seeds 0 1 2 3 4]
        [--draws DIR] [--no-check]

The port draws its RANSAC samples from torch generators keyed on (seed,
step), so on its own it cannot reproduce JAX's trajectory for one seed;
``chip_smoke.py`` holds it to JAX's medians over seeds. Here the session's
``sampler`` takes JAX's draws instead (``chip_smoke.DrawsSampler``: for
each step and hypothesis the first 8 valid slots of the dumped order,
which is what JAX's Gumbel-top-8 picks on the same valid mask). On
``chip_smoke.py``'s cross-modal world (``CameraRig()`` 376x1241, 40
frames, seed 0, the right images in the second modality,
``CrossModalConfig`` at its defaults, chunk 13) it prints, per seed, the
port's ATE and scale error with JAX's draws beside JAX's
(``chip_smoke.JAX_CROSS_MODAL``, from ``tools/jax_cross_modal_reference.py``
on the CPU), the deepest slot a pick reached in the dumped orders, then
one JSON line with the largest difference. With the card (the default)
every K2 and K1 call is held to its plain version, as ``chip_smoke.py``'s
``witness`` phase does; ``--no-check`` skips that. On the CPU the world is
full size: it takes about a minute a seed with 8 threads.

``--devices cuda cpu`` runs each seed on both, on the same draws, and
prints, per step, how far the second run lies from the first: the
relative motion's rotation (largest entry) and translation direction,
the relative scale and MI initial scale differences, the inliers and the
scale LM's stop of each; and the first step where each of those parts. That bisects a
difference by stage: the mono solve (rotation, translation, inliers) or
the MI scale (scale, initial scale, stop) on equal motions.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import synthetic  # noqa: E402


def steps(row) -> dict:
    """Per-step figures of one witness run: relative rotations, translation
    directions (the metric translation over its norm, so that a scale
    difference does not show here), scales, MI initial scales, inliers and
    scale-LM stops."""
    T = row["trajectory"]
    motions = np.linalg.inv(T[1:]) @ T[:-1]
    rec = row["records"]
    t = motions[:, :3, 3]
    norm = np.linalg.norm(t, axis=1, keepdims=True)
    return {"R": motions[:, :3, :3], "t": np.divide(t, norm, out=np.zeros_like(t), where=norm > 0),
            "scale": np.array([r["scale"] for r in rec]), "s0": np.array([r["s0"] for r in rec]),
            "inliers": [r["n_inliers"] for r in rec], "stop": [r["lm_stop"] for r in rec]}


def compare(a: dict, b: dict) -> dict:
    """How far run b lies from run a, step by step, and the first step
    where each figure parts (rotation and translation direction 1e-5,
    relative scales 1e-4, inliers or stops unequal)."""
    d = {"rotation": np.abs(a["R"] - b["R"]).max(axis=(1, 2)),
         "direction": np.abs(a["t"] - b["t"]).max(axis=1),
         "scale_rel": np.abs(a["scale"] - b["scale"]) / np.abs(a["scale"]),
         "s0_rel": np.abs(a["s0"] - b["s0"]) / np.abs(a["s0"])}
    parted = {k: v > tol for (k, v), tol in zip(d.items(), (1e-5, 1e-5, 1e-4, 1e-4))}
    parted["inliers"] = np.array(a["inliers"]) != np.array(b["inliers"])
    parted["stop"] = np.array(a["stop"]) != np.array(b["stop"])
    return {"per_step": {k: v.tolist() for k, v in d.items()},
            "inliers": list(zip(a["inliers"], b["inliers"])),
            "stop": list(zip(a["stop"], b["stop"])),
            "first_parted": {k: int(np.argmax(v)) if v.any() else None
                             for k, v in parted.items()}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cuda"])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(chip_smoke.CM_SEEDS))
    ap.add_argument("--draws", default=chip_smoke.DRAWS_DIR,
                    help="directory of cross_modal_draws_seed{seed}.npy")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    chip_smoke.DRAWS_DIR = args.draws
    torch.set_num_threads(8)
    devs = [torch.device(d) for d in args.devices]
    if any(d.type == "cuda" for d in devs):
        chip_smoke.build_kernels()
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=chip_smoke.N_FRAMES, rig=rig, seed=0,
                                            cross_modal=True)
    frames = [seq.frame(i) for i in range(chip_smoke.N_FRAMES)]
    runs = {}
    for dev in devs:
        staged = tuple(torch.from_numpy(np.clip(np.stack([f[k] for f in frames]), 0, 255)
                                        .astype(np.uint8)).to(dev) for k in (0, 1))
        runs[str(dev)] = rows = chip_smoke.cross_modal_witness(
            dev, rig, staged, seq.gt_positions(), args.seeds,
            check=dev.type == "cuda" and not args.no_check)
        for r in rows:
            print(json.dumps({"device": str(dev), **{k: v for k, v in r.items()
                                                     if k not in ("records", "trajectory")}}),
                  flush=True)
    if len(devs) == 2:
        (na, a), (nb, b) = runs.items()
        for ra, rb in zip(a, b, strict=True):
            print(json.dumps({"seed": ra["seed"], "devices": [na, nb],
                              "ate_m": [ra["ate_m"], rb["ate_m"]],
                              **compare(steps(ra), steps(rb))}), flush=True)
    card = chip_smoke.card_line() if any(d.type == "cuda" for d in devs) else "cpu"
    print(json.dumps({"card": card, "seeds": args.seeds, **{
        f"max_abs_diff_m_{name}": max(abs(r["diff_m"]) for r in rows)
        for name, rows in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
