"""The integrated VO+BA engine on the JAX package's config 2 (the EuRoC-like
480x752 stereo world of ``benchmarks/extra_configs.py:33-106``), solved with
the JAX reference's RANSAC draws: does the port read JAX's ATE seed for seed?

    JAX_PLATFORMS=cpu python3 tools/jax_configs_reference.py --blocks config2 \
        --dump-draws tools/jax_draws
    python3 tools/north_star_witness.py [--device cuda] [--seeds 0 1 2] [--draws DIR]

On config 2's world (17 frames, world seed 1, ``default_config`` with 64
disparities), ``unified_system_scan(..., wchunk=4)`` composed, the engine's
``sampler`` takes JAX's draws (``chip_smoke.DrawsSampler``: the first 3 valid
rows of the dumped order for each motion and hypothesis). It prints, per
RANSAC seed, the port's ATE of the VO chain and after BA beside JAX's
(``chip_smoke.JAX_EUROC``, from ``tools/jax_configs_reference.py`` on the
CPU), then one JSON line with the largest difference. ``--device cpu`` runs
the plain kernel versions (about 1 min a seed).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(chip_smoke.EUROC_WITNESS_SEEDS))
    ap.add_argument("--draws", default=chip_smoke.DRAWS_DIR,
                    help="directory of unified_euroc_draws_seed{seed}.npy")
    args = ap.parse_args()
    chip_smoke.DRAWS_DIR = args.draws
    dev = torch.device(args.device)
    if dev.type == "cuda":
        chip_smoke.build_kernels()
    rows = chip_smoke.euroc_witness(dev, args.seeds, check=dev.type == "cuda")
    for r in rows:
        print(json.dumps(r), flush=True)
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    print(json.dumps({"card": card, "seeds": args.seeds,
                      "max_abs_diff_m": max(max(abs(r["diff_vo_m"]), abs(r["diff_ba_m"]))
                                            for r in rows),
                      "deepest_pick": max(r["deepest_pick"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
