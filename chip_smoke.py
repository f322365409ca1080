"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. Fails at once without a CUDA card; prints the card's name and power limit.
2. Builds every CUDA kernel of the ported paths from ``csrc/``, one nvcc per
   source, all started together, and prints each build's ``-Xptxas -v``.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes its paths give it: the tile gather K1 exactly (it is a copy), the
   MI joint histogram K2 to 1e-5 absolute in both its modes (its counts are
   exact integers; only the final float32 sum rounds, in another order than
   the plain version's): pair mode (the scale LM) with sentinel ids, strip
   mode (the MI matcher) at 13 x 500 features x 128 disparities; K2 of
   identical patches to their entropy within 1e-4; and windowed BA's K3
   (kernels A and B) at config 4's 16 windows, with the LM's damping and
   with the covariances' regularisation, as close to the float64 chain as
   the float32 plain chain within ``BA_GAP_X`` (config 2's first BA group
   too, in the north-star phase, where every BA solve and covariance call
   must have launched K3: twice a trip, once a call).
4. Checks three small worlds against the port's CPU run (plain kernel
   versions) given the same RANSAC samples: stereo VO, the cross-modal
   metric-scale session, and the integrated VO+BA engine (2 windows).
5. Drives each path at full size, with every kernel's launch count set to 0
   just before and read just after; each kernel of the path must have
   launched:
   - staged stereo VO on ``bench.py``'s world (376x1241, 40 frames, seed 0,
     500 features, 128 disparities, 200 RANSAC hypotheses) through
     ``OdometryPipeline.run_staged(chunk=13)``: K1; ATE < 0.1 m;
   - the cross-modal session on the same world with its right images
     remapped to the second modality (what ``cross_modal=True`` renders),
     ``CrossModalConfig`` at its defaults, through
     ``run_cross_modal_staged(chunk=13)``: K1, K2 in strip mode (the
     matcher, once per chunk) and K2 in pair mode (the scale LM). Before it,
     on the first chunk of that world, the matcher's strip ids must equal
     the per-candidate patches' ids at every in-image candidate, and the
     matcher alone must launch K2 once, in strip mode. Run again with RANSAC
     seeds 1-4, its median figures over the five seeds are held to the JAX
     reference's over the same seeds (``tools/jax_cross_modal_reference.py``);
   - the integrated VO+BA engine (unified track table, windowed BA) through
     ``run_unified_system`` on the stereo world, SmootherConfig at its
     defaults (window 5, ba_rate 4, 25 BA iterations), 5 windows per group:
     K1; every window's BA converged, ATE after BA below the VO chain's and
     below 0.1 m (seed 0), and the median ATE after BA over RANSAC seeds 0-2
     within 1.5x the JAX reference's (``tools/jax_unified_reference.py``);
     then the same on the corrupted world of ``benchmarks/full_system.py``
     (seed 0): K1, convergence, ATE after BA below the VO chain's;
   - the streaming engines from host frames: ``run_streaming`` (chunk 13)
     and ``run_unified_streaming`` (super-chunks of one 5-window group): K1;
     each trajectory equal to its staged twin's to 1e-4 on the motions both
     solve with the same windows;
   - staged stereo VO with ``detector="topk"`` on the stereo world, RANSAC
     seeds 0-4: K1, all steps, the median ATE within 1.5x the JAX
     reference's (JAX's own median is 0.149 m, so the grid detector's 0.1 m
     bound does not apply); the
     per-frame cross-modal loop ``run_cross_modal``
     on the cross-modal world, once: K1 and K2, all 39 steps, median scale
     error under 2 %;
   - the monocular engine on ``benchmarks/extra_configs.py``'s bench_mono
     world (480x752, 13 frames, seed 3, left camera, 256 top-k features,
     2 px threshold, initial speed 0.8): ``run_mono_staged`` (chunk 8) with
     ``pencil8``, ``5point`` and ``hybrid``, the hybrid again with every
     step escalated (``FORCED_RATIO``), and the per-frame
     ``MonoOdometryPipeline`` with ``pencil8``: K1 in each, every K1 call
     held to its plain version; all 12 steps succeed and each ATE lies
     within ``MONO_ATE_TOL`` of the JAX reference's on the same run
     (``tools/jax_mono_reference.py``; on this world it does not depend on
     the RANSAC seed). Then the exact 5-point at the
     path's shape (8 steps x 200 samples) on the card against its CPU run
     on the same nullspace basis, each held to the float64 solution of
     that basis (its float32 roots are noisy there), with the solve's time
     per chunk and the SVD's time, kernels and stream syncs;
   - the latency mode (``OdometrySystem``: persistent track table, per-frame
     VO, windowed BA every 5 keyframes) on the stereo world from host
     frames, ``OdometryConfig`` at its defaults, VO only and with BA, RANSAC
     seeds 0-2: K1 ``K1_PER_LATENCY_RUN`` times a run (batch 1), every call
     held to plain; each run at least JAX's steps less one, each mode's
     median ATE within 1.5x JAX's on the CPU (``tools/jax_latency_reference.py``)
     and BA's below 0.95x VO's; then frames/s (3 timed runs after those),
     stream syncs per frame, kernels, device time and K1's time per run;
   - the parallax gate on the near_stop world (18 frames at 376x1241,
     ``parallax=2.0`` against 0): at most 14 keyframes, the gated ATE below
     max(1.2x the ungated, 0.05 m); a checkpoint on the card after 20
     frames, resumed in a fresh system: the same keyframes, every pose
     within 1e-5 m of the uninterrupted run;
   - Grunert P3P on 200 random scenes on the card (>= 95 % recovered), and
     staged stereo with ``hyp_solver="p3p"``, seeds 0-2 (all steps, median
     ATE within 1.5x JAX's); the staged cross-modal session with the
     5-point solver, seed 0 (JAX's steps less one, median scale error
     within 1.5x JAX's);
   - the stress worlds of ``benchmarks/stress_worlds.py`` (192x320, 30
     frames: turn_5deg, turn_10deg, near_stop, pure_rotation, low_texture),
     each staged (seed 0) and unified (seed 1) under that benchmark's gates;
     turn_10deg on the stress KLT profile (5 levels, a 26x26 tile), staged
     also on the default profile, and unified for RANSAC seeds 0-29, the
     median after BA within 1.5x JAX's over the same seeds
     (``JAX_STRESS``); every K1 call held to plain, and K1 cold at 26x26
     beside 22x22 at each of the 5 levels;
   - the long sequence of ``benchmarks/long_sequence.py`` (501 frames of the
     KITTI-size corrupted world, 400 m): the unified engine staged for seeds
     0-2 and streaming for seed 0; every window converged, BA below VO,
     streaming equal to staged within 1e-4 m, the median ATE within 1.5x
     JAX's (``JAX_LONG``), the streaming run's peak device memory at 501
     frames within 10 % of that at 121 frames, K1 launched as often as the
     code says; per-window agreement with JAX's outputs printed;
   - the witnesses on JAX's RANSAC draws (``tools/jax_draws``): the
     cross-modal session (seeds 0-4, every K2 call within 1e-5 of plain)
     and the unified engine on turn_10deg (seeds 0-5, within 5 mm of
     JAX's ATE);
   - the JAX package's remaining published configurations
     (``north_star_configs``, JAX's figures from
     ``tools/jax_configs_reference.py`` on the CPU): config 2 of
     ``benchmarks/extra_configs.py`` (EuRoC-like 480x752 stereo, 17 frames,
     64 disparities, so a 11x74 ZNCC strip off K1's templates): staged VO
     and the integrated engine over RANSAC seeds 0-4, every motion and
     window, medians within 1.5x JAX's and BA's below VO's, the integrated
     engine on JAX's draws (seeds 0-2) within 5 mm of JAX's ATE, frames/s
     and K1 at the strip timed cold; config 3, the MI matcher's precision,
     recall, median error and valid matches against JAX's and the bad-init
     scale recoveries (every K2 call within 1e-5 of plain); config 4, 16
     windows of 10 frames in one batched BA, each window against JAX's
     ``vmap``; and ``benchmarks/cov_circuit.py``'s covariance calibration on
     the corrupted world (seed 1); every K1 call held to plain;
   - the parallel layer (``parallel/``): every sharded entry point in 4
     gloo ranks that share the card (``run_ranks``; the kernels built here
     first), each rank's front-end under ``GatherShim(check=True)``, held
     to JAX's gates against single-process twins (``parallel_phase``); then
     in one NCCL rank in this process, within 1e-5 of the same computation
     in one process; then ``examples/run_synthetic_torch.run`` at its
     default size (ATE < 0.1 m). Every wall time of the 4 ranks is of ranks
     sharing one card, not a scaling figure.
6. Times each path's frames/s (median of 3 after the measured run; the
   streaming engines end to end, with their in-run upload figures; the
   mono engines with K1's device time per run), counts its stream syncs (the stereo and cross-modal figures beside those from
   before the port cached its small constants), and times each kernel (K2
   in each mode) against its plain version beside the least time the card
   could take.
7. K1 in detail: its device time summed over the launches of one staged
   stereo run and of one integrated run (``torch.profiler``), and at every
   main-path tile shape and pyramid level, on the anchors the stereo path
   gives it on its first chunk
   (recorded by a stand-in for ``ops/image.py``'s ``gather_tiles``) and on
   uniform random anchors: cold (the L2 flushed before each launch; median
   of 30, between CUDA events, and the kernel's own duration by the
   profiler), warm (back to back), against its plain version
   and ``grid_sample`` (the library yardstick, which the port never calls;
   both must equal K1 exactly), and against the bytes those anchors need:
   the distinct image pixels their tiles cover, the anchors and the tiles.

Prints each phase's seconds, the paths' JSON line (frames/s, accuracy,
syncs, uploads), the kernels' JSON line and, last, ``{"ok": true,
"device": {...}}``.
Any failed phase ends the run with a non-zero exit code.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

N_FRAMES = 40
CHUNK = 13
N_FEATURES = 500
N_DISP = 128
SHAPES = {  # main-path K1 tile shapes (tile_h, tile_w) -> where they come from
    (11, 138): "ZNCC strip, full disparity range",
    (11, 34): "ZNCC strip with disparity prior",
    (11, 11): "ZNCC template",
    (14, 18): "stereo refine tile",
    (12, 12): "refine template (extract_patches_sep r=5)",
    (14, 14): "KLT template (extract_patches_sep r=6)",
    (22, 22): "KLT tile",
}
LEVELS = [(376, 1241), (188, 621), (94, 311), (47, 156)]  # KLT pyramid
# K1 calls per chunk of the stereo path: match_stereo twice (strip, template,
# refine template and tile), KLT's template and tile at each of 4 levels
K1_PER_CHUNK = 16
# K1 calls per group of windows of the integrated path: the birth frame's
# match_stereo (4), then at each of the window's 4 later frames KLT's
# template and tile at 4 levels (8) and the prior-guided match_stereo (4)
K1_PER_GROUP = 4 + 4 * (8 + 4)
K1_KERNEL = "gather_tiles_kernel"  # the CUDA kernel's name, as the profiler shows it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FLUSH_BYTES = 256 << 20  # written before each cold launch: five times the 50 MB L2
COLD_REPS = 30
# device spins before timed launches (~0.5 ms and ~10 ms at 1.98 GHz), so
# that the host has enqueued the launch, or all the back-to-back launches,
# before the start event fires, and the events time the device alone
SLEEP_CYCLES = 1_000_000
QUEUE_CYCLES = 20_000_000
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
K2_TOL = 1e-5
# identical patches against the one-hot entropy, whose float32 terms round
# elsewhere: the JAX kernel test's tolerance (tests/test_pallas_mi.py)
ENTROPY_TOL = 1e-4
# JAX reference on the full-size cross-modal world, RANSAC seeds 0-4
# (tools/jax_cross_modal_reference.py --seeds 0 1 2 3 4, run on the CPU): all
# 39 steps succeeded for every seed. The port cannot draw JAX's samples, and
# the session's last steps are sensitive to them, so the port's figures over
# the same seeds are held to JAX's medians over them.
CM_SEEDS = (0, 1, 2, 3, 4)
JAX_CROSS_MODAL = {
    "n_success": 39,
    "scale_err_median": [0.009031951427458947, 0.010752588510512948, 0.007983058691024423,
                         0.0097925812006, 0.008951634168624933],
    "ate_m": [0.05914038608939326, 0.06557040163106549, 0.06372868671084349,
              0.08654515144921493, 0.060980997817120096],
}

# JAX reference of the integrated VO+BA engine on the full-size clean world,
# RANSAC seeds 0-2 (tools/jax_unified_reference.py --seeds 0 1 2, on the
# CPU): every window converged and all 39 motions succeeded for each seed.
# The port's median ATE after BA over the same seeds is held to 1.5 x JAX's.
UNIFIED_SEEDS = (0, 1, 2)
UNIFIED_WCHUNK = 5  # windows per group, as bench.py runs the engine
K1_PATH_BATCHES = (CHUNK, UNIFIED_WCHUNK)  # K1's batches on the paths, held to plain
JAX_UNIFIED = {
    "ate_vo_m": [0.0438190430152971, 0.0426815084665558, 0.03843599574897943],
    "ate_ba_m": [0.0219930274530603, 0.020904141061700937, 0.015133228675659357],
}
# the same tool with --corrupted (seed 0 is the world's gate here)
JAX_UNIFIED_CORRUPTED = {
    "ate_vo_m": [0.0602889118883468, 0.08091579595276924, 0.12374846152642437],
    "ate_ba_m": [0.044318377606174464, 0.05921712774745177, 0.16269734604409916],
}
# stream syncs per run while the port still uploaded its small constants on
# every call (PERF.md section 5; H100 80GB HBM3, 700 W)
SYNCS_BEFORE = {"stereo": "87-88", "cross_modal": "235"}
# run_unified_streaming's super-chunks: one group of 5 windows, advance 20
# frames; on 40 frames its windows cover motions 0-34 as the staged scan's do
STREAM_GROUPS = 1
UNIFIED_SHARED_FRAMES = 36

# the monocular engine on benchmarks/extra_configs.py's bench_mono world:
# 480x752, 13 frames, seed 3, left camera, 256 top-k features, chunk 8
MONO_FRAMES = 13
MONO_CHUNK = 8
MONO_FEATURES = 256
MONO_SPEED = 0.8  # initial_speed: the first motion's translation norm
MONO_SOLVERS = ("pencil8", "5point", "hybrid")
MONO_LEVELS = [(480, 752), (240, 376), (120, 188), (60, 94)]  # its KLT pyramid
KLT_SHAPES = [(14, 14), (22, 22)]  # the only K1 tiles of the mono path
# K1's batches there: chunks of 8 and the last of 4 steps; 1 per frame
MONO_BATCHES = (MONO_CHUNK, (MONO_FRAMES - 1) % MONO_CHUNK, 1)
# hybrid_ratio that escalates every step: on this world every valid match is
# an inlier, so 1.0 (n_inliers < ratio * n_valid) would escalate none
FORCED_RATIO = 1.5
# JAX reference of each mono run on the same world (tools/jax_mono_reference.py,
# on the CPU). Staged, RANSAC seeds 0-4 (--seeds 0 1 2 3 4): all 12 steps
# succeeded for every solver and seed, no step escalated, and every valid
# match was an inlier, so the ATE did not depend on the seed. The forced
# escalation (--solvers hybrid --hybrid-ratio 1.5 --seeds 0): all 12 steps
# escalated, none replaced, the same ATE. The per-frame loop (--per-frame
# --solvers pencil8 --seeds 0), on the unquantised frames: 12 steps, its own
# ATE. So each run of the port is held to JAX's figure within MONO_ATE_TOL
# (the port's staged runs read 1.7e-4 m from it, its per-frame 3.1e-4 m, on
# the H100). Since every match is an inlier, this world never exercises
# RANSAC: the 5-point is held on the card by mono_fivepoint.
JAX_MONO_STEPS = 12
JAX_MONO_ATE = {"pencil8": 0.16299153638403446, "5point": 0.16299153638403446,
                "hybrid": 0.16299153638403446, "hybrid_forced": 0.16299153638403446,
                "per_frame_pencil8": 0.1174152754038824}
MONO_ATE_TOL = 1e-3  # m
# the five-point on the card against its CPU run on the same basis. Its
# float32 roots are noisy where det M(z) is near zero at a grid node (more
# so on the path's samples than on random scenes: on the CPU, float32
# against float64 on one chunk's samples finds only ~50 % of the
# candidates within 1e-3), so each run is held to the float64 solution of
# the same basis: the card must find it as well as the CPU does, within
# FIVEPOINT_SLACK, and meet the epipolar contract as often
FIVEPOINT_SLACK = 0.05
# JAX reference of staged stereo VO with the top-k detector on the stereo
# world, RANSAC seeds 0-4 (tools/jax_mono_reference.py --stereo-topk --seeds
# 0 1 2 3 4, on the CPU): its ATE, 0.108-0.197 m, is far above the grid
# detector's on the same world (0.0379 m, BENCH_r05.json), so a 0.1 m bound
# would fail the reference itself. The port's median over the same seeds is held to 1.5 x
# JAX's.
TOPK_SEEDS = (0, 1, 2, 3, 4)
JAX_TOPK = {"ate_m": [0.14897930153217467, 0.19743871820214268, 0.10794871517741095,
                      0.1599980819142645, 0.1135857873009703]}
# The latency mode (OdometrySystem, OdometryConfig at its defaults) on the
# stereo world, RANSAC seeds 0-2, VO only and with BA, and the staged stereo
# engine with hyp_solver="p3p" on the same seeds: the JAX reference's ATE on
# the CPU (tools/jax_latency_reference.py --seeds 0 1 2 --p3p; every JAX run
# solved all 39 steps). The port's medians are held to 1.5 x JAX's.
LATENCY_SEEDS = (0, 1, 2)
JAX_LATENCY = {"vo": [0.022987659193966024, 0.01876230733284683, 0.021238667183053075],
               "ba": [0.01388040293514645, 0.012180455423105621, 0.012049889755797656],
               "n_success": 39,
               "p3p": [0.03805004251701376, 0.03718505572428405, 0.030034786751669644]}
# K1 calls of a latency run: bootstrap_frame's match_stereo (4), then per
# frame KLT's template and tile at 4 levels (8) and two match_stereo (8)
K1_PER_LATENCY_RUN = 4 + (N_FRAMES - 1) * 16
PARALLAX_FRAMES = 18  # the near_stop world of tests/test_odometry.py:59-85, at full size
CKPT_AT = 20  # frames before the checkpoint of the resume phase
P3P_SCENES = 200
# the staged cross-modal session with MonoVOParams(solver="5point") on the
# cross-modal world, RANSAC seed 0: JAX on the CPU
# (tools/jax_cross_modal_reference.py --seeds 0 --solver 5point)
JAX_CM_5POINT = {"n_success": 39, "scale_err_median": 0.00929018855094874,
                 "ate_m": 0.20533835538727596}
# The parallel phase (parallel/): 4 gloo ranks sharing the card, then one
# NCCL rank in this process. Sharded VO on bench.py's world with 41 frames
# (40 pairs, 10 a rank); the sharded unified engine on its first 40 frames
# (10 windows padded to 12, 3 a rank); window-parallel BA on 8 windows of 5
# frames overlapping by n_fixed = 2, 500 points, 2 windows a rank, 8 sweeps;
# stitching of 4 segments of 12 frames overlapping by 3 (the first 39
# poses). The gates are JAX's own (__graft_entry__.py, tests/test_parallel*.py)
PAR_RANKS = 4
PAR_PAIRS = 40
BA_WINDOWS, BA_WINDOW, BA_FIXED, BA_POINTS, BA_SWEEPS = 8, 5, 2, 500, 8
STITCH_SEGMENTS, STITCH_OVERLAP = 4, 3
PAR_GATES = {"vo_pose_m": 1e-3, "vo_ate_m": 0.1, "chain": 1e-4, "stitch": 1e-3, "halo": 5e-4,
             "ba_truth": 5e-3, "vo_motions": 1e-3, "refined_motions": 1e-2, "traj_ba_m": 1e-3}
NCCL_TOL = 1e-5  # one NCCL rank against the same computation in one process
PAR_UNIFIED_WINDOWS = 10  # unified_window_starts(40, 5, 4)
# K1's batches in the ranks: the sharded VO's 10 pairs (40 on the NCCL rank)
# and the unified engine's group of 3 windows (10 on the NCCL rank)
PAR_K1_BATCHES = tuple(sorted({PAR_PAIRS // PAR_RANKS, -(-PAR_UNIFIED_WINDOWS // PAR_RANKS),
                               PAR_PAIRS, PAR_UNIFIED_WINDOWS}))
# collectives a rank issues in parallel_rank, by world size: an all_gather in
# each of the chain, the VO's chain and the unified engine, each run twice;
# a send/receive per BA sweep, twice (none on one rank)
RANK_COLLECTIVES = {n: {"all_gather": 6, "p2p": 2 * BA_SWEEPS if n > 1 else 0}
                    for n in (1, PAR_RANKS)}
EXAMPLE_FRAMES = 20  # examples/run_synthetic_torch.py's default size
EXAMPLE_ATE_M = 0.1
# The stress worlds of benchmarks/stress_worlds.py (stress_r05.json): the
# 192x320 rig, 30 frames, world seed 7, 256 features; each regime through
# staged VO (chunk 8, RANSAC seed 0) and the unified engine (seed 1), as that
# benchmark runs them; turn_10deg on the stress KLT profile, staged also on
# the default one, and unified for RANSAC seeds 0-29. Its gates
# (stress_worlds.py:102-108): VO ATE under the regime's gate, the unified
# engine's ATE after BA under 1.5x it. turn_10deg's unified ATE spans
# 0.07-0.69 m over seeds on either side (a few hypotheses decide each turn
# motion), so a median over 6 seeds is a draw of the seeds: JAX's over
# seeds 0-5 is 0.146 m and over 0-29 0.225 m; the port's on the card
# 0.347 m and 0.179 m. Given JAX's own draws, the port reads JAX's ATE on
# every seed within 0.01 mm (``unified_witness``). So the median is held
# over seeds 0-29, and seeds 0-5 are printed beside JAX's.
STRESS_FRAMES = 30
STRESS_CHUNK = 8
STRESS_WCHUNK = 4  # run_unified_system's default, as stress_worlds.py calls it
STRESS_REGIMES = ("turn_5deg", "turn_10deg", "near_stop", "pure_rotation", "low_texture")
STRESS_GATES = {"turn_5deg": 0.15, "turn_10deg": 0.60, "near_stop": 0.08, "pure_rotation": 0.08,
                "low_texture": 0.12}
STRESS_SEEDS = tuple(range(30))  # the unified turn_10deg run's
STRESS_PRINTED = 6  # seeds 0-5 (the seeds stress figures were first held over), printed
WITNESS_SEEDS = (0, 1, 2, 3, 4, 5)  # the unified turn_10deg witness's, on JAX's dumped draws
WITNESS_TOL = 5e-3  # m: the port on JAX's draws against JAX's ATE, per seed
STRESS_LEVELS = [(192, 320), (96, 160), (48, 80), (24, 40), (12, 20)]  # 5-level pyramid
STRESS_TILE = (26, 26)  # the stress profile's KLT tile: 11 + 2 * 7 + 1, no template of K1
# K1's batches there: staged chunks of 8 and the last of 5 steps; unified
# groups of 4 windows (8 windows)
STRESS_BATCHES = (STRESS_CHUNK, (STRESS_FRAMES - 1) % STRESS_CHUNK, STRESS_WCHUNK)
# JAX on the CPU on the same worlds (tools/jax_stress_reference.py, RANSAC
# seeds 0-5, and --regimes turn_10deg turn_5deg --seeds 0-29 for turn_10deg,
# staged and unified each with the row's seed): per regime, staged VO's ATE,
# the unified engine's VO and BA ATE (turn_10deg: the stress profile;
# vo_ate_default_cfg_m the default profile's staged VO)
JAX_STRESS = {
    "turn_5deg": {
        "vo_ate_m": [0.06495826840303542, 0.07019401249637064, 0.06278859413422787,
                     0.0776140540394408, 0.07019095674367991, 0.07097340381411973],
        "unified_ate_vo_m": [0.10205671783215074, 0.16464822219350578, 0.11684734530936884,
                             0.17889334917207908, 0.1442885521700904, 0.12704240021074445],
        "unified_ate_ba_m": [0.0372069224927946, 0.12035186978354155, 0.05601257214376207,
                             0.12107336570151445, 0.11602633958751464, 0.043542911921558965],
    },
    "turn_10deg": {
        "vo_ate_m": [0.4099505453475448, 0.33806322333618327, 0.528591631805273,
                     0.3428675601424021, 0.17439780402869146, 0.7167424016090983,
                     0.26679919937873264, 0.6767181439329851, 0.42731579071752934,
                     0.647149775056897, 0.14941379876456123, 0.3793831557636743,
                     1.4687296168009805, 0.15296253484884542, 0.06334265375914126,
                     0.7490780384764535, 0.24974483140455594, 0.35367119385798534,
                     0.36528029755611807, 0.695616363403307, 0.3486803041436038,
                     0.2201190234377579, 0.741707092065739, 0.21158892362915405,
                     0.7107416383578141, 0.12409797642686003, 0.1489617621499116,
                     0.09181432898200481, 0.34949479270892503, 0.561266937616038],
        "vo_ate_default_cfg_m": [1.391974232806374, 1.0032487976008124, 0.9112694332182014,
                                 1.1903480180242745, 0.48399226918848975, 1.064789776842117,
                                 1.4441818990552424, 2.468597041732474, 0.6765843683084042,
                                 0.8111688203604379, 0.7565119516067825, 0.9643801903807891,
                                 0.9629575780535299, 1.112201114667095, 1.2783205585128474,
                                 1.6022492086128288, 0.8136291289643445, 1.0253474149525652,
                                 1.4246127559277117, 1.0053219527631658, 0.9786663120458058,
                                 1.3944691460768701, 1.1396553489205083, 1.3266458466876172,
                                 0.8767126591789578, 0.12778852316501177, 1.309847506779829,
                                 0.9707890356808487, 1.428594813129268, 1.1280527353694565],
        "unified_ate_vo_m": [0.09073330405833654, 0.07716228451952761, 0.10778212646853777,
                             0.17844659337778265, 0.40505959172953915, 0.17876203092111725,
                             0.20023448746791486, 0.07844702215611932, 0.44744171393280296,
                             0.35870709116241645, 0.23510263400315362, 0.21739942015787267,
                             0.08646697570382546, 0.2554151232885876, 0.11826543795513529,
                             0.17428161825376132, 0.20398330777006138, 0.08648136786495635,
                             0.5473269379036253, 0.2974700247100222, 0.17980069062430895,
                             0.0759131791157879, 0.3040698448514267, 0.37241316689785314,
                             0.4255917389736289, 0.14572041461057358, 0.42203745689663086,
                             0.13641449438401324, 0.12840628131494186, 0.34321998503539963],
        "unified_ate_ba_m": [0.10126981946373101, 0.07951246552401225, 0.08552440147813305,
                             0.19108620378868893, 0.500478943105889, 0.1906725224514222,
                             0.2102456597157655, 0.1337334752826685, 0.4235533547829001,
                             0.3314277533113121, 0.19496538286690898, 0.3447095542737257,
                             0.10699596924149489, 0.222857690578771, 0.08999898960512036,
                             0.2274820377057304, 0.24291682402734038, 0.08048962726532399,
                             0.5719850232606464, 0.41114503502791755, 0.30136635449210947,
                             0.08074721154754645, 0.30168368126124784, 0.3750605581302634,
                             0.49259300076548185, 0.2307269772830797, 0.37203266294443865,
                             0.19037459039406837, 0.16353178266144958, 0.3648786484759891],
    },
    "near_stop": {
        "vo_ate_m": [0.021980147680459552, 0.024785314951247736, 0.024915489989056513,
                     0.026126817693715047, 0.02387528375745396, 0.023574001135663162],
        "unified_ate_vo_m": [0.02967929142612868, 0.04764769663015821, 0.03517600334496435,
                             0.05196299509717111, 0.0357477838504784, 0.058379450440380565],
        "unified_ate_ba_m": [0.04628567386526397, 0.04692065446897593, 0.04798159351234218,
                             0.05427808295161293, 0.04111638238267148, 0.05394690041854193],
    },
    "pure_rotation": {
        "vo_ate_m": [0.04513753758184899, 0.03832048556264833, 0.024525259881828607,
                     0.04037732517072951, 0.042579274530547204, 0.03917029149395235],
        "unified_ate_vo_m": [0.029166532245042863, 0.04172504985212469, 0.035287450782407706,
                             0.05200705112394651, 0.03834646426580381, 0.04677605291850634],
        "unified_ate_ba_m": [0.04782674738224493, 0.03483746670132808, 0.03311151113298884,
                             0.03831697576304722, 0.035610036403777155, 0.04769198230699291],
    },
    "low_texture": {
        "vo_ate_m": [0.0428260703741545, 0.04384839434202007, 0.035165754079945245,
                     0.055355837219433476, 0.061181748496040134, 0.05018646981356184],
        "unified_ate_vo_m": [0.07346792790062706, 0.08616100537665969, 0.08692027220651125,
                             0.07894010107221278, 0.08614131044405669, 0.08635882020105333],
        "unified_ate_ba_m": [0.049207835866744286, 0.06029152564073791, 0.0579702650215304,
                             0.050283221031770485, 0.059203719076946534, 0.0579344841994851],
    },
}
# The long sequence of benchmarks/long_sequence.py: 501 frames of the
# KITTI-size corrupted world (CameraRig() 376x1241, CorruptionConfig(), world
# seed 0, a 400 m path), the unified engine at its defaults staged
# (unified_system_scan, 5 windows a group, 125 windows) and streaming
# (run_unified_streaming, 5 windows a group, 2 groups a super-chunk).
LONG_FRAMES = 501
LONG_SHORT_FRAMES = 121  # the streaming run whose peak memory the 501-frame run's must match
LONG_SEEDS = (0, 1, 2)
LONG_GROUPS = 2
LONG_MEMORY_TOL = 0.10
LONG_STREAM_TOL = 1e-4  # m, streaming against staged, as the 40-frame check
# JAX's figures: long_sequence_r05.json (RANSAC seed 0), a TPU run of the
# JAX package before its round-5 changes; the JAX run on the CPU at this
# size (tools/jax_unified_reference.py --frames 501 --corrupted --wchunk 5)
# is not made here, since it needs a full-size CPU run. Its per-window
# outputs are benchmarks/unified_dump_long501.npz.
JAX_LONG = {"ate_vo_m": [1.943], "ate_ba_m": [1.6006], "converged": 125, "windows": 125}
LONG_DUMP = "benchmarks/unified_dump_long501.npz"
# JAX's RANSAC draws, shipped with the tree: the cross-modal session's
# (tools/jax_cross_modal_reference.py --seeds 0 1 2 3 4 --dump-draws), the
# unified turn_10deg run's (tools/jax_stress_reference.py --dump-draws) and
# config 2's unified run (tools/jax_configs_reference.py --dump-draws)
DRAWS_DIR = "tools/jax_draws"
# The JAX package's published configurations 2-4 (benchmarks/extra_configs.py)
# and its engine-covariance check (benchmarks/cov_circuit.py:141-200), at their
# own sizes, nothing cut. JAX's figures: tools/jax_configs_reference.py on the
# CPU (JAX_PLATFORMS=cpu; --seeds 0 1 2 3 4 --cov-seeds 1).
# Config 2 (extra_configs.py:33-106): the EuRoC-like rig at 480x752, 17
# frames, world seed 1, default_config without image_shape (so
# min_spread_area stays KITTI's 1000 px^2) and 64 disparities: the ZNCC strip
# is 11 x (64 + 2 * 5), which no template instantiation of K1 covers; staged
# chunk 8, the unified engine 4 windows a group (one group of 4)
EUROC_RIG = dict(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11, height=480, width=752)
EUROC_FRAMES, EUROC_WORLD, EUROC_CHUNK, EUROC_WCHUNK, EUROC_DISP = 17, 1, 8, 4, 64
EUROC_SEEDS = (0, 1, 2, 3, 4)
EUROC_WITNESS_SEEDS = (0, 1, 2)  # on JAX's draws, DRAWS_DIR/unified_euroc_draws_seed*.npy
EUROC_STRIP = (11, EUROC_DISP + 10)
EUROC_SHAPES = [EUROC_STRIP, *(s for s in SHAPES if s != (11, N_DISP + 10))]
JAX_EUROC = {
    "staged_ate_m": [0.034357491062916364, 0.026409566075368932, 0.028695283068458637,
                     0.023939945800632474, 0.018323684443862683],
    "unified_ate_vo_m": [0.030376584388821428, 0.020882181359355358, 0.03019164995621043,
                         0.021258322505165992, 0.017262880019555907],
    "unified_ate_ba_m": [0.01163181694364112, 0.008778421785255237, 0.0139330206598416,
                         0.010620214841768876, 0.011736358023176043],
    # every motion and every window, at every seed
    "staged_success": 16, "vo_success": 16, "ba_converged": 4,
}
EUROC_ATE_X = 1.5  # medians over EUROC_SEEDS against JAX's over the same seeds
# Config 3 (extra_configs.py:109-209, its accuracy block): one
# match_stereo(use_mi=True) on the 192x320 world of seed 2, right image
# 255 - right, 256 top-k features, 64 disparities, against the renderer's
# disparity; then bench_mi_scale's bad-init recovery (:293-333): the scale LM
# from s_init 0.5 and 2.8 (coarse_candidates=13) on frame 0 of the
# cross-modal world of seed 3, corners at exact depths over the true scale 1.4
MI_WORLD, MI_FEATURES, MI_DISP = 2, 256, 64
JAX_MI = {"valid_matches": 173, "n_matchable": 162, "median_abs_px_err": 0.12265145778656006,
          "p90_abs_px_err": 0.42791450023651123, "precision_at_1px": 0.96875,
          "recall_at_1px": 0.9567901234567902}
MI_TOL = {"precision_at_1px": 0.01, "recall_at_1px": 0.01, "median_abs_px_err": 0.02}
MI_VALID_TOL = 0.02  # valid matches, relative
RECOVERY_WORLD, RECOVERY_FRAMES, RECOVERY_SCALE = 3, 12, 1.4
JAX_RECOVERY = {0.5: 1.4690535068511963, 2.8: 1.346099615097046}
RECOVERY_TOL, RECOVERY_JAX_TOL = 0.05, 2e-3  # of the true scale; of JAX's, relative
# Config 4 (extra_configs.py:357-392): 16 windows of 10 frames x 256 points,
# 0.3 px noise, as tests/test_ba.py builds and perturbs them (window s drawn
# with seed s, perturbed with seed s + 100; its intrinsics, 640x480 image and
# 0.5 m baseline), solved as one batch; JAX's jax.vmap(ba_solve) per window
BA4_WINDOWS, BA4_FRAMES, BA4_POINTS, BA4_NOISE = 16, 10, 256, 0.3
BA4_INTR, BA4_BASELINE = (400.0, 400.0, 320.0, 240.0), 0.5
JAX_BA4 = {
    "cost": [0.4030887186527252, 0.32730987668037415, 0.3835234045982361, 0.421810507774353,
             0.3353882133960724, 0.437725692987442, 0.37899795174598694, 0.3952473998069763,
             0.32148194313049316, 0.38330307602882385, 0.3510424494743347, 0.36541295051574707,
             0.42362499237060547, 0.39484283328056335, 0.39196619391441345,
             0.3955807089805603],
    "n_iter": [4, 4, 4, 5, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4],
    "converged": [True] * 16, "mean_cost": 0.3818966746330261,
}
JAX_BA4_FILE = "config4_ba_windows.npz"  # in DRAWS_DIR: JAX's cameras (--ba-out)
BA4_COST_RTOL, BA4_CAM_TOL = 1e-4, 1e-4
# LM iterations may differ by one at a window whose last step changes its
# cost by less than float32 rounds the cost sum: window 3's 4th step lowers
# it by 1.9e-7 relative in float64, and JAX's batch on the CPU (and the
# port's there) rounds it to a rise of 6.4e-7, rejects it and stops after a
# 5th, while the card's batch accepts it and stops after 4; the costs agree
# within 3e-7 relative either way
BA4_ITER_GAP = 1
# K3 (kernels A and B) against the plain chain: its gap from the float64
# chain may be this many times the float32 chain's, plus this share of the
# output's largest entry (both sum the same float32 terms in other orders;
# measured on an H100: at most 2.2 times)
BA_GAP_X, BA_GAP_FLOOR = 4.0, 1e-6
BA_CELL = (907, 10, 256)  # kitti-ba-windows: windows, frames, points
# The covariance check (cov_circuit.py:141-200): the unified engine at its
# defaults (4 windows a group) on the 40-frame corrupted world of
# benchmarks/full_system.py, RANSAC seed 1, as that block runs it
COV_SEED, COV_WCHUNK = 1, 4  # 10 windows: groups of 4, 4 and 2
JAX_COV = {"motion_cov_trace_median": 0.0007378017059949116,
           "pose_cov_trace_first": 0.00017464874429369608,
           "pose_cov_trace_last": 0.027772924569821344, "pose_cov_growth_x": 159.02161038797576,
           "median_motion_t_err_m": 0.017305435912115124,
           "median_motion_t_sigma_m": 0.027144627992068814,
           "err_within_3sigma_frac": 0.8717948717948718}
COV_FRAC_SLACK, COV_SIGMA_X = 0.1, 1.5
# K1's cases on the paths, each (batches, images, tiles, features) held to
# its plain version by check_gather: the stereo, cross-modal and integrated
# paths; the mono engine; the per-frame loops (run_cross_modal and the
# latency mode: batch 1, every path shape); the parallel phase's ranks
K1_HELD = [(K1_PATH_BATCHES, LEVELS, list(SHAPES), N_FEATURES),
           (MONO_BATCHES, MONO_LEVELS, KLT_SHAPES, MONO_FEATURES),
           ((1,), LEVELS, list(SHAPES), N_FEATURES),
           (PAR_K1_BATCHES, LEVELS, list(SHAPES), N_FEATURES),
           (STRESS_BATCHES, STRESS_LEVELS, [*SHAPES, STRESS_TILE], 256),
           ((EUROC_CHUNK, EUROC_WCHUNK), MONO_LEVELS, EUROC_SHAPES, N_FEATURES),
           ((COV_WCHUNK, PAR_UNIFIED_WINDOWS % COV_WCHUNK), LEVELS, list(SHAPES), N_FEATURES)]


def held_cases() -> set:
    """(batch, tile_h, tile_w, H, W) of every case check_gather holds."""
    return {(b, *tile, *level) for batches, levels, tiles, _ in K1_HELD for b in batches
            for tile in tiles for level in levels}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def toolchain() -> str:
    """nvcc's release line and the triton version, as installed."""
    from importlib import metadata

    from uasl_motion_estimation_tpu_torch.ops.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-2:]
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "absent"
    return f"torch {torch.__version__} (CUDA {torch.version.cuda}); {' '.join(nvcc)}; triton {triton}"


def build_kernels() -> None:
    """One nvcc per kernel source, all started together; prints each
    build's time and its -Xptxas -v report."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import _build
    from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(_build.build_library, (kg.SOURCE, kmi.SOURCE, kba.SOURCE)))
    kg.GATHER.load()
    kmi.MI.load()
    kba.BA_SCHUR.load()
    print(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(open(f"{lib}.log").read().strip())


def random_anchors(gen, batch, n, h, w, dev):
    """Anchors over and beyond the image, plus the int32 extremes."""
    ax = torch.randint(-300, w + 300, (batch, n), generator=gen)
    ay = torch.randint(-60, h + 60, (batch, n), generator=gen)
    ax[:, 0], ay[:, 0] = -2**31, 2**31 - 1
    ax[:, -1], ay[:, -1] = 2**31 - 1, -2**31
    return torch.stack([ax, ay], -1).to(torch.int32).to(dev)


def check_gather(dev) -> float:
    """K1 vs its plain version at every main-path tile shape and level, for
    a chunk of 13 steps and a group of 5 windows, and at edge cases: 1x1
    and 2x3 images, 1x1 and 3x5 tiles (odd areas, which reach the scalar
    head and tail), batch 1 and n 1 and 7; then at the mono engine's KLT
    tiles and 480x752 levels (batches 8, 4 and 1, 256 features) and the
    per-frame cross-modal loop's (batch 1), and the rest of ``K1_HELD``."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    gen = torch.Generator().manual_seed(0)
    cases = [(batch, N_FEATURES, h, w, list(SHAPES)) for batch in K1_PATH_BATCHES
             for h, w in LEVELS]
    cases += [(batch, n, h, w, [(1, 1), (3, 5), (22, 22)]) for batch in (1, CHUNK)
              for n in (1, 7) for h, w in ((1, 1), (2, 3), LEVELS[-1])]
    cases += [(batch, n, h, w, tiles) for batches, levels, tiles, n in K1_HELD[1:]
              for batch in batches for h, w in levels]
    worst = 0.0
    for batch, n, h, w, tiles in cases:
        img = (torch.rand(batch, h, w, generator=gen) * 255).to(dev)
        for th, tw in tiles:
            anc = random_anchors(gen, batch, n, h, w, dev)
            got = kg.gather_tiles(img, anc, th, tw)
            want = kg.gather_tiles_plain(img, anc, th, tw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or got.shape != (batch, n, th, tw):
                raise AssertionError(f"K1 differs from plain at {batch}x{n} tiles {th}x{tw} "
                                     f"on {h}x{w}: {err}")
            worst = max(worst, err)
    return worst


def mi_ids(gen, rows, p, bins, dev, sentinel=None):
    q = torch.randint(0, bins, (rows, p), generator=gen, dtype=torch.int32)
    if sentinel is not None:  # a few pixels of every third row out of range
        q[::3, -5:] = sentinel
    return q.to(dev)


def check_mi(dev) -> tuple[float, float]:
    """K2 vs its plain version. Pair mode: 13 x 500 left patches each against
    128 candidates (rep 128) and the scale LM's shape (rep 1), sentinels 20,
    25, 31 and 400 in qa, P 81 and 121, bins 20 and 32. Strip mode: 13 x 500
    features x 128 disparities at k 11 and bins 20 (the matcher), k 9 with
    bins 32, and 64 disparities. Identical patches must give the entropy.
    Returns the largest difference from the plain version and from the
    entropy."""
    from uasl_motion_estimation_tpu_torch.ops import similarity as sim
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    gen = torch.Generator().manual_seed(2)
    rows = CHUNK * N_FEATURES
    cases = [(rows, N_DISP, 121, 20, None), (rows, 1, 121, 20, None)]
    cases += [(rows, rep, p, bins, s) for s in (20, 25, 31, 400)
              for rep, p, bins in ((N_DISP, 121, 20), (1, 81, 32))]
    worst = 0.0
    for a, rep, p, bins, sentinel in cases:
        qa = mi_ids(gen, a, p, bins, dev, sentinel)
        qb = mi_ids(gen, a * rep, p, bins, dev)
        got = kmi.mi_pairs(qa, qb, rep=rep, n_valid=p, bins=bins)
        want = kmi.mi_pairs_plain(qa, qb, rep, p, bins)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= K2_TOL or got.shape != (a * rep,):
            raise AssertionError(f"K2 differs from plain at {(a, rep, p, bins, sentinel)}: {err}")
        worst = max(worst, err)
    for k, n_disp, bins in ((11, N_DISP, 20), (9, N_DISP, 32), (11, 64, 20)):
        qa = mi_ids(gen, rows, k * k, bins, dev).to(torch.uint8)
        strip = mi_ids(gen, rows * k, n_disp + k - 1, bins, dev).to(torch.uint8)
        strip = strip.reshape(rows, k, n_disp + k - 1)
        got = kmi.mi_strip(qa, strip, bins)
        want = kmi.mi_strip_plain(qa, strip, bins)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= K2_TOL or got.shape != (rows, n_disp):
            raise AssertionError(f"K2 strip mode differs from plain at {(k, n_disp, bins)}: {err}")
        worst = max(worst, err)
    patches = torch.rand(rows, 11, 11, generator=gen).mul(255).to(dev)
    q = sim.quantise(patches).reshape(rows, -1).contiguous()
    got = kmi.mi_pairs(q, q)
    worst = max(worst, float((got - kmi.mi_pairs_plain(q, q, 1, 121, 20)).abs().max()))
    ent_err = float((got - sim.entropy(patches)).abs().max())
    if not (worst <= K2_TOL and ent_err <= ENTROPY_TOL):
        raise AssertionError(f"K2 of identical patches: {worst} from plain, {ent_err} from "
                             f"their entropy")
    return worst, ent_err


def hold_ba_schur(problem, cfg, name: str, v_eps: float = 0.0) -> dict:
    """K3's kernels A and B against the plain chain of ``solvers/ba.py`` on
    ``problem`` (its cameras and points as they are), both held to the
    float64 chain: each output's largest gap, relative to its largest entry,
    may be ``BA_GAP_X`` times the float32 chain's plus ``BA_GAP_FLOOR``.
    The solve's damping (lam 1e-4), or with ``v_eps`` the covariances' (lam
    0, V + v_eps I); B takes the float64 solve's update. Returns each
    output's (kernel, plain) gaps."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba
    from uasl_motion_estimation_tpu_torch.solvers import ba as tba

    p32 = tba.BAProblem(*(t.contiguous() for t in problem))
    p64 = tba.BAProblem(p32.cam.double(), p32.pts.double(), p32.obs.double(), p32.mask)
    lam = torch.full(p32.cam.shape[:-2], 0.0 if v_eps else 1e-4, device=p32.cam.device)
    valid = torch.sum(p32.mask.float(), -2) >= 2
    mf = p32.mask.float()
    kw = dict(intr=cfg.intr, baseline=cfg.baseline, huber_delta=cfg.huber_delta)
    ka = kba.reduce(*p32, lam, None, valid, n_fixed=cfg.n_fixed, v_eps=v_eps, **kw)
    pa = tba._reduce_plain(*p32[:3], mf, lam, valid, cfg, v_eps)
    ra = tba._reduce_plain(*p64[:3], mf.double(), lam.double(), valid, cfg, v_eps)
    dcam = torch.linalg.solve(ra[0], ra[1][..., None]).reshape(p64.cam.shape)
    kb = kba.step(*p32, dcam.float().contiguous(), ka[3], None, valid,
                  zlim=tba._depth_limits(cfg), **kw)
    pb = tba._step_plain(*p32[:3], mf, dcam.float(), pa[3], valid, cfg)
    rb = tba._step_plain(*p64[:3], mf.double(), dcam, ra[3], valid, cfg)
    torch.cuda.synchronize()

    def gap(x, ref):
        ref = ref.double()
        return float((x.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))

    vinv = ka[3][..., :9].reshape(*ka[3].shape[:-1], 3, 3)
    outputs = {"S": (ka[0], pa[0], ra[0]), "rhs": (ka[1], pa[1], ra[1]),
               "cost": (ka[2], pa[2], ra[2]), "V^-1": (vinv, pa[3][0], ra[3][0]),
               "bp": (ka[3][..., 9:], pa[3][2], ra[3][2]), "pts_new": (kb[1], pb[1], rb[1]),
               "cost_new": (kb[2], pb[2], rb[2])}
    gaps = {k: (gap(a, r), gap(b, r)) for k, (a, b, r) in outputs.items()}
    bad = {k: g for k, g in gaps.items() if not g[0] <= BA_GAP_X * g[1] + BA_GAP_FLOOR}
    if bad or not (torch.equal(kb[0], pb[0]) and bool(kb[3].all())):
        raise AssertionError(f"K3 off the plain chain at {name}: {bad or gaps}")
    print(f"K3 vs plain at {name} ({tuple(p32.obs.shape)}): gaps from the float64 chain, kernel "
          f"/ plain: " + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in gaps.items()),
          flush=True)
    return gaps


def time_ba_schur(dev, card) -> dict:
    """K3 at cell kitti-ba-windows' shape (``BA_CELL``: config 4's windows
    at the KITTI rig, drawn with seeds 0-906, every window active, warm):
    kernels A and B, the dense solve between them (cuSOLVER's backend, as
    ``ba_solve`` runs it) and the plain chain's reduction and step, each by
    CUDA events. The bound of A and B together: the iteration's bytes (the
    observations, masks, points and cameras in once; S, its right-hand side
    and the points out) at 3.35 TB/s, and its FP32 FMAs at 33.5 T a second,
    counting each window's (6W)^2 x 3M Schur product alone."""
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba
    from uasl_motion_estimation_tpu_torch.solvers import ba as tba
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    n, frames, points = BA_CELL
    rig = synthetic.CameraRig()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    wins = [synthetic.ba_window(intr, rig.baseline, n_frames=frames, n_pts=points,
                                noise=BA4_NOISE, seed=w, image_shape=(rig.height, rig.width))
            for w in range(n)]
    wins = [(*synthetic.perturb_ba_window(c, p, seed=w + 100), o, m)
            for w, (c, p, o, m) in enumerate(wins)]
    prob = tba.BAProblem(*(torch.from_numpy(np.stack(x)).to(dev) for x in zip(*wins)))
    cfg = tba.BAConfig(intr=intr, baseline=rig.baseline)
    lam = torch.full((n,), cfg.lambda0, device=dev)
    valid = torch.sum(prob.mask.float(), -2) >= 2
    kw = dict(intr=intr, baseline=cfg.baseline, huber_delta=cfg.huber_delta)
    S, rhs, _, aux = kba.reduce(*prob, lam, None, valid, n_fixed=cfg.n_fixed, **kw)
    dcam = tba._solve(S, rhs)[0].reshape(prob.cam.shape).contiguous()
    mf = prob.mask.float()
    plain_aux = tba._reduce_plain(*prob[:3], mf, lam, valid, cfg)[3]
    zlim = tba._depth_limits(cfg)
    ms = {"A": time_ms(lambda: kba.reduce(*prob, lam, None, valid, n_fixed=cfg.n_fixed, **kw),
                       reps=20),
          "B": time_ms(lambda: kba.step(*prob, dcam, aux, None, valid, zlim=zlim, **kw), reps=20),
          "solve": time_ms(lambda: tba._solve(S, rhs), reps=20),
          "plain_reduce": time_ms(lambda: tba._reduce_plain(*prob[:3], mf, lam, valid, cfg),
                                  reps=5),
          "plain_step": time_ms(lambda: tba._step_plain(*prob[:3], mf, dcam, plain_aux, valid,
                                                        cfg), reps=5)}
    n6 = 6 * frames
    nbytes = (n * frames * points * (4 * 4 + 1) + n * points * (3 * 4 + 1) + n * frames * 6 * 4
              + n * (n6 * n6 + n6) * 4 + n * points * 3 * 4)
    fmas = n * n6 * n6 * 3 * points
    bound = max(nbytes / 3.35e12, fmas / 33.5e12) * 1e3
    out = {**ms, "bytes": nbytes, "fmas": fmas, "bound_ms": bound,
           "bound_by": "FP32 FMAs" if fmas / 33.5e12 >= nbytes / 3.35e12 else "bytes",
           "share": bound / (ms["A"] + ms["B"])}
    print(f"K3 at {n} windows x {frames} frames x {points} points: A {ms['A']:.4f} ms, B "
          f"{ms['B']:.4f} ms, the solve between {ms['solve']:.4f} ms; plain chain reduction "
          f"{ms['plain_reduce']:.3f} ms, step {ms['plain_step']:.3f} ms; bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB, {fmas / 1e9:.3f} G FMAs; by {out['bound_by']}), A + B at "
          f"{100 * out['share']:.1f} %; card {card}", flush=True)
    return out


class BAHeld:
    """Counts the BA solves and covariance calls a run makes through
    ``models/smoother.py``, keeps the first solve's problem, and checks on
    leaving that K3 launched twice for every trip of every solve (kernels A
    and B) and once for every covariance call (kernel A)."""

    def __enter__(self):
        from uasl_motion_estimation_tpu_torch.models import smoother as sm
        from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba

        self.sm, self.kba = sm, kba
        self.orig = sm.ba_solve, sm.ba_camera_covariances
        self.expected, self.problem, self.start = 0, None, kba.BA_SCHUR.launches

        def solve(problem, cfg):
            res = self.orig[0](problem, cfg)
            if self.problem is None:
                self.problem = (problem, cfg)
            self.expected += 2 * int(res.n_iter.max())  # its trips
            return res

        def covariances(problem, cfg):
            self.expected += 1
            return self.orig[1](problem, cfg)

        sm.ba_solve, sm.ba_camera_covariances = solve, covariances
        return self

    def __exit__(self, kind, *_):
        self.sm.ba_solve, self.sm.ba_camera_covariances = self.orig
        self.launches = self.kba.BA_SCHUR.launches - self.start
        if kind is None and not self.launches == self.expected > 0:
            raise AssertionError(f"K3 launched {self.launches} times; the solves' trips and "
                                 f"the covariance calls want {self.expected}")


def time_ms(fn, reps=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps=50) -> dict:
    """Kernel and plain version timed in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ms_runs": [k1, k2],
            "plain_ms_runs": [p1, p2]}


class GatherShim:
    """Stands in for ``ops/image.py``'s ``gather_tiles`` while entered: it
    calls the real wrapper, keeps the first ``keep`` calls' arguments
    (image, anchors, tile_h, tile_w) and counts the calls by tile shape and
    image size; with ``check``, it holds every call's tiles to the plain
    version's on the same inputs (exactly)."""

    def __init__(self, keep: int = 0, check: bool = False):
        from uasl_motion_estimation_tpu_torch.ops import image as im

        self._im, self._real = im, im.gather_tiles
        self.keep, self.calls = keep, []
        self.counts = {}  # (tile_h, tile_w, H, W) -> calls
        self.batches = set()  # (batch, tile_h, tile_w, H, W) of the calls
        self.check, self.checked = check, 0  # hold each call to the plain version

    def __call__(self, img, anchors, tile_h, tile_w):
        if len(self.calls) < self.keep:
            self.calls.append((img, anchors, tile_h, tile_w))
        key = (tile_h, tile_w, *img.shape[-2:])
        self.counts[key] = self.counts.get(key, 0) + 1
        self.batches.add((int(np.prod(img.shape[:-2])), *key))
        out = self._real(img, anchors, tile_h, tile_w)
        if self.check:
            from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

            h, w = img.shape[-2:]
            n = anchors.shape[-2]
            want = kg.gather_tiles_plain(img.reshape(-1, h, w), anchors.reshape(-1, n, 2),
                                         tile_h, tile_w)
            if not torch.equal(out.reshape(want.shape), want):
                raise AssertionError(f"K1 differs from its plain version on a path call: "
                                     f"batch {tuple(img.shape[:-2])}, tiles {key}")
            self.checked += 1
        return out

    def __enter__(self):
        self._im.gather_tiles = self
        return self

    def __exit__(self, *exc):
        self._im.gather_tiles = self._real


class MIShim:
    """Stands in for ``kernels/mi.py``'s ``mi_pairs`` and ``mi_strip`` while
    entered: it calls the real wrappers and holds every call's scores to
    the plain version's on the same inputs (within ``K2_TOL``, NaN where the
    plain version is NaN), counting the calls by mode and shape."""

    def __init__(self):
        from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

        self._kmi, self._real = kmi, (kmi.mi_pairs, kmi.mi_strip)
        self.cases = {}  # (mode, *input shapes) -> calls
        self.checked, self.worst = 0, 0.0

    def _hold(self, got, want, case):
        self.cases[case] = self.cases.get(case, 0) + 1
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
        if not (torch.equal(torch.isfinite(got), fin) and err <= K2_TOL):
            raise AssertionError(f"K2 differs from its plain version on a path call {case}: "
                                 f"{err}")
        self.checked += 1
        self.worst = max(self.worst, err)
        return got

    def pairs(self, qa, qb, rep=1, n_valid=None, bins=20):
        got = self._real[0](qa, qb, rep, n_valid, bins)
        n_valid = qa.shape[-1] if n_valid is None else int(n_valid)
        want = self._kmi.mi_pairs_plain(qa, qb, rep, n_valid, bins)
        return self._hold(got, want, ("pairs", tuple(qa.shape), tuple(qb.shape)))

    def strip(self, qa, strip, bins=20):
        got = self._real[1](qa, strip, bins)
        want = self._kmi.mi_strip_plain(qa, strip, bins)
        return self._hold(got, want, ("strip", tuple(qa.shape), tuple(strip.shape)))

    def __enter__(self):
        self._kmi.mi_pairs, self._kmi.mi_strip = self.pairs, self.strip
        return self

    def __exit__(self, *exc):
        self._kmi.mi_pairs, self._kmi.mi_strip = self._real


def kernel_times_ms(fn, kernel: str, launches: int, least: int | None = None,
                    tries: int = 3) -> list[float] | None:
    """Runs ``fn``, which launches the CUDA kernels whose name holds
    ``kernel`` ``launches`` times, under ``torch.profiler``, and returns the
    device duration of each launch recorded. The profiler now and then
    records fewer launches than were made, or none; a run that recorded
    fewer than ``least`` (default: all) is run again, up to ``tries`` times
    in all, and then None is returned: these figures are reported, not
    checked, so a profiler that misses launches fails no phase."""
    from torch.profiler import ProfilerActivity, profile

    least = launches if least is None else least
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = [1e-3 * e.time_range.elapsed_us() for e in prof.events() if kernel in e.name]
        if least <= len(times) <= launches:
            return times
    print(f"the profiler recorded {len(times)} of {launches} launches of {kernel}, "
          f"{tries} times", file=sys.stderr)
    return None


def cold_ms(fn, flush: torch.Tensor, reps: int = COLD_REPS) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each on a cold L2:
    ``flush`` is written before each launch, outside the launch's events."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def cold_kernel_ms(fn, flush: torch.Tensor, kernel: str, reps: int = COLD_REPS) -> float | None:
    """Median duration on the device of ``kernel``'s launch by ``fn`` (the
    profiler's record, without the events' own overhead), each launch on a
    cold L2 as in ``cold_ms``; over at least half the launches, since the
    profiler may miss a few."""
    def cold_launches():
        for _ in range(reps):
            flush.zero_()
            fn()

    fn()
    times = kernel_times_ms(cold_launches, kernel, reps, least=reps // 2)
    return None if times is None else float(np.median(times))


def warm_ms(fn, reps: int = 50) -> float:
    """Device time per launch of ``fn`` over ``reps`` launches back to back,
    the data warm in L2, queued behind a device sleep."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_gather(img, anchors, tile_h, tile_w):
    """K1's function as one PyTorch call, the yardstick: ``grid_sample``,
    nearest, border padding, ``align_corners=True``, on a grid of the tiles'
    integer coordinates (anchors clamped first, as K1 does; border padding
    clamps the rest). The grid is built here; returns the call."""
    import torch.nn.functional as F

    batch, h, w = img.shape
    n = anchors.shape[1]
    if h < 2 or w < 2:
        raise ValueError("library_gather: align_corners needs an image of 2 x 2 or more")
    ax = torch.clamp(anchors[..., 0].double(), -tile_w, w - 1)
    ay = torch.clamp(anchors[..., 1].double(), -tile_h, h - 1)
    cols = ax[..., None] + torch.arange(tile_w, device=img.device)  # (B, N, tw)
    rows = ay[..., None] + torch.arange(tile_h, device=img.device)  # (B, N, th)
    gx = (cols * (2.0 / (w - 1)) - 1.0)[:, :, None, :].expand(-1, -1, tile_h, -1)
    gy = (rows * (2.0 / (h - 1)) - 1.0)[:, :, :, None].expand(-1, -1, -1, tile_w)
    grid = torch.stack([gx, gy], -1).float().reshape(batch, n * tile_h, tile_w, 2)
    src = img[:, None]

    def call():
        return F.grid_sample(src, grid, mode="nearest", padding_mode="border",
                             align_corners=True).reshape(batch, n, tile_h, tile_w)

    return call


def gather_cases(dev, path_calls) -> list[dict]:
    """K1's inputs at every main-path tile shape and level, two sets each:
    the stereo path's own (one call per shape and image size, the first, of
    the calls recorded on its first chunk) and uniform random anchors over
    the image of the same size, one set per size. The random level-0 image
    and anchors are those K1 was timed on before it timed the path's (seed
    1), so those rows continue."""
    path, seen = [], set()
    for img, anc, th, tw in path_calls:
        h, w = img.shape[-2:]
        if (th, tw, h, w) not in seen:
            seen.add((th, tw, h, w))
            img3 = img.reshape(-1, h, w)
            path.append({"anchors": "path", "img": img3,
                         "anc": anc.reshape(img3.shape[0], -1, 2), "tile": (th, tw)})
    gen = torch.Generator().manual_seed(1)
    randoms = {}
    for h, w in sorted({(h, w) for _, _, h, w in seen}, reverse=True):  # level 0 first
        img = (torch.rand(CHUNK, h, w, generator=gen) * 255).to(dev)
        xs = torch.randint(0, w, (CHUNK, N_FEATURES), generator=gen)
        ys = torch.randint(0, h, (CHUNK, N_FEATURES), generator=gen)
        randoms[(h, w)] = (img, torch.stack([xs, ys], -1).to(torch.int32).to(dev))
    rand = []
    for case in path:
        img, anc = randoms[tuple(case["img"].shape[-2:])]
        rand.append({"anchors": "random", "img": img, "anc": anc, "tile": case["tile"]})
    return path + rand


def case_name(case) -> str:
    (th, tw), (h, w) = case["tile"], case["img"].shape[-2:]
    return f"{case['anchors']} {th}x{tw} on {h}x{w}"


def time_gather_case(case, flush) -> dict:
    """One K1 case: the kernel against its plain version and ``grid_sample``
    (exactly), then cold times in turns (library, plain, kernel, kernel,
    plain, library), the kernel's cold duration by the profiler, two warm
    times of the kernel, and the bound from the bytes these anchors need
    (``gather_bytes``)."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    img, anc, (th, tw) = case["img"], case["anc"], case["tile"]
    h, w = img.shape[-2:]

    def kernel():
        return kg.gather_tiles(img, anc, th, tw)

    def plain():
        return kg.gather_tiles_plain(img, anc, th, tw)

    library = library_gather(img, anc, th, tw)
    got = kernel()
    if not (torch.equal(got, plain()) and torch.equal(got, library())):
        raise AssertionError(f"K1 differs from its plain version or grid_sample: "
                             f"{case_name(case)}")
    lib1, plain1, k1, k2, plain2, lib2 = (cold_ms(f, flush) for f in
                                          (library, plain, kernel, kernel, plain, library))
    kernel_ms = cold_kernel_ms(kernel, flush, K1_KERNEL)
    warm = [warm_ms(kernel), warm_ms(kernel)]
    nbytes = kg.gather_bytes(anc, h, w, th, tw)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    ms = min(k1, k2)
    return {"anchors": case["anchors"], "shape": [*anc.shape[:2], th, tw], "image": [h, w],
            "ms": ms, "ms_runs": [k1, k2], "kernel_ms": kernel_ms, "warm_ms": min(warm),
            "warm_ms_runs": warm, "plain_ms": min(plain1, plain2),
            "library_ms": min(lib1, lib2), "library_ms_runs": [lib1, lib2], "bytes": nbytes,
            "bound_ms": bound, "bound_by": "bytes", "share": bound / ms,
            "kernel_share": None if kernel_ms is None else bound / kernel_ms}


def time_gather(dev, path_calls) -> tuple[dict, float]:
    """``time_gather_case`` at every case of ``gather_cases``, by name, and
    the floor of the cold timing: ``cold_ms`` of an empty window."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = {case_name(c): time_gather_case(c, flush) for c in gather_cases(dev, path_calls)}
    return cases, cold_ms(lambda: None, flush)


def occupied_bins(qa: torch.Tensor, qb: torch.Tensor, rep: int, bins: int) -> int:
    """Occupied joint cells plus occupied marginal bins over all pairs (pair
    ``q`` is ``qa[q // rep]`` against ``qb[q]``)."""
    idx = qa.long().repeat_interleave(rep, 0) * bins + qb.long()
    counts = torch.zeros((idx.shape[0], bins * bins), device=qb.device).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=torch.float32)).reshape(-1, bins, bins)
    return int((counts > 0).sum() + (counts.sum(-1) > 0).sum() + (counts.sum(-2) > 0).sum())


def with_bound(r: dict, nbytes: int, occupied: int, **shape) -> dict:
    """The least time the card could take: the bytes read and written once
    at the memory rate, against one log2, one multiply and one add per
    occupied cell and marginal bin at the float32 rate; the larger wins."""
    ops = 3 * occupied
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    r.update(shape, bytes=nbytes, ops=ops, bound_ms=1e3 * max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    return r


def time_mi(dev, session_ids) -> dict:
    """K2 and plain times in both modes, each in turns with its plain
    version:
    - strip mode at the matcher's shape (one 13-step chunk, 500 features,
      128 disparities, 11x11 px, 20 bins), on the ids the matcher gives it on
      the full-size cross-modal world (``session_ids``) and on uniform ids;
    - pair mode at the scale LM's shape (13 x 500 pairs, rep 1);
    - pair mode at the matcher's old pair shape (13 x 500 x 128 pairs,
      rep 128), where the earlier dense design was timed.
    The strip mode must agree with its plain version to 1e-5 on both id sets.
    Each bound counts the ids read once and the scores written once, and
    the float32 operations its ids need (``with_bound``)."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    gen = torch.Generator().manual_seed(3)
    rows, k, bins = CHUNK * N_FEATURES, 11, 20
    p = k * k
    out = {}
    uniform = (mi_ids(gen, rows, p, bins, dev).to(torch.uint8),
               mi_ids(gen, rows * k, N_DISP + k - 1, bins, dev).to(torch.uint8).reshape(
                   rows, k, N_DISP + k - 1))
    for name, (qa, strip) in (("strip_session", session_ids), ("strip_uniform", uniform)):
        got, want = kmi.mi_strip(qa, strip, bins), kmi.mi_strip_plain(qa, strip, bins)
        err = float((got - want).abs().max())
        if not err <= K2_TOL:
            raise AssertionError(f"K2 strip mode differs from plain on the {name} ids: {err}")
        r = in_turns(lambda: kmi.MI.strip(qa, strip, bins),
                     lambda: kmi.mi_strip_plain(qa, strip, bins), reps=20)
        r["max_abs_err"] = err
        qb = kmi.strip_windows(strip, k).reshape(-1, p)
        out[name] = with_bound(r, qa.numel() + strip.numel() + 4 * rows * N_DISP,
                               occupied_bins(qa, qb, N_DISP, bins),
                               shape=[rows, N_DISP, p, bins])
    for name, rep in (("pairs_scale_lm", 1), ("pairs_rep128", N_DISP)):
        qa = mi_ids(gen, rows, p, bins, dev)
        qb = mi_ids(gen, rows * rep, p, bins, dev)
        r = in_turns(lambda: kmi.MI(qa, qb, rep, p, bins),
                     lambda: kmi.mi_pairs_plain(qa, qb, rep, p, bins),
                     reps=20 if rep > 1 else 50)
        out[name] = with_bound(r, 4 * (qa.numel() + qb.numel() + qb.shape[0]),
                               occupied_bins(qa, qb, rep, bins), shape=[rows, rep, p, bins])
    return out


def matcher_strip_ids(dev, left_u8, right_u8) -> tuple[int, tuple]:
    """The first chunk of the full-size cross-modal world (13 steps, 500 grid
    features each, 128 disparities, 11x11 px): step by step, the strip
    route's ids must equal the per-candidate patches' ids at every in-image
    candidate. Then ``match_stereo(use_mi=True)`` on the chunk must launch K2
    once, in strip mode. Returns the candidates compared and the chunk's
    (left ids, strip ids) as the matcher's K2 launch gets them."""
    from uasl_motion_estimation_tpu_torch.models import frontend as fe
    from uasl_motion_estimation_tpu_torch.ops import image as im
    from uasl_motion_estimation_tpu_torch.ops import similarity as sim
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    left = left_u8[1:CHUNK + 1].float()
    right = right_u8[1:CHUNK + 1].float()
    h, w = left.shape[-2:]
    feats, _, valid = im.detect_features_grid(left, max_features=N_FEATURES)
    cfg = fe.MatcherConfig()
    r, k = cfg.patch_radius, 2 * cfg.patch_radius + 1
    d_range = torch.arange(N_DISP, dtype=torch.float32, device=dev)
    compared = 0
    for s in range(CHUNK):
        f = feats[s]
        cand = torch.stack([f[:, None, 0] - d_range, f[:, None, 1].expand(-1, N_DISP)], -1)
        per_cand = sim.quantise(im.extract_patches(right[s], cand.reshape(-1, 2), r))
        strip = sim.quantise(im.extract_strips(right[s], f, r, N_DISP))
        windows = kmi.strip_windows(strip, k).reshape(N_FEATURES, N_DISP, k * k)
        inside = im.patch_in_bounds(cand, r + 1, h, w)
        if not torch.equal(windows[inside], per_cand.reshape(N_FEATURES, N_DISP, k * k)[inside]):
            raise AssertionError(f"strip ids differ from per-candidate ids at step {s}")
        compared += int(inside.sum())
    qa = sim.quantise(im.extract_patches(left, feats, r)).to(torch.uint8).reshape(-1, k * k)
    strip = sim.quantise(im.extract_strips(right, feats, r, N_DISP)).to(torch.uint8)
    kmi.MI.launches = kmi.MI.strip_launches = 0
    fe.match_stereo(left, right, feats, valid, cfg, use_mi=True)
    if (kmi.MI.launches, kmi.MI.strip_launches) != (1, 1):
        raise AssertionError(f"the MI matcher launched K2 {kmi.MI.launches} times, "
                             f"{kmi.MI.strip_launches} in strip mode")
    return compared, (qa.contiguous(), strip.reshape(-1, k, N_DISP + 2 * r).contiguous())


def count_syncs(fn) -> int:
    """Stream syncs that ``fn`` makes (host reads of device values), counted
    with torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def small_rig():
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    return synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                               height=192, width=320)


def small_world_agrees(dev):
    """192x320, 8 frames, 256 features: the card against the port's CPU run
    (plain kernel versions), both given the same CPU-drawn RANSAC samples.
    Success flags equal, motions within 1e-3."""
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = small_rig()
    seq = synthetic.SyntheticStereoSequence(n_frames=8, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(8)]
    cfg = tp.default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                            rig.baseline)._replace(max_features=256)
    cpu = tp.OdometryPipeline(cfg, seed=0, device="cpu")

    def sampler(step, valid):
        return cpu._sample(step, valid.cpu()).to(valid.device)

    packed = {}
    for d in ("cpu", dev):
        pipe = tp.OdometryPipeline(cfg, seed=0, device=d, sampler=sampler)
        ls, rs = pipe.stage_frames(frames)
        packed[str(d)] = tp._vo_scan_packed(ls, rs, 0, sampler, cfg, 7).cpu().numpy()
    a, b = packed["cpu"], packed[str(dev)]
    if not (np.array_equal(a[:, 16], b[:, 16]) and a[:, 16].all()):
        raise AssertionError(f"success flags differ: cpu {a[:, 16]} card {b[:, 16]}")
    err = float(np.abs(a[:, :16] - b[:, :16]).max())
    if not err < 1e-3:
        raise AssertionError(f"card and CPU motions differ by {err}")
    return err


def unified_config(rig, **overrides):
    from uasl_motion_estimation_tpu_torch.models.pipeline import default_config
    from uasl_motion_estimation_tpu_torch.models.smoother import SmootherConfig
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    pipe = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    return SmootherConfig(pipe=pipe._replace(**overrides))


def small_unified_agrees(dev) -> float:
    """192x320, 9 frames (2 windows of 5), 256 features: the integrated
    VO+BA engine on the card against the port's CPU run (plain kernel
    versions), both given the same CPU-drawn samples. Equal vo_success,
    every window converged, VO and refined motions within 1e-3."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
    from uasl_motion_estimation_tpu_torch.models.smoother import unified_system_scan
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = small_rig()
    seq = synthetic.SyntheticStereoSequence(n_frames=9, rig=rig, seed=4)
    frames = [seq.frame(i) for i in range(9)]
    cfg = unified_config(rig, max_features=256)
    cpu_sampler = make_sampler(1, cfg.pipe.vo.n_ransac)

    def sampler(step, valid):
        return cpu_sampler(step, valid.cpu()).to(valid.device)

    out = {}
    for d in ("cpu", dev):
        ls, rs = (torch.from_numpy(np.clip(np.stack([f[k] for f in frames]), 0, 255)
                                   .astype(np.uint8)).to(d) for k in (0, 1))
        out[str(d)] = unified_system_scan(ls, rs, sampler, cfg, wchunk=2)
    a, b = out["cpu"], out[str(dev)]
    if not (np.array_equal(a.vo_success, b.vo_success) and a.vo_success.all()
            and b.ba_converged.all()):
        raise AssertionError(f"integrated engine, card vs CPU: vo_success {b.vo_success} vs "
                             f"{a.vo_success}, converged {b.ba_converged}")
    err = max(float(np.abs(getattr(a, k) - getattr(b, k)).max())
              for k in ("vo_motions", "refined_motions"))
    if not err < 1e-3:
        raise AssertionError(f"integrated engine: card and CPU motions differ by {err}")
    return err


def cross_modal_config(rig, **overrides):
    from uasl_motion_estimation_tpu_torch.models.cross_modal import CrossModalConfig
    from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu_torch.models.scale import ScaleConfig
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    return CrossModalConfig(vo=MonoVOParams(intr=intr),
                            scale=ScaleConfig(intr=intr, baseline=rig.baseline), **overrides)


def small_cross_modal_agrees(dev) -> tuple[float, float]:
    """192x320, 6 frames, seed 3, cross-modal, 256 features, 64 disparities:
    the card against the port's CPU run with the same CPU-drawn samples.
    Equal vo_success; scales within 1e-2 relative and rotations within 1e-3
    (MI is quantised, so a float32 difference in a bilinear patch can move a
    pixel across a bin edge and nudge the MI-LM's end point)."""
    from uasl_motion_estimation_tpu_torch.models import cross_modal as tcm
    from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu_torch.models.mono_pipeline import make_mono_samplers
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = small_rig()
    seq = synthetic.SyntheticStereoSequence(n_frames=6, rig=rig, seed=3, cross_modal=True)
    frames = [seq.frame(i) for i in range(6)]
    cfg = cross_modal_config(rig, matcher=MatcherConfig(max_disparity=64), max_features=256)
    cpu_sampler = make_mono_samplers(0, cfg.vo)[0]

    def sampler(step, valid):
        return cpu_sampler(step, valid.cpu()).to(valid.device)

    res = {d: tcm.run_cross_modal_staged(frames, cfg, seed=0, chunk=5, device=d,
                                         sampler=sampler) for d in ("cpu", dev)}
    a, b = res["cpu"], res[dev]
    ok_a = [r["success"] for r in a.records]
    if ok_a != [r["success"] for r in b.records] or not all(ok_a):
        raise AssertionError(f"cross-modal vo_success differs: {a.records} vs {b.records}")
    scale_err = float(np.max(np.abs(a.scales - b.scales) / a.scales))
    rot_err = float(np.abs(a.trajectory[:, :3, :3] - b.trajectory[:, :3, :3]).max())
    if not (scale_err < 1e-2 and rot_err < 1e-3):
        raise AssertionError(f"cross-modal card vs CPU: scale {scale_err}, rotation {rot_err}")
    return scale_err, rot_err


def unified_ates(res, gt) -> tuple[float, float]:
    from uasl_motion_estimation_tpu_torch.utils import metrics

    return (float(metrics.ate_rmse(res.traj_vo[:, :3, 3], gt)),
            float(metrics.ate_rmse(res.traj_ba[:, :3, 3], gt)))


def check_unified(res, name: str) -> None:
    """A full-size integrated result: N poses, finite, every window's BA
    converged, every motion's VO succeeded."""
    if res.traj_ba.shape != (N_FRAMES, 4, 4) or not (
            np.isfinite(res.traj_ba).all() and np.isfinite(res.pose_cov).all()):
        raise AssertionError(f"{name}: bad integrated result, shape {res.traj_ba.shape}")
    if not res.ba_converged.all():
        raise AssertionError(f"{name}: BA did not converge in windows "
                             f"{np.nonzero(~res.ba_converged)[0].tolist()}")


def integrated_path(dev, rig, frames, gt, ls, rs, card) -> dict:
    """The integrated VO+BA engine at full width on the clean world (RANSAC
    seeds 0-2) and on the corrupted world of ``benchmarks/full_system.py``
    (seed 0), through ``run_unified_system``; K1's launches counted around
    the first clean run and the corrupted run. Then, on the staged frames,
    frames/s of ``unified_system_scan`` (median of 3 after a warm-up, as
    ``bench.py`` times it), the host composition, the stream syncs per run,
    and K1's calls and device time per run."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
    from uasl_motion_estimation_tpu_torch.models.smoother import (
        compose_unified, run_unified_system, unified_system_scan, unified_window_starts)
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    cfg = unified_config(rig)
    out: dict = {"seeds": list(UNIFIED_SEEDS)}
    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    t0 = time.perf_counter()
    res = run_unified_system(frames, cfg, seed=0, wchunk=UNIFIED_WCHUNK, device=dev)
    out["first_run_s"] = time.perf_counter() - t0
    out["launches"] = {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches}
    if out["launches"]["gather_tiles"] <= 0:
        raise AssertionError("the integrated path never launched K1")
    per_seed = []
    for seed in UNIFIED_SEEDS:
        if seed != UNIFIED_SEEDS[0]:
            res = run_unified_system(frames, cfg, seed=seed, wchunk=UNIFIED_WCHUNK, device=dev)
        check_unified(res, f"clean world, seed {seed}")
        ate_vo, ate_ba = unified_ates(res, gt)
        per_seed.append({"seed": seed, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                         "ba_converged": res.ba_converged.tolist(),
                         "ba_cost": res.ba_cost.tolist(), "n_track_obs": res.n_track_obs.tolist(),
                         "n_success": int((res.per_frame[:, 16] > 0.5).sum())})
        print(f"integrated engine, clean world, seed {seed}: ATE VO {ate_vo:.5f} m, after BA "
              f"{ate_ba:.5f} m (JAX {JAX_UNIFIED['ate_vo_m'][seed]:.5f}, "
              f"{JAX_UNIFIED['ate_ba_m'][seed]:.5f} m); BA converged "
              f"{int(res.ba_converged.sum())}/{len(res.ba_converged)}, costs "
              f"{np.round(res.ba_cost, 4).tolist()}; gated track observations "
              f"{res.n_track_obs.tolist()}; successful motions {per_seed[-1]['n_success']}/"
              f"{N_FRAMES - 1}", flush=True)
        if seed == UNIFIED_SEEDS[0]:
            res0 = res
    out["clean"] = per_seed
    first = per_seed[0]
    if not first["ate_ba_m"] < min(first["ate_vo_m"], 0.1):
        raise AssertionError(f"clean world, seed 0: ATE after BA {first['ate_ba_m']} m, "
                             f"VO {first['ate_vo_m']} m (BA must be lower, and < 0.1 m)")
    med = float(np.median([r["ate_ba_m"] for r in per_seed]))
    jax_med = float(np.median(JAX_UNIFIED["ate_ba_m"]))
    out["median_ate_ba_m"], out["jax_median_ate_ba_m"] = med, jax_med
    print(f"integrated engine over seeds {list(UNIFIED_SEEDS)}: median ATE after BA {med:.5f} m "
          f"(JAX {jax_med:.5f} m, gate 1.5x)")
    if not med <= 1.5 * jax_med:
        raise AssertionError(f"integrated median ATE {med} m > 1.5 x JAX's {jax_med} m")

    t0 = time.perf_counter()
    cseq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0,
                                             corruption=synthetic.CorruptionConfig())
    cframes = [cseq.frame(i) for i in range(N_FRAMES)]
    render_s = time.perf_counter() - t0
    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    cres = run_unified_system(cframes, cfg, seed=0, wchunk=UNIFIED_WCHUNK, device=dev)
    out["launches_corrupted"] = kg.GATHER.launches
    check_unified(cres, "corrupted world")
    ate_vo, ate_ba = unified_ates(cres, cseq.gt_positions())
    out["corrupted"] = {"ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                        "ba_converged": cres.ba_converged.tolist(),
                        "n_track_obs": cres.n_track_obs.tolist()}
    jax_c = JAX_UNIFIED_CORRUPTED
    print(f"integrated engine, corrupted world (rendered in {render_s:.1f} s), seed 0: ATE VO "
          f"{ate_vo:.5f} m, after BA {ate_ba:.5f} m (JAX {jax_c['ate_vo_m'][0]:.5f}, "
          f"{jax_c['ate_ba_m'][0]:.5f} m); K1 launches {kg.GATHER.launches}; "
          f"gated track observations {cres.n_track_obs.tolist()}", flush=True)
    if out["launches_corrupted"] <= 0 or not ate_ba < ate_vo:
        raise AssertionError(f"corrupted world: ATE after BA {ate_ba} m, VO {ate_vo} m, K1 "
                             f"launches {out['launches_corrupted']}")

    sampler = make_sampler(0, cfg.pipe.vo.n_ransac)

    def run():
        return unified_system_scan(ls, rs, sampler, cfg, wchunk=UNIFIED_WCHUNK)

    scan = run()
    times = timed_runs(run)
    t0 = time.perf_counter()
    composed = compose_unified(scan, N_FRAMES, cfg)
    out["compose_ms"] = 1e3 * (time.perf_counter() - t0)
    if not np.allclose(composed.traj_ba, res0.traj_ba, atol=1e-4):
        raise AssertionError("the staged scan differs from run_unified_system on the same "
                             "frames and samples")
    out["run_s"] = times
    out["fps"] = (N_FRAMES - 1) / float(np.median(times))
    out["syncs"] = count_syncs(run)
    with GatherShim() as shim:
        run()
    out["k1_calls"] = sum(shim.counts.values())
    n_groups = -(-len(unified_window_starts(N_FRAMES, cfg.window, cfg.ba_rate)) // UNIFIED_WCHUNK)
    if not out["k1_calls"] == out["launches"]["gather_tiles"] == K1_PER_GROUP * n_groups:
        raise AssertionError(f"the shim saw {out['k1_calls']} K1 calls in an integrated run, "
                             f"the launch count says {out['launches']['gather_tiles']}; "
                             f"want {K1_PER_GROUP} per group of windows")
    # every (batch, tile, image) the path gave K1 is one that check_gather
    # held against the plain version
    held = held_cases()
    if not shim.batches <= held:
        raise AssertionError(f"the integrated path gave K1 cases check_gather never held: "
                             f"{sorted(shim.batches - held)}")
    k1_ms = kernel_times_ms(run, K1_KERNEL, out["k1_calls"])
    out["k1_ms_per_run"] = None if k1_ms is None else sum(k1_ms)
    print(f"integrated frames/s {out['fps']:.2f} (median of {times}, unified_system_scan, "
          f"{UNIFIED_WCHUNK} windows per group, 2 groups); host composition "
          f"{out['compose_ms']:.2f} ms; {out['syncs']} stream syncs per run; K1 "
          f"{out['k1_calls']} launches, {out['k1_ms_per_run']} ms of device time per run "
          f"(torch.profiler); card {card}", flush=True)
    out["result"] = res0
    out["corrupted_world"] = (cseq, cframes, cfg)
    return out


def upload_figures(stats: dict) -> dict:
    up_s, up_b = float(np.sum(stats["upload_s"])), float(np.sum(stats["upload_bytes"]))
    return {"upload_s": up_s, "upload_mb": up_b / 1e6, "upload_mb_s": up_b / 1e6 / up_s,
            "uploads": len(stats["upload_s"])}


def streaming_paths(dev, rig, frames, pipe, staged_traj, unified_res, card) -> dict:
    """``run_streaming`` (chunk 13) and ``run_unified_streaming`` (super-
    chunks of one 5-window group) from host frames: K1's launches around
    the first run of each, each trajectory against its staged twin on the
    motions both solve alike (1e-4), frames/s end to end (median of 3) with
    the in-run upload figures of the median run, and stream syncs."""
    from uasl_motion_estimation_tpu_torch.models.smoother import run_unified_streaming
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    cfg = unified_config(rig)

    def vo_stream(stats=None):
        pipe.reset()
        return pipe.run_streaming(iter(frames), chunk=CHUNK, stats=stats)

    def unified_stream(stats=None):
        return run_unified_streaming(iter(frames), cfg, seed=0, wchunk=UNIFIED_WCHUNK,
                                     groups=STREAM_GROUPS, stats=stats, device=dev)

    out = {}
    for name, run in (("streaming", vo_stream), ("unified_streaming", unified_stream)):
        kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
        first = run({})
        launches = kg.GATHER.launches
        if launches <= 0:
            raise AssertionError(f"{name} never launched K1")
        if name == "streaming":
            err = float(np.abs(first - staged_traj).max())
        else:
            n = UNIFIED_SHARED_FRAMES
            err = max(float(np.abs(first.traj_vo[:n] - unified_res.traj_vo[:n]).max()),
                      float(np.abs(first.traj_ba[:n] - unified_res.traj_ba[:n]).max()))
        if not err <= 1e-4:
            raise AssertionError(f"{name} differs from its staged twin by {err}")
        times, stats = [], []
        for _ in range(3):
            st: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            stats.append(st)
        med = int(np.argsort(times)[len(times) // 2])
        out[name] = {"launches": launches, "max_diff_vs_staged": err, "run_s": times,
                     "fps_end_to_end": (N_FRAMES - 1) / times[med], "syncs": count_syncs(run),
                     **upload_figures(stats[med])}
        r = out[name]
        print(f"{name}: frames/s end to end {r['fps_end_to_end']:.2f} (median of {times}); "
              f"uploads in the median run {r['uploads']} x, {r['upload_mb']:.1f} MB in "
              f"{r['upload_s']:.4f} s ({r['upload_mb_s']:.0f} MB/s, timed in the uploader "
              f"thread); {r['syncs']} stream syncs per run; K1 launches {launches}; max "
              f"difference from the staged twin {err:.3g}; card {card}", flush=True)
    return out


def profile_kernels(fn, name: str) -> tuple[int, float, list[float]]:
    """CUDA kernels that ``fn`` launches, their summed device time (ms) and
    the device time of each launch whose name holds ``name``, from one
    ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (len(kernels), sum(1e-3 * e.time_range.elapsed_us() for e in kernels),
            [1e-3 * e.time_range.elapsed_us() for e in kernels if name in e.name])


def device_kernels(fn) -> tuple[int, float]:
    """CUDA kernels that ``fn`` launches and their summed device time (ms),
    by ``torch.profiler``."""
    return profile_kernels(fn, "")[:2]


def event_ms(fn, reps: int = 5) -> list[float]:
    """Device time of each of ``reps`` calls of ``fn`` between CUDA events
    (after one call to warm up)."""
    fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def path_k1(name: str, run, launches: int, profile: bool = True) -> dict:
    """K1 on one path run: every call held to the plain version (GatherShim
    with check) and its (batch, tile, image) among check_gather's cases; the
    calls equal the launches counted on the path's first run; with
    ``profile``, K1's device time over another run (profiler)."""
    with GatherShim(check=True) as shim:
        run()
    check_path_k1(name, shim, launches)
    k1 = kernel_times_ms(run, K1_KERNEL, launches) if profile else None
    return {"k1_calls": launches, "k1_held": shim.checked, "k1_ms_per_run": None if k1 is None
            else sum(k1), "k1_cases": sorted(shim.batches)}


def check_path_k1(name: str, shim: GatherShim, launches: int) -> None:
    """A path run under ``GatherShim(check=True)``: every K1 launch of the
    run was a call the shim held to the plain version, and every (batch,
    tile, image) of them is a case ``check_gather`` holds."""
    calls = sum(shim.counts.values())
    if not calls == shim.checked == launches:
        raise AssertionError(f"{name}: the shim saw {calls} K1 calls ({shim.checked} checked), "
                             f"the launch count says {launches}")
    if not shim.batches <= held_cases():
        raise AssertionError(f"{name} gave K1 cases check_gather never held: "
                             f"{sorted(shim.batches - held_cases())}")


def mono_world():
    """bench_mono's world: the rig, the 13 left frames and the positions."""
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                              height=480, width=752)
    seq = synthetic.SyntheticStereoSequence(n_frames=MONO_FRAMES, rig=rig, seed=3)
    return rig, [seq.frame(i)[0] for i in range(MONO_FRAMES)], seq.gt_positions()


def mono_config(rig, solver: str, **vo):
    from uasl_motion_estimation_tpu_torch.models.mono_pipeline import MonoPipelineConfig
    from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    return MonoPipelineConfig(vo=MonoVOParams(intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                                              inlier_threshold=2.0, solver=solver, **vo),
                              max_features=MONO_FEATURES)


def mono_engine(name: str, run, gt, card) -> dict:
    """One mono engine's figures: the counted first run (K1 launches from 0,
    the trajectory's ATE, the steps that succeeded and escalated), frames/s
    (median of 3 after it), stream syncs per run, and K1 on the path
    (``path_k1``)."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import metrics

    kg.GATHER.launches = 0
    stats: dict = {}
    traj = run(stats)
    launches = kg.GATHER.launches
    if launches <= 0:
        raise AssertionError(f"{name} never launched K1")
    if traj.shape != (MONO_FRAMES, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError(f"{name}: bad trajectory, shape {traj.shape}")
    times = timed_runs(lambda: run({}))
    out = {"launches": launches, "ate_m": float(metrics.ate_rmse(traj[:, :3, 3], gt)),
           "n_success": int(sum(stats["success"])), "success": stats["success"],
           "escalated": stats.get("escalated", []), "replaced": stats.get("replaced", []),
           "run_s": times, "fps": (MONO_FRAMES - 1) / float(np.median(times)),
           "syncs": count_syncs(lambda: run({})), **path_k1(name, lambda: run({}), launches)}
    print(f"mono {name}: frames/s {out['fps']:.2f} (median of {times}); ATE {out['ate_m']:.5f} m; "
          f"successful steps {out['n_success']}/{MONO_FRAMES - 1}; escalated steps "
          f"{out['escalated']} (replaced {out['replaced']}); {out['syncs']} stream syncs per "
          f"run; K1 {launches} launches, every call equal to plain, {out['k1_ms_per_run']} ms of "
          f"device time per run; card {card}", flush=True)
    return out


def candidate_agreement(Ea, va, Eb, vb, tol=1e-3) -> dict:
    """How two runs' candidate sets (..., 10, 3, 3) agree, up to sign: the
    share of samples with equal masks; where both keep a candidate in such
    samples, the median and largest entry difference and the share within
    ``tol``; and the share of all kept candidates the other run finds
    within ``tol``."""
    same = (va == vb).all(dim=-1)
    both = va & vb & same[..., None]
    d = torch.minimum((Ea - Eb).abs().amax((-2, -1)), (Ea + Eb).abs().amax((-2, -1)))[both]
    A, B = Ea.reshape(-1, 10, 9), Eb.reshape(-1, 10, 9)
    cross = torch.minimum(torch.cdist(A, B, p=float("inf")), torch.cdist(A, -B, p=float("inf")))
    ma, mb = va.reshape(-1, 10), vb.reshape(-1, 10)
    inf = torch.tensor(float("inf"))
    found = torch.cat([torch.where(mb[:, None, :], cross, inf).amin(-1)[ma] < tol,
                       torch.where(ma[:, :, None], cross, inf).amin(-2)[mb] < tol])
    return {"masks_equal": float(same.float().mean()), "median": float(d.median()),
            "max": float(d.max()), "within": float((d < tol).float().mean()),
            "found": float(found.float().mean())}


def mono_fivepoint(dev, rig, frames, card) -> dict:
    """The exact 5-point at the mono path's shape: the 8 steps of the first
    chunk x 200 samples of 5 matches (from the pencil scan's tracks, the
    5-point's own samples). Its nullspace basis on the card, then its
    candidates on the card and in the plain CPU run of the same code on
    that basis, each against the float64 CPU run (``FIVEPOINT_SLACK``);
    the solve's time per chunk (CUDA events), the time, syncs and kernels
    of the SVD and of the candidates alone."""
    from uasl_motion_estimation_tpu_torch.models import mono_pipeline as tmp
    from uasl_motion_estimation_tpu_torch.models import mono_vo as tmv
    from uasl_motion_estimation_tpu_torch.ops import fivepoint as tfp

    cfg, cfg8 = mono_config(rig, "5point"), mono_config(rig, "pencil8")
    sampler, sampler8 = (tmp.make_mono_samplers(0, c.vo)[0] for c in (cfg, cfg8))
    ls = torch.from_numpy(np.clip(np.stack(frames[:MONO_CHUNK + 1]), 0, 255).astype(np.uint8))
    _, steps, _ = tmp._mono_scan(ls.to(dev), 0, (sampler8, None), cfg8, MONO_CHUNK)
    samples = torch.stack([sampler(i, v) for i, v in enumerate(steps.valid)])
    rows = torch.arange(MONO_CHUNK, device=dev)[:, None, None]
    s1 = tmv._normalize(steps.matches[..., 0, :], cfg.vo.intr)[rows, samples]
    s2 = tmv._normalize(steps.matches[..., 1, :], cfg.vo.intr)[rows, samples]
    basis = tfp.nullspace_basis(s1, s2)
    Eg, vg = (a.cpu() for a in tfp.candidates_from_basis(basis))
    Ec, vc = tfp.candidates_from_basis(basis.cpu())
    E64, v64 = tfp.candidates_from_basis(basis.cpu().double())
    h1, h2 = (torch.cat([x, torch.ones_like(x[..., :1])], -1).cpu().double() for x in (s1, s2))

    def epipolar_ok(E, v) -> float:
        epi = torch.einsum("bhni,bhrij,bhnj->bhrn", h2, E.double(), h1).abs().amax(-1)
        return float((epi[v] < 5e-3).float().mean())

    out = {"samples": list(samples.shape[:2]), "candidates": int(vg.sum()),
           "card_vs_cpu": candidate_agreement(Eg, vg, Ec, vc),
           "card_vs_f64": candidate_agreement(Eg, vg, E64.float(), v64),
           "cpu_vs_f64": candidate_agreement(Ec, vc, E64.float(), v64),
           "epipolar_ok": {"card": epipolar_ok(Eg, vg), "cpu": epipolar_ok(Ec, vc),
                           "f64": epipolar_ok(E64, v64)}}
    out["max_abs_err"] = out["card_vs_cpu"]["max"]
    if not (out["card_vs_f64"]["found"] >= out["cpu_vs_f64"]["found"] - FIVEPOINT_SLACK
            and out["epipolar_ok"]["card"] >= out["epipolar_ok"]["cpu"] - FIVEPOINT_SLACK):
        raise AssertionError(f"the five-point on the card is less accurate than on the CPU: {out}")
    solve = lambda: tmv.mono_vo_solve(steps.matches, steps.valid, samples, cfg.vo)  # noqa: E731
    out["solve_ms_per_chunk"] = event_ms(solve)
    out["svd_ms"] = event_ms(lambda: tfp.nullspace_basis(s1, s2))
    out["candidates_ms"] = event_ms(lambda: tfp.candidates_from_basis(basis))
    out["svd_syncs"] = count_syncs(lambda: tfp.nullspace_basis(s1, s2))
    out["candidates_syncs"] = count_syncs(lambda: tfp.candidates_from_basis(basis))
    out["solve_syncs"] = count_syncs(solve)
    out["svd_kernels"], _ = device_kernels(lambda: tfp.nullspace_basis(s1, s2))
    out["candidates_kernels"], out["candidates_device_ms"] = device_kernels(
        lambda: tfp.candidates_from_basis(basis))
    out["solve_kernels"], out["solve_device_ms"] = device_kernels(solve)
    print(f"five-point at {MONO_CHUNK} steps x {samples.shape[1]} samples, one basis: card vs "
          f"CPU {out['card_vs_cpu']}; card vs float64 {out['card_vs_f64']}; CPU vs float64 "
          f"{out['cpu_vs_f64']}; share of candidates with epipolar residual < 5e-3 "
          f"{out['epipolar_ok']}; 5-point solve per "
          f"chunk {np.median(out['solve_ms_per_chunk']):.2f} ms ({out['solve_kernels']} kernels, "
          f"{out['solve_device_ms']:.2f} ms of device time, {out['solve_syncs']} syncs); "
          f"torch.linalg.svd of the (8, 200, 5, 9) batch {np.median(out['svd_ms']):.3f} ms, "
          f"{out['svd_kernels']} kernels, {out['svd_syncs']} syncs; candidates "
          f"{np.median(out['candidates_ms']):.2f} ms, {out['candidates_kernels']} kernels, "
          f"{out['candidates_syncs']} syncs; card {card}", flush=True)
    return out


def latency_config(rig, **over):
    from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig
    from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    return OdometryConfig(vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline),
                          **over)


def latency_mode(dev, rig, frames, gt, card) -> dict:
    """The latency mode (``OdometrySystem``: persistent tracks, per-frame
    VO, windowed BA every 5 keyframes) on the stereo world from host
    frames, ``OdometryConfig`` at its defaults, VO only and with BA, RANSAC
    seeds 0-2: K1 launched ``K1_PER_LATENCY_RUN`` times in the first run and
    every call of another held to plain; each run solves at least JAX's
    steps less one; each mode's median ATE within 1.5x JAX's on the CPU
    (``JAX_LATENCY``) and BA's median below 0.95x VO's. Then per mode, on
    seed 0: 3 timed runs (frames/s over the 39 steps),
    stream syncs per frame, CUDA kernels and their device time per run, K1's
    device time per run."""
    from uasl_motion_estimation_tpu_torch.models.odometry import OdometrySystem
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import metrics

    cfg = latency_config(rig)
    out: dict = {}
    for mode in ("vo", "ba"):
        use_ba = mode == "ba"
        m: dict = {"seeds": list(LATENCY_SEEDS), "ate_m": [], "n_success": [],
                   "n_keyframes": [], "ba_cost": []}
        for seed in LATENCY_SEEDS:
            log = metrics.MetricsLogger()
            system = OdometrySystem(cfg, seed=seed, logger=log, use_ba=use_ba, device=dev)
            kg.GATHER.launches = kmi.MI.launches = 0
            traj = system.run(frames)
            m.setdefault("launches", {"gather_tiles": kg.GATHER.launches,
                                      "mi_hist": kmi.MI.launches})
            if traj.shape != (N_FRAMES, 4, 4) or not np.isfinite(traj).all():
                raise AssertionError(f"latency {mode}, seed {seed}: bad trajectory {traj.shape}")
            m["ate_m"].append(float(metrics.ate_rmse(traj[:, :3, 3], gt)))
            m["n_success"].append(sum(bool(r.get("success")) for r in log.records))
            m["n_keyframes"].append(system.n_keyframes)
            m["ba_cost"].append([r["ba_cost"] for r in log.records if "ba_cost" in r])

        def run():
            OdometrySystem(cfg, seed=0, use_ba=use_ba, device=dev).run(frames)

        k1 = m["launches"]["gather_tiles"]
        if k1 != K1_PER_LATENCY_RUN:
            raise AssertionError(f"latency {mode}: {m['launches']} launches, K1 expected "
                                 f"{K1_PER_LATENCY_RUN} times")
        with GatherShim(check=True) as shim:
            run()
        check_path_k1(f"latency {mode}", shim, k1)
        m.update(k1_calls=k1, k1_held=shim.checked, k1_cases=sorted(shim.batches))
        times = timed_runs(run)  # after four runs of the same mode
        m["run_s"] = times
        m["fps"] = (N_FRAMES - 1) / float(np.median(times))
        m["syncs_per_frame"] = count_syncs(run) / N_FRAMES
        # all kernels and K1's own launches from one profiled run (the
        # profiler can drop launches: K1's time is kept only if it saw all)
        m["kernels_per_run"], m["device_ms_per_run"], k1_ms = profile_kernels(run, K1_KERNEL)
        m["k1_ms_per_run"] = sum(k1_ms) if len(k1_ms) == k1 else None
        m["idle"] = 1.0 - m["device_ms_per_run"] / (1e3 * float(np.median(times)))
        m["median_ate_m"] = float(np.median(m["ate_m"]))
        m["jax_median_ate_m"] = jax_med = float(np.median(JAX_LATENCY[mode]))
        print(f"latency mode, {mode}: {m['fps']:.2f} frames/s ({N_FRAMES - 1} steps; runs "
              f"{times} s), "
              f"{m['syncs_per_frame']:.2f} stream syncs per frame, {m['kernels_per_run']} "
              f"kernels and {m['device_ms_per_run']:.1f} ms of device time per run (idle "
              f"{100 * m['idle']:.0f} %), K1 {m['k1_calls']} launches and "
              f"{m['k1_ms_per_run']} ms per run, every call equal to plain; seeds "
              f"{list(LATENCY_SEEDS)}: ATE {np.round(m['ate_m'], 5).tolist()} m, median "
              f"{m['median_ate_m']:.5f} m (JAX on the CPU {jax_med:.5f} m, gate 1.5x), "
              f"successful steps {m['n_success']}/{N_FRAMES - 1}, keyframes "
              f"{m['n_keyframes']}, BA costs (seed 0) "
              f"{np.round(m['ba_cost'][0], 4).tolist()}; card {card}", flush=True)
        if min(m["n_success"]) < JAX_LATENCY["n_success"] - 1 \
                or not m["median_ate_m"] <= 1.5 * jax_med:
            raise AssertionError(f"latency {mode}: {m}")
        out[mode] = m
    if not out["ba"]["median_ate_m"] < 0.95 * out["vo"]["median_ate_m"]:
        raise AssertionError(f"latency: BA median ATE {out['ba']['median_ate_m']} is not below "
                             f"0.95 x VO's {out['vo']['median_ate_m']}")
    return out


def parallax_gate(dev, card) -> dict:
    """The parallax keyframe gate at full size: the near_stop stress world
    (``CameraRig()``, 18 frames, world seed 7, RANSAC seed 1, VO only) with
    ``parallax=2.0`` against ``parallax=0``: the gate holds at least 4
    frames, every frame with no gate is a keyframe, and the gated ATE is
    below max(1.2x the ungated one, 0.05 m). Every K1 call of both runs is
    held to the plain version, at a case ``check_gather`` holds."""
    from uasl_motion_estimation_tpu_torch.models.odometry import OdometrySystem
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

    rig = synthetic.CameraRig()
    n = PARALLAX_FRAMES
    seq = synthetic.SyntheticStereoSequence(
        n_frames=n, rig=rig, seed=7, trajectory=synthetic.stress_trajectory("near_stop", n))
    frames = [seq.frame(i) for i in range(n)]
    out: dict = {"frames": n}
    for parallax in (0.0, 2.0):
        log = metrics.MetricsLogger()
        system = OdometrySystem(latency_config(rig, parallax=parallax), seed=1, logger=log,
                                use_ba=False, device=dev)
        kg.GATHER.launches = 0
        with GatherShim(check=True) as shim:
            traj = system.run(frames)
        check_path_k1(f"parallax {parallax:g}", shim, kg.GATHER.launches)
        out[f"parallax_{parallax:g}"] = {
            "n_keyframes": system.n_keyframes, "launches": kg.GATHER.launches,
            "k1_held": shim.checked, "k1_cases": sorted(shim.batches),
            "ate_m": float(metrics.ate_rmse(traj[:, :3, 3], seq.gt_positions())),
            "median_flow_px": [r.get("median_flow_px") for r in log.records[1:]]}
    free, gated = out["parallax_0"], out["parallax_2"]
    print(f"parallax gate, near_stop world {rig.height}x{rig.width}, {n} frames: keyframes "
          f"{gated['n_keyframes']} gated (2 px) against {free['n_keyframes']}; ATE "
          f"{gated['ate_m']:.5f} m gated, {free['ate_m']:.5f} m not; median flows (gated) "
          f"{gated['median_flow_px']}; K1 {free['launches']} and {gated['launches']} launches, "
          f"every call equal to plain; card {card}", flush=True)
    if min(free["launches"], gated["launches"]) <= 0 or free["n_keyframes"] != n \
            or gated["n_keyframes"] > n - 4 \
            or not gated["ate_m"] < max(1.2 * free["ate_m"], 0.05):
        raise AssertionError(f"parallax gate: {out}")
    return out


def checkpoint_resume(dev, rig, frames, card) -> dict:
    """Checkpoint on the card: 20 frames with BA (seed 0), saved; a fresh
    system loads it and runs the other 20. Against the uninterrupted run:
    the same keyframe decisions and every pose within 1e-5 m."""
    import tempfile

    from uasl_motion_estimation_tpu_torch.models.odometry import OdometrySystem
    from uasl_motion_estimation_tpu_torch.utils import metrics
    from uasl_motion_estimation_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = latency_config(rig)
    log_a = metrics.MetricsLogger()
    whole = OdometrySystem(cfg, seed=0, logger=log_a, use_ba=True, device=dev).run(frames)
    log_b = metrics.MetricsLogger()
    first = OdometrySystem(cfg, seed=0, logger=log_b, use_ba=True, device=dev)
    first.run(frames[:CKPT_AT])
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ckpt.npz"
        save_checkpoint(path, first)
        resumed = OdometrySystem(cfg, seed=0, logger=log_b, use_ba=True, device=dev)
        load_checkpoint(path, resumed)
    traj = resumed.run(frames[CKPT_AT:])
    out = {"max_pose_diff_m": float(np.abs(traj[:, :3, 3] - whole[:, :3, 3]).max()),
           "max_rotation_diff": float(np.abs(traj[:, :3, :3] - whole[:, :3, :3]).max()),
           "same_keyframes": [r.get("keyframe") for r in log_a.records]
           == [r.get("keyframe") for r in log_b.records],
           "same_ba_schedule": ["ba_cost" in r for r in log_a.records]
           == ["ba_cost" in r for r in log_b.records]}
    print(f"checkpoint on the card after {CKPT_AT} frames, resumed in a fresh system: largest "
          f"position difference from the uninterrupted run {out['max_pose_diff_m']:.3g} m, "
          f"rotation {out['max_rotation_diff']:.3g}; keyframe decisions agree: "
          f"{out['same_keyframes']}, BA schedule agrees: {out['same_ba_schedule']}; card {card}",
          flush=True)
    if traj.shape != whole.shape or not out["same_keyframes"] or not out["same_ba_schedule"] \
            or not out["max_pose_diff_m"] <= 1e-5:
        raise AssertionError(f"checkpoint resume: {out}")
    return out


def p3p_phase(dev, rig, ls, rs, gt, card) -> dict:
    """Grunert P3P on the card: 200 random scenes (3 points 10-30 m deep,
    random poses), the share whose best candidate recovers the true pose
    within 1e-3 (rotation entries and translation), at least 95 %; then
    staged stereo VO with ``hyp_solver="p3p"`` on the stereo world, RANSAC
    seeds 0-2: K1 launched, every K1 call held to the plain version at a
    case ``check_gather`` holds, all steps, the median ATE within 1.5x
    JAX's on the CPU (``JAX_LATENCY["p3p"]``)."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, default_config
    from uasl_motion_estimation_tpu_torch.ops import lie, pnp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import metrics

    rng = np.random.default_rng(2)
    R = lie.so3_exp(torch.from_numpy(rng.normal(size=(P3P_SCENES, 3)) * 0.3)).numpy()
    t = rng.normal(size=(P3P_SCENES, 3))
    cam = np.stack([rng.uniform(-6, 6, (P3P_SCENES, 3)), rng.uniform(-3, 3, (P3P_SCENES, 3)),
                    rng.uniform(10, 30, (P3P_SCENES, 3))], axis=-1)
    world = np.einsum("nji,nkj->nki", R, cam - t[:, None])
    rays = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    Rc, tc, ok = (x.cpu().numpy() for x in pnp.p3p_grunert(
        torch.from_numpy(world.astype(np.float32)).to(dev),
        torch.from_numpy(rays.astype(np.float32)).to(dev)))
    err = np.maximum(np.abs(Rc - R[:, None]).max(axis=(-2, -1)),
                     np.abs(tc - t[:, None]).max(axis=-1))
    out: dict = {"scenes": P3P_SCENES,
                 "recovered": float((np.where(ok, err, np.inf).min(axis=1) < 1e-3).mean()),
                 "candidates_ok": float(ok.mean())}
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
                         hyp_solver="p3p")
    out.update(seeds=list(LATENCY_SEEDS), ate_m=[], n_success=[])
    for seed in LATENCY_SEEDS:
        log = metrics.MetricsLogger()
        kg.GATHER.launches = 0
        with GatherShim(check=True) as shim:
            traj = OdometryPipeline(cfg, seed=seed, device=dev, logger=log).run_staged(
                ls, rs, chunk=CHUNK)
        check_path_k1(f"p3p stereo, seed {seed}", shim, kg.GATHER.launches)
        out.setdefault("launches", kg.GATHER.launches)
        out.setdefault("k1_cases", sorted(shim.batches))
        if traj.shape != (N_FRAMES, 4, 4) or not np.isfinite(traj).all():
            raise AssertionError(f"p3p stereo, seed {seed}: bad trajectory {traj.shape}")
        out["ate_m"].append(float(metrics.ate_rmse(traj[:, :3, 3], gt)))
        out["n_success"].append(sum(bool(r["success"]) for r in log.records))
    out["median_ate_m"] = float(np.median(out["ate_m"]))
    out["jax_median_ate_m"] = jax_med = float(np.median(JAX_LATENCY["p3p"]))
    print(f"P3P on the card: the best candidate recovers the pose in "
          f"{100 * out['recovered']:.1f} % of {P3P_SCENES} scenes; staged stereo with "
          f"hyp_solver=p3p, seeds {list(LATENCY_SEEDS)}: ATE "
          f"{np.round(out['ate_m'], 5).tolist()} m, median {out['median_ate_m']:.5f} m (JAX on "
          f"the CPU {jax_med:.5f} m, gate 1.5x), successful steps {out['n_success']}, K1 "
          f"{out['launches']} launches a run, every call equal to plain; card {card}",
          flush=True)
    if out["recovered"] < 0.95 or out["launches"] <= 0 \
            or min(out["n_success"]) < N_FRAMES - 1 or not out["median_ate_m"] <= 1.5 * jax_med:
        raise AssertionError(f"p3p: {out}")
    return out


def cross_modal_fivepoint(dev, rig, staged, gt, card) -> dict:
    """The staged cross-modal session with ``MonoVOParams(solver="5point")``
    on the cross-modal world, RANSAC seed 0, once: K1 and K2 launched,
    every K1 call held to the plain version exactly (at a case
    ``check_gather`` holds) and every K2 call within ``K2_TOL``, at least
    JAX's successful steps less one, the median scale error within 1.5x
    JAX's on the CPU (``JAX_CM_5POINT``)."""
    from uasl_motion_estimation_tpu_torch.models.cross_modal import run_cross_modal_staged
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import metrics

    base = cross_modal_config(rig)
    cfg = base._replace(vo=base.vo._replace(solver="5point"))
    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    with GatherShim(check=True) as shim, MIShim() as mi_shim:
        res = run_cross_modal_staged(staged, cfg, seed=0, chunk=CHUNK, device=dev)
    check_path_k1("cross-modal 5point", shim, kg.GATHER.launches)
    if mi_shim.checked != kmi.MI.launches:
        raise AssertionError(f"cross-modal 5point: {kmi.MI.launches} K2 launches, "
                             f"{mi_shim.checked} held to plain")
    gt_speed = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    err = np.abs(res.scales - gt_speed) / gt_speed
    out = {"launches": {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches},
           "k2_by_mode": {"strip": kmi.MI.strip_launches,
                          "pairs": kmi.MI.launches - kmi.MI.strip_launches},
           "k1_cases": sorted(shim.batches), "k2_max_abs_err": mi_shim.worst,
           "k2_cases": {str(k): v for k, v in mi_shim.cases.items()},
           "n_success": sum(bool(r["success"]) for r in res.records),
           "scale_err_median": float(np.median(err)), "scale_err_max": float(err.max()),
           "ate_m": float(metrics.ate_rmse(res.trajectory[:, :3, 3], gt))}
    print(f"cross-modal, solver=5point (staged, seed 0): {out['n_success']}/{N_FRAMES - 1} "
          f"steps (JAX {JAX_CM_5POINT['n_success']}), scale error median "
          f"{out['scale_err_median']:.5f} (JAX {JAX_CM_5POINT['scale_err_median']:.5f}, gate "
          f"1.5x) max {out['scale_err_max']:.5f}, ATE {out['ate_m']:.5f} m (JAX "
          f"{JAX_CM_5POINT['ate_m']:.5f} m), launches {out['launches']}, K2 by mode "
          f"{out['k2_by_mode']}; every K1 call equal to plain, every K2 call within "
          f"{mi_shim.worst:.3g} of plain (tolerance {K2_TOL}); card {card}", flush=True)
    if min(out["launches"].values()) <= 0 or out["n_success"] < JAX_CM_5POINT["n_success"] - 1 \
            or not out["scale_err_median"] <= 1.5 * JAX_CM_5POINT["scale_err_median"]:
        raise AssertionError(f"cross-modal 5point: {out}")
    return out


def mono_path(dev, card) -> dict:
    """The monocular engine at full width on bench_mono's world: the staged
    engine (``run_mono_staged``, chunk 8) for each solver, the per-frame
    loop (``MonoOdometryPipeline``) for pencil8, and the hybrid with every
    step escalated (``FORCED_RATIO``); each through ``mono_engine``. All 12
    steps must succeed (as JAX's do) and each ATE lie within
    ``MONO_ATE_TOL`` of JAX's (``JAX_MONO_ATE``). Then the five-point
    (``mono_fivepoint``)."""
    from uasl_motion_estimation_tpu_torch.models.mono_pipeline import (
        MonoOdometryPipeline, run_mono_staged)
    from uasl_motion_estimation_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    rig, frames, gt = mono_world()
    print(f"rendered the mono world, {MONO_FRAMES} frames {rig.height}x{rig.width}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def staged(cfg):
        return lambda stats: run_mono_staged(frames, cfg, seed=0, initial_speed=MONO_SPEED,
                                             chunk=MONO_CHUNK, device=dev, stats=stats)

    def per_frame(cfg):
        def run(stats):
            log = metrics.MetricsLogger()
            traj = MonoOdometryPipeline(cfg, seed=0, initial_speed=MONO_SPEED, logger=log,
                                        device=dev).run(frames)
            stats["success"] = [r["success"] for r in log.records if "success" in r]
            return traj
        return run

    runs = {solver: staged(mono_config(rig, solver)) for solver in MONO_SOLVERS}
    runs["per_frame_pencil8"] = per_frame(mono_config(rig, "pencil8"))
    runs["hybrid_forced"] = staged(mono_config(rig, "hybrid", hybrid_ratio=FORCED_RATIO))
    out = {name: mono_engine(name, run, gt, card) for name, run in runs.items()}
    for name, r in out.items():
        r["jax_ate_m"] = JAX_MONO_ATE[name]
        if r["n_success"] < JAX_MONO_STEPS:
            raise AssertionError(f"mono {name}: {r['n_success']} steps succeeded, JAX "
                                 f"{JAX_MONO_STEPS}")
        if not abs(r["ate_m"] - r["jax_ate_m"]) <= MONO_ATE_TOL:
            raise AssertionError(f"mono {name}: ATE {r['ate_m']} m, JAX's {r['jax_ate_m']} m")
    if out["hybrid_forced"]["escalated"] != list(range(MONO_FRAMES - 1)):
        raise AssertionError(f"forced escalation escalated {out['hybrid_forced']['escalated']}")
    out["fivepoint"] = mono_fivepoint(dev, rig, frames, card)
    return out


def topk_stereo(dev, rig, ls, rs, gt, card) -> dict:
    """Staged stereo VO with ``detector="topk"`` on the stereo world, for
    RANSAC seeds 0-4: K1 launched in the first run and every call of
    another held to plain; all 39 steps succeed for every seed and the
    median ATE lies within 1.5x the JAX reference's median over the same
    seeds (``JAX_TOPK``)."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, default_config
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import metrics

    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)._replace(
        detector="topk")
    out: dict = {"seeds": list(TOPK_SEEDS), "ate_m": [], "n_success": []}
    for seed in TOPK_SEEDS:
        log = metrics.MetricsLogger()
        pipe = OdometryPipeline(cfg, seed=seed, device=dev, logger=log)
        kg.GATHER.launches = 0
        traj = pipe.run_staged(ls, rs, chunk=CHUNK)
        out.setdefault("launches", kg.GATHER.launches)
        if traj.shape != (N_FRAMES, 4, 4) or not np.isfinite(traj).all():
            raise AssertionError(f"stereo topk, seed {seed}: bad trajectory {traj.shape}")
        out["ate_m"].append(float(metrics.ate_rmse(traj[:, :3, 3], gt)))
        out["n_success"].append(sum(bool(r["success"]) for r in log.records))
    pipe.logger = None

    def again():
        pipe.reset()
        pipe.run_staged(ls, rs, chunk=CHUNK)

    out.update(path_k1("stereo topk", again, out["launches"]))
    out["median_ate_m"] = float(np.median(out["ate_m"]))
    out["jax_median_ate_m"] = jax_med = float(np.median(JAX_TOPK["ate_m"]))
    print(f"stereo, detector=topk, seeds {list(TOPK_SEEDS)}: ATE {np.round(out['ate_m'], 5).tolist()} "
          f"m, median {out['median_ate_m']:.5f} m (JAX on the CPU {jax_med:.5f} m, gate 1.5x); "
          f"successful steps {out['n_success']}; K1 {out['launches']} launches, every call "
          f"equal to plain; card {card}", flush=True)
    if min(out["n_success"]) < N_FRAMES - 1 or not out["median_ate_m"] <= 1.5 * jax_med:
        raise AssertionError(f"stereo topk: {out}")
    return out


def cross_modal_per_frame(dev, rig, frames, rights_cm, gt, card) -> dict:
    """The per-frame cross-modal loop (``run_cross_modal``, warm-started
    scales) on the full-size cross-modal world, once: K1 and K2 launched,
    every K1 call held to plain, all steps succeed, median scale error under
    2 %."""
    from uasl_motion_estimation_tpu_torch.models.cross_modal import run_cross_modal
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import metrics

    cfg = cross_modal_config(rig)
    pairs = [(f[0], r) for f, r in zip(frames, rights_cm)]
    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    t0 = time.perf_counter()
    res = run_cross_modal(pairs, cfg, seed=0, device=dev)
    run_s = time.perf_counter() - t0
    gt_speed = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    err = np.abs(res.scales - gt_speed) / gt_speed
    out = {"run_s": run_s, "fps": (N_FRAMES - 1) / run_s,
           "launches": {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches,
                        "mi_strip": kmi.MI.strip_launches},
           "n_success": sum(bool(r["success"]) for r in res.records),
           "scale_err_median": float(np.median(err)), "scale_err_max": float(err.max()),
           "ate_m": float(metrics.ate_rmse(res.trajectory[:, :3, 3], gt))}
    out.update(path_k1("run_cross_modal", lambda: run_cross_modal(pairs, cfg, seed=0, device=dev),
                       out["launches"]["gather_tiles"], profile=False))
    print(f"run_cross_modal (per frame): {out['n_success']}/{N_FRAMES - 1} steps, scale error "
          f"median {out['scale_err_median']:.5f} max {out['scale_err_max']:.5f}, ATE "
          f"{out['ate_m']:.5f} m, {out['fps']:.2f} frames/s (one run); launches "
          f"{out['launches']}, every K1 call equal to plain; card {card}", flush=True)
    if min(out["launches"].values()) <= 0 or out["n_success"] != N_FRAMES - 1 \
            or not out["scale_err_median"] < 0.02:
        raise AssertionError(f"run_cross_modal on the card: {out}")
    return out


def stereo_config(rig):
    from uasl_motion_estimation_tpu_torch.models.pipeline import default_config
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    return default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)


def ba_world(rig) -> dict:
    """Window-parallel BA's problem at KITTI's intrinsics and image size
    (``synthetic.stereo_ba_windows``, tests/test_parallel_ba.py's recipe):
    ``BA_POINTS`` points, 0.1 px of noise, ``BA_WINDOWS`` windows of
    ``BA_WINDOW`` frames overlapping by ``BA_FIXED``; every camera but
    window 0's head moved by 0.01 and every point by 0.3. Returns the
    problem's arrays and the true cameras."""
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rng = np.random.default_rng(1)
    n_cams = (BA_WINDOW - BA_FIXED) * (BA_WINDOWS - 1) + BA_WINDOW
    _, _, (wc, pts, obs, mask) = synthetic.stereo_ba_windows(
        rng, rig, rig.baseline, n_cams, BA_POINTS, BA_WINDOW, BA_FIXED, 0.1,
        image_shape=(rig.height, rig.width))
    wc_p, wp = synthetic.perturb_windows(wc, pts, rng, BA_FIXED)
    return {"cam": wc_p, "pts": wp, "obs": obs, "mask": mask, "truth": wc}


def ba_config(rig):
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.solvers.ba import BAConfig

    return BAConfig(intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), baseline=rig.baseline,
                    n_fixed=BA_FIXED)


def boundary_halos(cams: np.ndarray) -> list[float]:
    """Largest gap between each window's tail and its right neighbour's
    head, by boundary, for (n_windows, window, 6) cameras."""
    return [float(np.abs(cams[i, -BA_FIXED:] - cams[i + 1, :BA_FIXED]).max())
            for i in range(len(cams) - 1)]


def k1_profiled(fn):
    """(``fn()``, the device time in ms of each K1 launch ``torch.profiler``
    saw in that run)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [1e-3 * e.time_range.elapsed_us() for e in prof.events() if K1_KERNEL in e.name]


def parallel_rank(mesh, world: str, cfg, bcfg) -> dict:
    """One rank of the parallel phase (a spawned gloo rank, or the NCCL rank
    in the main process): every sharded entry point on this rank's shard of
    the worlds in ``world`` (memory-mapped ``.npy`` files), with the stereo
    configuration ``cfg`` and the BA configuration ``bcfg``. The unified
    engine takes the world's frames but the last (the VO takes them all).
    The sharded VO and unified engines run twice: first under
    ``GatherShim(check=True)`` and the profiler (K1's launches counted from
    0, every call held to the plain version, K1's device time), then timed
    by the port's ``StageTimer``; BA and the chain run twice, the second
    timed. Returns numpy results, the timer's totals, K1's figures and the
    collectives issued."""
    from uasl_motion_estimation_tpu_torch import parallel
    from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
    from uasl_motion_estimation_tpu_torch.models.smoother import SmootherConfig
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.parallel.ba_windows import (shard_windows,
                                                                      window_parallel_ba)
    from uasl_motion_estimation_tpu_torch.solvers.ba import BAProblem
    from uasl_motion_estimation_tpu_torch.utils.profiling import StageTimer

    ucfg = SmootherConfig(pipe=cfg)
    sampler = make_sampler(0, cfg.vo.n_ransac)
    ls = np.load(f"{world}/ls.npy", mmap_mode="r")
    rs = np.load(f"{world}/rs.npy", mmap_mode="r")
    timer = StageTimer()
    out: dict = {"rank": mesh.rank, "device": str(mesh.device), "k1": {}}

    def vo():
        pairs = [parallel.shard_frames(x, mesh) for x in (ls[:-1], rs[:-1], ls[1:], rs[1:])]
        return parallel.sharded_sequence_vo(*pairs, sampler, cfg, mesh)

    def unified():
        return parallel.sharded_unified_scan(ls[:-1], rs[:-1], sampler, ucfg, mesh)

    for name, fn in (("sharded_sequence_vo", vo), ("sharded_unified_scan", unified)):
        kg.GATHER.launches = 0
        with GatherShim(check=True) as shim:
            res, k1_ms = k1_profiled(fn)
        out["k1"][name] = {"launches": kg.GATHER.launches, "held": shim.checked,
                           "calls": sum(shim.counts.values()), "batches": sorted(shim.batches),
                           "ms": sum(k1_ms), "ms_launches": len(k1_ms)}
        out[name] = (tuple(x.cpu().numpy() for x in res) if name == "sharded_sequence_vo"
                     else res._asdict())
        with timer(name):
            fn()

    d = np.load(f"{world}/ba.npz")
    problem = shard_windows(BAProblem(d["cam"], d["pts"], d["obs"], d["mask"]), mesh)
    out["window_parallel_ba"] = window_parallel_ba(problem, bcfg, mesh, BA_SWEEPS).cam.cpu().numpy()
    with timer("window_parallel_ba"):
        window_parallel_ba(problem, bcfg, mesh, BA_SWEEPS)
    motions = parallel.shard_frames(np.load(f"{world}/motions.npy"), mesh)
    out["sharded_chain_motions"] = parallel.sharded_chain_motions(motions, mesh).cpu().numpy()
    with timer("sharded_chain_motions"):
        parallel.sharded_chain_motions(motions, mesh)
    out["seconds"] = dict(timer.totals)
    out["collectives"] = dict(mesh.counts)
    return out


def pose_distance_m(a, b) -> float:
    """Largest distance between the positions of two (N, 4, 4) pose stacks."""
    return float(np.linalg.norm(np.asarray(a)[:, :3, 3] - np.asarray(b)[:, :3, 3], axis=-1).max())


def check_rank_k1(tag: str, outs: list[dict]) -> dict:
    """Every rank's K1: the launches each entry point made, all held to the
    plain version by the shim, at batches check_gather holds."""
    per_path = {"sharded_sequence_vo": K1_PER_CHUNK, "sharded_unified_scan": K1_PER_GROUP}
    for o in outs:
        for name, want in per_path.items():
            k = o["k1"][name]
            if not k["launches"] == k["calls"] == k["held"] == want:
                raise AssertionError(f"{tag} rank {o['rank']} {name}: K1 {k}, want {want} "
                                     f"launches, every one held to plain")
            if not {tuple(b) for b in k["batches"]} <= held_cases():
                raise AssertionError(f"{tag} rank {o['rank']} {name}: K1 cases check_gather "
                                     f"never held: {k['batches']}")
    return {name: {"launches": [o["k1"][name]["launches"] for o in outs],
                   "held": [o["k1"][name]["held"] for o in outs],
                   "ms": [o["k1"][name]["ms"] for o in outs],
                   "batches": sorted({tuple(b) for o in outs for b in o["k1"][name]["batches"]})}
            for name in per_path}


def parallel_phase(dev, rig, frames, card) -> dict:
    """The parallel layer on the card, from ``frames`` (bench.py's 40-frame
    world), against single-process twins.

    (a) 4 gloo ranks sharing the one card (``run_ranks``; kernels built in
    this process first): ``sharded_sequence_vo`` on 41 frames, every pose
    within 1e-3 m of the staged engine's (chunk 13, the same sampler, chained
    on the host in float64), ATE < 0.1 m; ``sharded_chain_motions`` of the
    staged engine's motions within 1e-4 of the serial float64 chain;
    ``stitch_segments`` of the sharded poses (4 segments of 12 overlapping
    by 3), uniform and covariance-weighted, within 1e-3 of the chain they
    came from; ``window_parallel_ba``: shared frames within 5e-4, cameras
    within 5e-3 of the truth, and the halo by boundary beside the one-rank
    twin's and beside how far batches of 2 move one solve from a batch of 8;
    ``sharded_unified_scan`` against
    ``unified_system_scan`` (5 windows a group): VO motions within 1e-3,
    refined within 1e-2, composed positions within 1e-3 m, every window
    converged. Every K1 call in the ranks is held to its plain version.

    (b) One NCCL rank in this process: each entry point within 1e-5 of the
    same computation in one process (the VO's 40 pairs as one batch chained
    by ``chain_motions``; the chain; ``window_parallel_ba`` on a one-rank
    gloo mesh, every window in one batch; the unified
    scan with its 10 windows as one group), with its collectives counted
    and its stream syncs.

    Then ``examples/run_synthetic_torch.run`` at its default size: ATE <
    0.1 m. Stages are timed by the port's ``StageTimer``; the 4-rank wall
    times share one card and are no scaling figure."""
    import tempfile

    from uasl_motion_estimation_tpu_torch.utils.profiling import StageTimer

    shared = f"{PAR_RANKS} ranks sharing one card"
    timer = StageTimer()
    out: dict = {"card": card, "label": f"wall times of {shared}: not a scaling figure"}
    world_dir = tempfile.TemporaryDirectory(prefix="parallel-")
    try:
        return _parallel_phase(dev, rig, frames, card, world_dir.name, timer, shared, out)
    finally:
        world_dir.cleanup()


def _parallel_phase(dev, rig, frames, card, world, timer, shared, out) -> dict:
    """``parallel_phase``'s body, with its worlds written to ``world``."""
    import importlib.util
    import os
    import tempfile

    from uasl_motion_estimation_tpu_torch import parallel
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.models.smoother import (
        SmootherConfig, UnifiedOutput, compose_unified, unified_system_scan)
    from uasl_motion_estimation_tpu_torch.parallel import launch, stitching
    from uasl_motion_estimation_tpu_torch.parallel.ba_windows import window_parallel_ba
    from uasl_motion_estimation_tpu_torch.solvers.ba import BAProblem, ba_solve
    from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

    with timer("render frame 40, write the worlds"):
        seq = synthetic.SyntheticStereoSequence(n_frames=PAR_PAIRS + 1, rig=rig, seed=0)
        all_frames = list(frames[:PAR_PAIRS]) + [seq.frame(PAR_PAIRS)]
        ls = np.clip(np.stack([f[0] for f in all_frames]), 0, 255).astype(np.uint8)
        rs = np.clip(np.stack([f[1] for f in all_frames]), 0, 255).astype(np.uint8)
        np.save(f"{world}/ls.npy", ls)
        np.save(f"{world}/rs.npy", rs)
        ba = ba_world(rig)
        np.savez(f"{world}/ba.npz", **{k: ba[k] for k in ("cam", "pts", "obs", "mask")})
    gt = seq.gt_positions()
    cfg = stereo_config(rig)
    ucfg = SmootherConfig(pipe=cfg)
    bcfg = ba_config(rig)
    sampler = tp.make_sampler(0, cfg.vo.n_ransac)
    ls_d, rs_d = torch.from_numpy(ls).to(dev), torch.from_numpy(rs).to(dev)
    ba_prob = BAProblem(*(torch.from_numpy(ba[k]).to(dev) for k in ("cam", "pts", "obs", "mask")))

    # the single-process twins, each run once for its result and once timed;
    # BA's is window_parallel_ba on a one-rank mesh: all 8 windows in one batch
    with tempfile.TemporaryDirectory(prefix="twin-") as d, \
            launch.process_group("gloo", 1, 0, f"{d}/store"):
        mesh1 = launch.make_mesh(1, device=dev)
        twins = {
            "sharded_sequence_vo": lambda: tp._vo_scan_packed(ls_d, rs_d, 0, sampler, cfg,
                                                              CHUNK).cpu().numpy(),
            "sharded_unified_scan": lambda: unified_system_scan(
                ls_d[:-1], rs_d[:-1], sampler, ucfg, wchunk=UNIFIED_WCHUNK),
            "window_parallel_ba": lambda: window_parallel_ba(ba_prob, bcfg, mesh1,
                                                             BA_SWEEPS).cam.cpu().numpy(),
        }
        twin = {}
        for name, fn in twins.items():
            twin[name] = fn()
            with timer(f"twin of {name}"):
                fn()
    # how far batching alone moves one solve: the 8 windows in batches of 2
    # (a rank's batch) against one batch of 8
    one = ba_solve(ba_prob, bcfg).cam
    per = BA_WINDOWS // PAR_RANKS
    by_rank = torch.cat([ba_solve(BAProblem(*(x[i:i + per] for x in ba_prob)), bcfg).cam
                         for i in range(0, BA_WINDOWS, per)])
    ba_batch = float((one - by_rank).abs().max())
    packed = twin["sharded_sequence_vo"]
    ok = packed[:, 16] > 0.5
    motions = np.where(ok[:, None, None], packed[:, :16].reshape(-1, 4, 4), np.eye(4))
    np.save(f"{world}/motions.npy", motions.astype(np.float32))
    serial = [np.eye(4)]
    for m in motions.astype(np.float64):
        serial.append(serial[-1] @ np.linalg.inv(m))
    serial = np.stack(serial)  # (41, 4, 4): frame 0 and the 40 poses
    with timer("twin of sharded_chain_motions"):
        parallel.chain_motions(torch.from_numpy(motions.astype(np.float32)).to(dev))

    # (a) 4 gloo ranks on the one card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with timer(f"run_ranks: {shared} over gloo, spawn included"):
        ranks = launch.run_ranks(parallel_rank, PAR_RANKS, "gloo", None, world, cfg, bcfg,
                                 timeout=900)
    if [r["device"] for r in ranks] != [str(dev)] * PAR_RANKS:
        raise AssertionError(f"the ranks ran on {[r['device'] for r in ranks]}")
    k1 = check_rank_k1("gloo", ranks)
    poses, success, n_inl, cov = (np.concatenate([r["sharded_sequence_vo"][k] for r in ranks])
                                  for k in range(4))
    chain = np.concatenate([np.eye(4, dtype=np.float32)[None], poses])
    vo_dev = pose_distance_m(chain, serial)
    vo_ate = float(metrics.ate_rmse(chain[:, :3, 3], gt))
    chain_err = float(np.abs(np.concatenate([r["sharded_chain_motions"] for r in ranks])
                             - serial[1:]).max())
    ba_cams = np.concatenate([r["window_parallel_ba"] for r in ranks])
    halos = {"ranks": boundary_halos(ba_cams),
             "twin": boundary_halos(twin["window_parallel_ba"])}
    halo = max(halos["ranks"])
    ba_truth = float(np.abs(ba_cams - ba["truth"]).max())
    ba_twin = float(np.abs(ba_cams - twin["window_parallel_ba"]).max())
    uni = UnifiedOutput(**ranks[0]["sharded_unified_scan"])
    for r in ranks[1:]:
        for key, v in r["sharded_unified_scan"].items():
            if not np.array_equal(v, getattr(uni, key)):
                raise AssertionError(f"rank {r['rank']} gathered another {key} than rank 0")
    uni_twin = twin["sharded_unified_scan"]
    if uni.vo_motions.shape != uni_twin.vo_motions.shape:
        raise AssertionError(f"sharded unified: {uni.vo_motions.shape} windows, the twin "
                             f"{uni_twin.vo_motions.shape}")
    uni_vo = float(np.abs(uni.vo_motions - uni_twin.vo_motions).max())
    uni_ref = float(np.abs(uni.refined_motions - uni_twin.refined_motions).max())
    res_s, res_t = (compose_unified(u, PAR_PAIRS, ucfg) for u in (uni, uni_twin))
    uni_traj = pose_distance_m(res_s.traj_ba, res_t.traj_ba)

    # covariance-weighted stitching of the sharded chain, on the card
    seg_len = (PAR_PAIRS - 1 - STITCH_OVERLAP) // STITCH_SEGMENTS + STITCH_OVERLAP
    step = seg_len - STITCH_OVERLAP
    n_st = STITCH_SEGMENTS * step + STITCH_OVERLAP
    chain_d = torch.from_numpy(chain).to(dev)
    segs = torch.stack([torch.linalg.inv(chain_d[s * step]) @ chain_d[s * step:s * step + seg_len]
                        for s in range(STITCH_SEGMENTS)])
    chain64 = chain.astype(np.float64)
    seg_motions = np.stack([np.linalg.inv(np.linalg.inv(chain64[i]) @ chain64[i + 1])
                            for i in range(PAR_PAIRS)])
    seg_cov = [stitching.chain_covariances_np(seg_motions[s * step:s * step + seg_len - 1],
                                              cov[s * step:s * step + seg_len - 1])
               for s in range(STITCH_SEGMENTS)]
    weights = np.stack([stitching.overlap_weights_np(seg_cov[s][seg_len - STITCH_OVERLAP:],
                                                     seg_cov[s + 1][:STITCH_OVERLAP])
                        for s in range(STITCH_SEGMENTS - 1)])
    stitch = {}
    for kind, w in (("uniform", None), ("weighted", torch.from_numpy(weights).float().to(dev))):
        with timer(f"stitch_segments ({kind})"):
            st = stitching.stitch_segments(segs, STITCH_OVERLAP, w).cpu().numpy()
        stitch[kind] = float(np.abs(st - chain[:n_st]).max())
    gates = {"vo_pose_m": vo_dev, "vo_ate_m": vo_ate, "chain": chain_err,
             "stitch": max(stitch.values()), "halo": halo, "ba_truth": ba_truth,
             "vo_motions": uni_vo, "refined_motions": uni_ref, "traj_ba_m": uni_traj}
    seconds = {name: [r["seconds"][name] for r in ranks] for name in ranks[0]["seconds"]}
    out["gloo"] = {"gates": gates, "limits": PAR_GATES, "n_success": int(success.sum()),
                   "stitch": stitch, "ba_vs_twin": ba_twin, "ba_halos": halos,
                   "ba_batch2_vs_batch8": ba_batch, "k1": k1,
                   "converged": int(res_s.ba_converged.sum()), "seconds_by_rank": seconds,
                   "collectives": ranks[0]["collectives"]}
    print(f"parallel, {shared} over gloo: sharded_sequence_vo {int(success.sum())}/{PAR_PAIRS} "
          f"pairs solved (inliers min {int(n_inl.min())}), poses vs the staged engine "
          f"{vo_dev:.3g} m (gate 1e-3), ATE {vo_ate:.5f} m (gate 0.1); sharded_chain_motions "
          f"vs serial float64 {chain_err:.3g} (gate 1e-4); stitch_segments vs the chain: "
          f"uniform {stitch['uniform']:.3g}, weighted {stitch['weighted']:.3g} (gate 1e-3; "
          f"weights {np.array2string(weights, precision=3)}); window_parallel_ba halo "
          f"{halo:.3g} (gate 5e-4), vs truth {ba_truth:.3g} (gate 5e-3), vs the one-batch twin "
          f"{ba_twin:.3g}; sharded_unified_scan vs unified_system_scan: VO motions "
          f"{uni_vo:.3g} (gate 1e-3), refined {uni_ref:.3g} (gate 1e-2), composed positions "
          f"{uni_traj:.3g} m (gate 1e-3), converged {int(res_s.ba_converged.sum())}/"
          f"{len(res_s.ba_converged)}; collectives per rank {ranks[0]['collectives']}", flush=True)
    print(f"parallel, {shared}: window_parallel_ba halo by boundary, 4 ranks "
          f"{[float(f'{h:.3g}') for h in halos['ranks']]} (boundaries 1, 3, 5 cross ranks), "
          f"the one-batch twin {[float(f'{h:.3g}') for h in halos['twin']]}; one solve of the "
          f"start, batches of {per} against one batch of {BA_WINDOWS}: {ba_batch:.3g}", flush=True)
    for name, secs in seconds.items():
        twin_s = timer.totals.get(f"twin of {name}")
        print(f"parallel, {shared}: {name} wall {np.round(secs, 4).tolist()} s by rank, the "
              f"single-process twin {twin_s:.4f} s; card {card}")
    print(f"parallel, {shared}: K1 launches by rank {k1['sharded_sequence_vo']['launches']} "
          f"(VO) and {k1['sharded_unified_scan']['launches']} (unified), every call equal to "
          f"plain; K1 device ms by rank {k1['sharded_sequence_vo']['ms']} and "
          f"{k1['sharded_unified_scan']['ms']} (torch.profiler); batches "
          f"{k1['sharded_sequence_vo']['batches'] + k1['sharded_unified_scan']['batches']}")
    failed = {k: v for k, v in gates.items() if not v < PAR_GATES[k]}
    if any(r["collectives"] != RANK_COLLECTIVES[PAR_RANKS] for r in ranks):
        failed["collectives"] = [r["collectives"] for r in ranks]
    if failed or res_s.ba_converged.sum() != len(res_s.ba_converged):
        raise AssertionError(f"parallel phase, gloo ranks: gates failed {failed} "
                             f"(limits {PAR_GATES}), converged {res_s.ba_converged}")

    # (b) one NCCL rank in this process
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="nccl-") as d, \
            launch.process_group("nccl", 1, 0, f"{d}/store"):
        mesh = launch.make_mesh(1)
        with timer("one NCCL rank: every entry point, twice"):
            nccl = parallel_rank(mesh, world, cfg, bcfg)
        counts = dict(mesh.counts)
        lsn, rsn = (np.load(f"{world}/{x}.npy", mmap_mode="r") for x in ("ls", "rs"))
        nccl_syncs = {
            "sharded_sequence_vo": count_syncs(lambda: parallel.sharded_sequence_vo(
                *(parallel.shard_frames(x, mesh) for x in (lsn[:-1], rsn[:-1], lsn[1:], rsn[1:])),
                sampler, cfg, mesh)),
            "sharded_unified_scan": count_syncs(lambda: parallel.sharded_unified_scan(
                lsn[:-1], rsn[:-1], sampler, ucfg, mesh)),
        }
    k1_nccl = check_rank_k1("nccl", [nccl])
    out_vo = tp._step(*(x.float() for x in (ls_d[:-1], rs_d[:-1], ls_d[1:], rs_d[1:])),
                      list(range(PAR_PAIRS)), sampler, cfg)
    eye = torch.eye(4, device=dev)
    one_batch = parallel.chain_motions(torch.where(out_vo.success[:, None, None], out_vo.motion,
                                                   eye)).cpu().numpy()
    uni1 = unified_system_scan(ls_d[:-1], rs_d[:-1], sampler, ucfg,
                               wchunk=PAR_UNIFIED_WINDOWS)
    uni_n = UnifiedOutput(**nccl["sharded_unified_scan"])
    chain1 = parallel.chain_motions(torch.from_numpy(motions.astype(np.float32)).to(dev))
    nccl_err = {
        "sharded_sequence_vo": float(np.abs(nccl["sharded_sequence_vo"][0] - one_batch).max()),
        "sharded_chain_motions": float(np.abs(nccl["sharded_chain_motions"]
                                              - chain1.cpu().numpy()).max()),
        "window_parallel_ba": float(np.abs(nccl["window_parallel_ba"]
                                           - twin["window_parallel_ba"]).max()),
        "sharded_unified_scan": max(float(np.abs(getattr(uni_n, k) - getattr(uni1, k)).max())
                                    for k in ("vo_motions", "refined_motions")),
    }
    out["nccl"] = {"max_abs_err": nccl_err, "tolerance": NCCL_TOL, "collectives": counts,
                   "syncs": nccl_syncs, "k1": k1_nccl, "seconds": nccl["seconds"]}
    print(f"parallel, one NCCL rank: against the same computation in one process "
          f"{ {k: float(f'{v:.3g}') for k, v in nccl_err.items()} } (tolerance {NCCL_TOL}); "
          f"NCCL collectives issued {counts}; stream syncs {nccl_syncs}; K1 launches "
          f"{k1_nccl['sharded_sequence_vo']['launches'] + k1_nccl['sharded_unified_scan']['launches']}"
          f", every call equal to plain; wall s "
          f"{ {k: round(v, 4) for k, v in nccl['seconds'].items()} }; card {card}", flush=True)
    if any(not v <= NCCL_TOL for v in nccl_err.values()) or counts != RANK_COLLECTIVES[1] \
            or not np.array_equal(nccl["sharded_sequence_vo"][1], out_vo.success.cpu().numpy()):
        raise AssertionError(f"parallel phase, NCCL rank: {nccl_err}, collectives {counts}")
    out["launches"] = {"gloo_ranks": sum(sum(v["launches"]) for v in k1.values()),
                       "nccl_rank": sum(sum(v["launches"]) for v in k1_nccl.values())}

    # the port's synthetic example, on the card
    spec = importlib.util.spec_from_file_location(
        "run_synthetic_torch", Path(__file__).resolve().parent / "examples" / "run_synthetic_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory(prefix="example-") as d, \
            timer(f"examples/run_synthetic_torch.run({EXAMPLE_FRAMES})"):
        ex = example.run(EXAMPLE_FRAMES, d, dev)
    out["example"] = {"frames": EXAMPLE_FRAMES, "ate_m": ex["ate_m"], "rpe_t_m": ex["rpe_t_m"]}
    print(f"examples/run_synthetic_torch.run({EXAMPLE_FRAMES}) on the card: ATE "
          f"{ex['ate_m']:.5f} m over {ex['path_m']:.1f} m (gate {EXAMPLE_ATE_M}), RPE "
          f"{100 * ex['rpe_t_m']:.2f} cm/frame", flush=True)
    if not ex["ate_m"] < EXAMPLE_ATE_M:
        raise AssertionError(f"the synthetic example's ATE {ex['ate_m']} m")
    out["stage_seconds"] = dict(timer.totals)
    print(f"parallel phase stages (the port's StageTimer, synchronised; {shared} in the "
          f"run_ranks stage); card {card}:\n{timer.report()}", flush=True)
    return out


class DrawsSampler:
    """The sampler seam fed JAX's RANSAC draws: (steps, H, T) index orders,
    each row the slots by descending Gumbel noise (all N of them, or the
    first T). A hypothesis takes the first ``k`` valid slots of its row,
    which is what JAX's Gumbel-top-k picks on the same valid mask.
    ``deepest`` keeps the largest row position a pick reached, so a dump
    cut to its first T slots can be shown to hold every pick; a call whose
    picks a cut row cannot hold raises."""

    def __init__(self, orders: np.ndarray, device, k: int = 3):
        self.orders = torch.from_numpy(orders.astype(np.int64)).to(device)
        self.k, self.deepest = k, 0

    def __call__(self, step: int, valid: torch.Tensor) -> torch.Tensor:
        perm = self.orders[step]  # (H, T)
        ok = valid[perm]
        first = torch.argsort((~ok).to(torch.int8), dim=-1, stable=True)[:, :self.k]
        self.deepest = max(self.deepest, int(first[:, -1].max()))
        if perm.shape[-1] < valid.shape[-1]:
            need = min(self.k, int(valid.sum()))
            if int(ok.sum(-1).min()) < need:
                raise ValueError(f"step {step}: a row of the first {perm.shape[-1]} slots holds "
                                 f"fewer than {need} valid slots; dump more of each order")
        return torch.gather(perm, 1, first)


def load_draws(name: str, seed: int) -> np.ndarray:
    """JAX's dumped draw orders ``DRAWS_DIR/{name}_draws_seed{seed}.npy``."""
    return np.load(Path(__file__).resolve().parent / DRAWS_DIR / f"{name}_draws_seed{seed}.npy")


def stress_world(kind: str):
    """stress_worlds.py's world of one regime, by the port's renderer:
    (sequence, frames)."""
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig, n = small_rig(), STRESS_FRAMES
    if kind == "low_texture":
        seq = synthetic.SyntheticStereoSequence(n_frames=n, rig=rig, seed=7,
                                                low_texture_band=(12.0, 22.0))
    elif kind.startswith("turn_"):
        rate = float(kind.split("_")[1].rstrip("deg"))
        seq = synthetic.SyntheticStereoSequence(
            n_frames=n, rig=rig, seed=7, hall_half_width=45.0,
            trajectory=synthetic.stress_trajectory("sharp_turn", n, turn_rate_deg=rate))
    else:
        seq = synthetic.SyntheticStereoSequence(
            n_frames=n, rig=rig, seed=7, trajectory=synthetic.stress_trajectory(kind, n))
    return seq, [seq.frame(i) for i in range(n)]


def stress_configs():
    """(the default pipeline configuration, the stress KLT profile) of
    stress_worlds.py: 256 features; 5 levels, 14 and 6 iterations, tile
    margin 7, 150 px displacement."""
    from uasl_motion_estimation_tpu_torch.models.frontend import KLTConfig
    from uasl_motion_estimation_tpu_torch.models.pipeline import default_config
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    rig = small_rig()
    base = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                          rig.baseline)._replace(max_features=256)
    return base, base._replace(klt=KLTConfig(n_levels=5, iters=14, iters_coarse=6,
                                             tile_margin=7, max_displacement=150.0))


def stress_staged(frames, cfg, seed: int, dev) -> np.ndarray:
    """stress_worlds.py's staged VO: ``run_staged(chunk=8)``."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg, seed=seed, device=dev)
    return pipe.run_staged(*pipe.stage_frames(frames), chunk=STRESS_CHUNK)


def stress_unified(frames, cfg, seed: int, dev, sampler=None):
    """stress_worlds.py's unified run: ``run_unified_system`` at its defaults."""
    from uasl_motion_estimation_tpu_torch.models.smoother import SmootherConfig, run_unified_system

    return run_unified_system(frames, SmootherConfig(pipe=cfg), seed=seed, wchunk=STRESS_WCHUNK,
                              device=dev, sampler=sampler)


def stress_tile_cold(calls, dev, card) -> dict:
    """K1 cold (L2 flushed, median of ``COLD_REPS``) at the stress profile's
    26x26 tile, through the generic instantiation, beside the 22x22 tile's
    template instantiation on the same images and anchors, each with the
    bound of the bytes those anchors need (``gather_bytes``): the first
    call at each of the 5 pyramid levels the turn_10deg staged run made."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out, seen = {}, set()
    for img, anc, th, tw in calls:
        h, w = img.shape[-2:]
        if (th, tw) != STRESS_TILE or (h, w) in seen:
            continue
        seen.add((h, w))
        img3 = img.reshape(-1, h, w)
        anc3 = anc.reshape(img3.shape[0], -1, 2)
        row = {"batch": img3.shape[0], "tiles": anc3.shape[1]}
        for tile in (STRESS_TILE, (22, 22)):
            name = f"{tile[0]}x{tile[1]}"
            row[f"{name}_ms"] = cold_ms(lambda tile=tile: kg.gather_tiles(img3, anc3, *tile),
                                        flush)
            row[f"{name}_bound_ms"] = 1e3 * kg.gather_bytes(anc3, h, w, *tile) / HBM_BYTES_PER_S
        out[f"{h}x{w}"] = row
    print(f"K1 cold at the stress KLT tile, 26x26 (generic instantiation) beside 22x22 (its "
          f"template), on the turn_10deg staged run's anchors, ms by level: "
          f"{json.dumps(out)}; card {card}", flush=True)
    if len(out) != len(STRESS_LEVELS):
        raise AssertionError(f"the stress run gathered 26x26 tiles at {sorted(out)}, not at "
                             f"all {len(STRESS_LEVELS)} levels")
    return out


def stress_worlds_phase(dev, card) -> dict:
    """The five stress worlds of ``benchmarks/stress_worlds.py`` on the card:
    each regime staged (seed 0) and unified (seed 1) as that benchmark runs
    them, under its gates; turn_10deg on the stress KLT profile, staged also
    on the default profile (recorded, not gated), unified for RANSAC seeds
    0-5 with the median after BA within 1.5x JAX's (``JAX_STRESS``). Every
    K1 call of every run is held to the plain version exactly, at a case
    ``check_gather`` holds (the 26x26 tile at 5 levels among them). Then K1
    cold at 26x26 beside 22x22."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import metrics

    base, stress = stress_configs()
    out: dict = {"launches": 0, "k1_held": 0, "k1_cases": set()}

    def held(name, fn, keep=0):
        kg.GATHER.launches = 0
        with GatherShim(keep=keep, check=True) as shim:
            result = fn()
        check_path_k1(name, shim, kg.GATHER.launches)
        out["launches"] += kg.GATHER.launches
        out["k1_held"] += shim.checked
        out["k1_cases"] |= shim.batches
        return result, shim

    for kind in STRESS_REGIMES:
        seq, frames = stress_world(kind)
        gt = seq.gt_positions()
        cfg = stress if kind == "turn_10deg" else base
        jax_r, gate = JAX_STRESS[kind], STRESS_GATES[kind]
        traj, shim = held(f"{kind} staged", lambda: stress_staged(frames, cfg, 0, dev),
                          keep=10**4 if kind == "turn_10deg" else 0)
        row = {"path_m": float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()),
               "vo_ate_m": float(metrics.ate_rmse(traj[:, :3, 3], gt))}
        if kind == "turn_10deg":
            out["k1_cold"] = stress_tile_cold(shim.calls, dev, card)
            out["k1_levels"] = sorted({k[2:] for k in shim.counts if k[:2] == STRESS_TILE},
                                      reverse=True)
            traj_d = stress_staged(frames, base, 0, dev)
            row["vo_ate_default_cfg_m"] = float(metrics.ate_rmse(traj_d[:, :3, 3], gt))
        seeds = STRESS_SEEDS if kind == "turn_10deg" else (1,)
        per_seed = {}
        for seed in seeds:
            res, _ = held(f"{kind} unified seed {seed}",
                          lambda seed=seed: stress_unified(frames, cfg, seed, dev))
            ate_vo, ate_ba = unified_ates(res, gt)
            per_seed[seed] = {"ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                              "vo_success": int((res.per_frame[:, 16] > 0.5).sum()),
                              "ba_converged": int(res.ba_converged.sum()),
                              "windows": len(res.ba_converged)}
        row["unified"] = per_seed
        u = per_seed[1]
        row["pass"] = bool(row["vo_ate_m"] < gate and u["ate_ba_m"] < 1.5 * gate)
        print(f"stress {kind} ({row['path_m']:.1f} m): staged VO ATE {row['vo_ate_m']:.5f} m "
              f"(JAX seed 0 {jax_r['vo_ate_m'][0]:.5f}, gate {gate}); unified seed 1 ATE VO "
              f"{u['ate_vo_m']:.5f} m, after BA {u['ate_ba_m']:.5f} m (JAX "
              f"{jax_r['unified_ate_vo_m'][1]:.5f}, {jax_r['unified_ate_ba_m'][1]:.5f} m; gate "
              f"{1.5 * gate:.3f}), motions {u['vo_success']}/{STRESS_FRAMES - 1}, BA converged "
              f"{u['ba_converged']}/{u['windows']}"
              + (f"; the default profile's staged VO ATE {row['vo_ate_default_cfg_m']:.5f} m "
                 f"(JAX {jax_r['vo_ate_default_cfg_m'][0]:.5f})" if kind == "turn_10deg" else "")
              + f"; card {card}", flush=True)
        if kind == "turn_10deg":
            for tag, n in (("", len(seeds)), ("_0_5", STRESS_PRINTED)):
                for k in ("ate_vo_m", "ate_ba_m"):
                    row[f"median{tag}_{k}"] = float(np.median([per_seed[i][k]
                                                               for i in seeds[:n]]))
                    row[f"jax_median{tag}_{k}"] = float(np.median(jax_r[f"unified_{k}"][:n]))
                print(f"stress turn_10deg unified over seeds {seeds[0]}-{seeds[n - 1]}: ATE VO "
                      f"{[round(per_seed[i]['ate_vo_m'], 5) for i in seeds[:n]]} m, after BA "
                      f"{[round(per_seed[i]['ate_ba_m'], 5) for i in seeds[:n]]} m; medians "
                      f"{row[f'median{tag}_ate_vo_m']:.5f} / {row[f'median{tag}_ate_ba_m']:.5f} "
                      f"m (JAX {row[f'jax_median{tag}_ate_vo_m']:.5f} / "
                      f"{row[f'jax_median{tag}_ate_ba_m']:.5f} m"
                      + (", gate 1.5x after BA)" if not tag else "; not gated)"), flush=True)
            if not row["median_ate_ba_m"] <= 1.5 * row["jax_median_ate_ba_m"]:
                raise AssertionError(f"stress turn_10deg: unified median ATE after BA "
                                     f"{row['median_ate_ba_m']} m > 1.5 x JAX's")
        if not row["pass"]:
            raise AssertionError(f"stress {kind} fails stress_worlds.py's gates: {row}")
        out[kind] = row
    if out["k1_levels"] != STRESS_LEVELS:
        raise AssertionError(f"the stress profile gathered 26x26 tiles at {out['k1_levels']}")
    out["k1_cases"] = sorted(out["k1_cases"])
    print(f"stress worlds: K1 {out['launches']} launches, every one held to plain exactly "
          f"({out['k1_held']}), 26x26 at levels {out['k1_levels']}", flush=True)
    return out


def _render_long(args) -> tuple[np.ndarray, np.ndarray]:
    """Frames lo..hi-1 of the long sequence's world as uint8 (left, right)
    stacks (one process of ``LongRender``'s pool)."""
    n_frames, lo, hi = args
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    seq = synthetic.SyntheticStereoSequence(n_frames=n_frames, rig=synthetic.CameraRig(), seed=0,
                                            corruption=synthetic.CorruptionConfig())
    pairs = [seq.frame(i) for i in range(lo, hi)]
    return tuple(np.clip(np.stack([p[k] for p in pairs]), 0, 255).astype(np.uint8)
                 for k in (0, 1))


class LongRender:
    """The long sequence's world, rendered in ``workers`` spawned processes
    while the card runs other phases (one process would take ~7 min).
    ``get`` waits for it: (lefts, rights) uint8 (n, H, W), the true
    positions and the seconds from the start; ``close`` ends the processes."""

    def __init__(self, n_frames: int, workers: int = 7):
        import multiprocessing as mp

        self.n_frames, self.t0 = n_frames, time.perf_counter()
        bounds = np.linspace(0, n_frames, 4 * workers + 1).astype(int)
        self.pool = mp.get_context("spawn").Pool(workers)
        self.parts = self.pool.map_async(_render_long, [(n_frames, int(a), int(b))
                                                        for a, b in zip(bounds[:-1], bounds[1:])])

    def get(self):
        from uasl_motion_estimation_tpu_torch.utils import synthetic

        parts = self.parts.get()
        seconds = time.perf_counter() - self.t0
        self.close()
        seq = synthetic.SyntheticStereoSequence(n_frames=self.n_frames, rig=synthetic.CameraRig(),
                                                seed=0, corruption=synthetic.CorruptionConfig())
        return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                seq.gt_positions(), seconds)

    def close(self):
        self.pool.terminate()
        self.pool.join()


def super_chunks(n_frames: int, span: int, advance: int) -> int:
    """The super-chunks ``run_unified_streaming`` makes of ``n_frames``
    frames (its ``stacks``: full spans, then a padded tail)."""
    full = max(0, (n_frames - span) // advance + 1)
    left = n_frames - full * advance
    return full + int(left > span - advance or (full == 0 and n_frames > 1))


def long_sequence_phase(dev, card, render: LongRender) -> dict:
    """The 501-frame KITTI-size corrupted world of
    ``benchmarks/long_sequence.py`` (``render``, started before the stress
    and witness phases); staged
    (``unified_system_scan`` on 467 MB of uint8 frames on the card, 5
    windows a group) for RANSAC seeds 0-2 and streaming
    (``run_unified_streaming``, 2 groups a super-chunk) for seed 0. Gates:
    every window converged, ATE after BA below VO's in every run, streaming
    equal to staged within ``LONG_STREAM_TOL`` on every frame, the median
    ATE after BA within 1.5x JAX's (``JAX_LONG``), the streaming run's peak
    device memory at 501 frames within ``LONG_MEMORY_TOL`` of the same run's
    at 121 frames, and K1's launches those the code makes (52 a group of 5
    windows). Seed 0's staged run is timed and counted, seed 1's syncs are
    counted, and seed 2's K1 calls are each held to the plain version.
    Prints frames/s, syncs, upload MB and, per window, the agreement with
    JAX's outputs (``LONG_DUMP``: equal ``vo_success``, median ratio of
    inliers): a diagnostic, since the draws differ."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
    from uasl_motion_estimation_tpu_torch.models.smoother import (
        compose_unified, run_unified_streaming, unified_system_scan, unified_window_starts)
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    n = LONG_FRAMES
    t0 = time.perf_counter()
    lefts, rights, gt, render_s = render.get()
    out: dict = {"frames": n, "render_s": render_s, "render_wait_s": time.perf_counter() - t0,
                 "path_m": float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())}
    cfg = unified_config(synthetic.CameraRig())
    windows = len(unified_window_starts(n, cfg.window, cfg.ba_rate))
    t0 = time.perf_counter()
    ls, rs = torch.from_numpy(lefts).to(dev), torch.from_numpy(rights).to(dev)
    torch.cuda.synchronize()
    out["staged_upload"] = {"mb": (ls.nbytes + rs.nbytes) / 1e6, "s": time.perf_counter() - t0}
    runs, scans = [], {}
    for seed in LONG_SEEDS:
        sampler = make_sampler(seed, cfg.pipe.vo.n_ransac)

        def scan(sampler=sampler):
            return unified_system_scan(ls, rs, sampler, cfg, wchunk=UNIFIED_WCHUNK)

        kg.GATHER.launches = 0
        t0 = time.perf_counter()
        if seed == LONG_SEEDS[1]:
            box = []
            out["syncs"] = count_syncs(lambda: box.append(scan()))
            got = box[0]
        elif seed == LONG_SEEDS[2]:
            with GatherShim(check=True) as shim:
                got = scan()
            check_path_k1(f"long sequence seed {seed}", shim, kg.GATHER.launches)
            out["k1_held"], out["k1_cases"] = shim.checked, sorted(shim.batches)
        else:
            got = scan()
            out["run_s"] = time.perf_counter() - t0
            out["fps"] = (n - 1) / out["run_s"]
            out["launches"] = kg.GATHER.launches
        res = compose_unified(got, n, cfg)
        scans[seed] = (got, res)
        ate_vo, ate_ba = unified_ates(res, gt)
        runs.append({"seed": seed, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                     "converged": int(res.ba_converged.sum()), "windows": len(res.ba_converged),
                     "vo_success": int((res.per_frame[:, 16] > 0.5).sum()),
                     "seconds": time.perf_counter() - t0})
        print(f"long sequence ({n} frames {out['path_m']:.1f} m), staged, seed {seed}: ATE VO "
              f"{ate_vo:.4f} m, after BA {ate_ba:.4f} m; BA converged "
              f"{runs[-1]['converged']}/{runs[-1]['windows']}; motions "
              f"{runs[-1]['vo_success']}/{n - 1}; {runs[-1]['seconds']:.2f} s", flush=True)
    out["staged"] = runs
    k1_want = K1_PER_GROUP * -(-windows // UNIFIED_WCHUNK)
    if out["launches"] != k1_want:
        raise AssertionError(f"long sequence: K1 launched {out['launches']} times, the code "
                             f"makes {k1_want}")
    del ls, rs

    # per window, against JAX's outputs on its seed 0 (other draws)
    dump = np.load(Path(__file__).resolve().parent / LONG_DUMP)
    mine = scans[0][0]
    both = (mine.vo_n_inliers > 0) & (dump["vo_n_inliers"] > 0)
    out["vs_jax_dump"] = {
        "vo_success_equal": float(np.mean(mine.vo_success == dump["vo_success"])),
        "median_inlier_ratio": float(np.median(mine.vo_n_inliers[both]
                                               / dump["vo_n_inliers"][both])),
        "median_ba_cost_ratio": float(np.median(mine.ba_cost[dump["ba_cost"] > 0]
                                                / dump["ba_cost"][dump["ba_cost"] > 0])),
        "jax_converged": int(JAX_LONG["converged"])}

    # streaming, seed 0, from host frames; its peak device memory at 501 and
    # at 121 frames
    st_frames = list(zip(lefts, rights))
    span = (LONG_GROUPS * UNIFIED_WCHUNK - 1) * cfg.ba_rate + cfg.window
    advance = LONG_GROUPS * UNIFIED_WCHUNK * cfg.ba_rate
    peaks, stream = {}, {}
    for m in (n, LONG_SHORT_FRAMES):
        stats: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kg.GATHER.launches = 0
        t0 = time.perf_counter()
        res = run_unified_streaming(iter(st_frames[:m]), cfg, seed=LONG_SEEDS[0],
                                    wchunk=UNIFIED_WCHUNK, groups=LONG_GROUPS, stats=stats,
                                    device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peaks[m] = torch.cuda.max_memory_allocated() - base
        want = K1_PER_GROUP * LONG_GROUPS * super_chunks(m, span, advance)
        if kg.GATHER.launches != want:
            raise AssertionError(f"streaming {m} frames: K1 launched {kg.GATHER.launches} "
                                 f"times, the code makes {want}")
        if m == n:
            staged_res = scans[LONG_SEEDS[0]][1]
            ate_vo, ate_ba = unified_ates(res, gt)
            stream = {"launches": kg.GATHER.launches, "seconds": seconds,
                      "fps_end_to_end": (n - 1) / seconds, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                      "converged": int(res.ba_converged.sum()),
                      "max_diff_vs_staged_m": max(
                          float(np.abs(res.traj_vo - staged_res.traj_vo).max()),
                          float(np.abs(res.traj_ba - staged_res.traj_ba).max())),
                      **upload_figures(stats)}
    stream["peak_mb"] = {str(m): p / 1e6 for m, p in peaks.items()}
    out["streaming"] = stream
    med = float(np.median([r["ate_ba_m"] for r in runs]))
    out["median_ate_ba_m"], out["jax_median_ate_ba_m"] = med, float(np.median(JAX_LONG["ate_ba_m"]))
    print(f"long sequence: staged {out['fps']:.2f} frames/s (seed 0, {out['run_s']:.2f} s, "
          f"{out['staged_upload']['mb']:.1f} MB of uint8 frames uploaded in "
          f"{out['staged_upload']['s']:.3f} s), {out['syncs']} stream syncs a run, K1 "
          f"{out['launches']} launches (every call of seed {LONG_SEEDS[2]}'s run equal to "
          f"plain); median ATE after BA {med:.4f} m (JAX {out['jax_median_ate_ba_m']} m, "
          f"long_sequence_r05.json, gate 1.5x); streaming {stream['fps_end_to_end']:.2f} "
          f"frames/s end to end, {stream['uploads']} uploads, {stream['upload_mb']:.1f} MB in "
          f"{stream['upload_s']:.3f} s, ATE {stream['ate_vo_m']:.4f} / {stream['ate_ba_m']:.4f} "
          f"m, {stream['max_diff_vs_staged_m']:.3g} from staged; streaming peak device memory "
          f"{stream['peak_mb']} MB by frames; against JAX's per-window outputs "
          f"{out['vs_jax_dump']}; rendered in {out['render_s']:.1f} s in 7 processes beside the "
          f"stress and witness phases ({out['render_wait_s']:.1f} s waited); card {card}",
          flush=True)
    bad = [r for r in runs if r["converged"] != windows or not r["ate_ba_m"] < r["ate_vo_m"]]
    if bad or stream["converged"] != windows or not stream["ate_ba_m"] < stream["ate_vo_m"]:
        raise AssertionError(f"long sequence: runs {bad}, streaming {stream}")
    if not stream["max_diff_vs_staged_m"] <= LONG_STREAM_TOL:
        raise AssertionError(f"long sequence: streaming differs from staged by "
                             f"{stream['max_diff_vs_staged_m']}")
    if not med <= 1.5 * out["jax_median_ate_ba_m"]:
        raise AssertionError(f"long sequence: median ATE after BA {med} m > 1.5 x JAX's")
    if not peaks[n] <= (1 + LONG_MEMORY_TOL) * peaks[LONG_SHORT_FRAMES]:
        raise AssertionError(f"streaming peak memory grows with length: {stream['peak_mb']}")
    return out


def cross_modal_witness(dev, rig, staged, gt, seeds=CM_SEEDS, check=True) -> list[dict]:
    """The staged cross-modal session on JAX's draws (``DRAWS_DIR``), seed
    by seed, beside JAX's ATE (``JAX_CROSS_MODAL``), with each run's
    per-step records and trajectory; with ``check``, every K2 call is held
    to plain within ``K2_TOL`` and every K1 call exactly."""
    from uasl_motion_estimation_tpu_torch.models.cross_modal import run_cross_modal_staged
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import metrics

    cfg = cross_modal_config(rig)
    gt_speed = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    rows = []
    for seed in seeds:
        sampler = DrawsSampler(load_draws("cross_modal", seed), dev, k=8)
        kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
        with GatherShim(check=check) as shim, (MIShim() if check else nullcontext()) as mi:
            res = run_cross_modal_staged(staged, cfg, seed=seed, chunk=CHUNK, device=dev,
                                         sampler=sampler)
        err = np.abs(res.scales - gt_speed) / gt_speed
        row = {"seed": seed, "ate_m": float(metrics.ate_rmse(res.trajectory[:, :3, 3], gt)),
               "jax_ate_m": JAX_CROSS_MODAL["ate_m"][seed],
               "n_success": sum(bool(r["success"]) for r in res.records),
               "scale_err_median": float(np.median(err)),
               "jax_scale_err_median": JAX_CROSS_MODAL["scale_err_median"][seed],
               "deepest_pick": sampler.deepest,
               "launches": {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches,
                            "mi_strip": kmi.MI.strip_launches},
               "records": res.records, "trajectory": res.trajectory}
        if check:
            check_path_k1(f"cross-modal witness seed {seed}", shim, kg.GATHER.launches)
            if mi.checked != kmi.MI.launches:
                raise AssertionError(f"cross-modal witness: {kmi.MI.launches} K2 launches, "
                                     f"{mi.checked} held to plain")
            row["k2_max_abs_err"] = mi.worst
        row["diff_m"] = row["ate_m"] - row["jax_ate_m"]
        rows.append(row)
    return rows


def unified_witness(dev, seeds=WITNESS_SEEDS, check=True) -> list[dict]:
    """The unified engine on turn_10deg with the stress profile, on JAX's
    draws (``DRAWS_DIR``), seed by seed, beside JAX's ATE
    (``JAX_STRESS``); with ``check``, every K1 call held to plain."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    seq, frames = stress_world("turn_10deg")
    gt = seq.gt_positions()
    stress = stress_configs()[1]
    jax_r = JAX_STRESS["turn_10deg"]
    rows = []
    for seed in seeds:
        sampler = DrawsSampler(load_draws("unified_turn10", seed), dev, k=3)
        kg.GATHER.launches = 0
        with GatherShim(check=check) as shim:
            res = stress_unified(frames, stress, seed, dev, sampler=sampler)
        if check:
            check_path_k1(f"unified witness seed {seed}", shim, kg.GATHER.launches)
        ate_vo, ate_ba = unified_ates(res, gt)
        rows.append({"seed": seed, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                     "jax_ate_vo_m": jax_r["unified_ate_vo_m"][seed],
                     "jax_ate_ba_m": jax_r["unified_ate_ba_m"][seed],
                     "diff_vo_m": ate_vo - jax_r["unified_ate_vo_m"][seed],
                     "diff_ba_m": ate_ba - jax_r["unified_ate_ba_m"][seed],
                     "ba_converged": int(res.ba_converged.sum()),
                     "deepest_pick": sampler.deepest, "launches": kg.GATHER.launches})
    return rows


def witness_phase(dev, rig, staged, gt, own_ates, card) -> dict:
    """The two witnesses on JAX's draws: the cross-modal session on the
    full-size cross-modal world (RANSAC seeds 0-4; every K2 call within
    ``K2_TOL`` of plain, every K1 call equal to it), beside JAX's ATE and
    the port's on its own draws (``own_ates``), and the unified engine on
    turn_10deg with the stress profile (seeds 0-5; every K1 call equal to
    plain). Each cross-modal run succeeds where JAX's does and its ATE lies
    within 1.5x JAX's on the same draws; each unified run's ATE, of the VO
    chain and after BA, within ``WITNESS_TOL`` of JAX's."""
    cm = cross_modal_witness(dev, rig, staged, gt)
    for r, own in zip(cm, own_ates, strict=True):
        del r["records"], r["trajectory"]
        r["own_draws_ate_m"] = own
        print(f"witness, cross-modal seed {r['seed']}: ATE on JAX's draws {r['ate_m']:.5f} m, "
              f"JAX {r['jax_ate_m']:.5f} m ({1e3 * r['diff_m']:+.2f} mm), on the port's own "
              f"draws {own:.5f} m; steps {r['n_success']}/{N_FRAMES - 1}; scale error median "
              f"{r['scale_err_median']:.5f} (JAX {r['jax_scale_err_median']:.5f}); deepest pick "
              f"{r['deepest_pick']}; launches {r['launches']}; K2 within "
              f"{r['k2_max_abs_err']:.3g} of plain; card {card}", flush=True)
    uni = unified_witness(dev)
    for r in uni:
        print(f"witness, unified turn_10deg seed {r['seed']}: ATE VO {r['ate_vo_m']:.5f} m, "
              f"after BA {r['ate_ba_m']:.5f} m on JAX's draws; JAX {r['jax_ate_vo_m']:.5f} / "
              f"{r['jax_ate_ba_m']:.5f} m ({1e3 * r['diff_vo_m']:+.2f} / "
              f"{1e3 * r['diff_ba_m']:+.2f} mm); converged {r['ba_converged']}; deepest pick "
              f"{r['deepest_pick']}; K1 {r['launches']}; card {card}", flush=True)
    out = {"cross_modal": cm, "unified_turn10": uni,
           "max_abs_diff_cross_modal_m": max(abs(r["diff_m"]) for r in cm),
           "max_abs_diff_unified_m": max(max(abs(r["diff_vo_m"]), abs(r["diff_ba_m"]))
                                         for r in uni)}
    print(f"witnesses: largest |port - JAX| on JAX's draws, cross-modal "
          f"{1e3 * out['max_abs_diff_cross_modal_m']:.2f} mm, unified turn_10deg "
          f"{1e3 * out['max_abs_diff_unified_m']:.2f} mm (gate {1e3 * WITNESS_TOL:g} mm)",
          flush=True)
    bad = [r for r in cm if r["n_success"] < JAX_CROSS_MODAL["n_success"]
           or not r["ate_m"] <= 1.5 * r["jax_ate_m"]]
    bad += [r for r in uni if not max(abs(r["diff_vo_m"]), abs(r["diff_ba_m"])) <= WITNESS_TOL]
    if bad:
        raise AssertionError(f"witness runs off JAX's figures on JAX's draws: {bad}")
    return out


def euroc_world():
    """Config 2's world and configuration: (sequence, frames, PipelineConfig)."""
    from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu_torch.models.pipeline import default_config
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(**EUROC_RIG)
    seq = synthetic.SyntheticStereoSequence(n_frames=EUROC_FRAMES, rig=rig, seed=EUROC_WORLD)
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)._replace(
        matcher=MatcherConfig(max_disparity=EUROC_DISP))
    return seq, [seq.frame(i) for i in range(EUROC_FRAMES)], cfg


def euroc_unified(frames, cfg, seed: int, dev, sampler=None):
    """Config 2's integrated engine: ``unified_system_scan(..., wchunk=4)``
    composed, which is ``run_unified_system`` at that group size."""
    from uasl_motion_estimation_tpu_torch.models.smoother import SmootherConfig, run_unified_system

    return run_unified_system(frames, SmootherConfig(pipe=cfg), seed=seed, wchunk=EUROC_WCHUNK,
                              device=dev, sampler=sampler)


def euroc_witness(dev, seeds=EUROC_WITNESS_SEEDS, check=True, world=None) -> list[dict]:
    """Config 2's integrated engine on JAX's draws (``DRAWS_DIR``), seed by
    seed, beside JAX's ATE (``JAX_EUROC``); with ``check``, every K1 call
    held to plain."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    seq, frames, cfg = world or euroc_world()
    gt = seq.gt_positions()
    rows = []
    for seed in seeds:
        sampler = DrawsSampler(load_draws("unified_euroc", seed), dev, k=3)
        kg.GATHER.launches = 0
        with GatherShim(check=check) as shim:
            res = euroc_unified(frames, cfg, seed, dev, sampler=sampler)
        if check:
            check_path_k1(f"config 2 witness seed {seed}", shim, kg.GATHER.launches)
        ate_vo, ate_ba = unified_ates(res, gt)
        jvo, jba = JAX_EUROC["unified_ate_vo_m"][seed], JAX_EUROC["unified_ate_ba_m"][seed]
        rows.append({"seed": seed, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba, "jax_ate_vo_m": jvo,
                     "jax_ate_ba_m": jba, "diff_vo_m": ate_vo - jvo, "diff_ba_m": ate_ba - jba,
                     "ba_converged": int(res.ba_converged.sum()),
                     "deepest_pick": sampler.deepest, "launches": kg.GATHER.launches})
    return rows


def mi_accuracy(feats, v0, fr, v, gt_disp, min_disparity: float, max_disparity: int) -> dict:
    """extra_configs.py:174-192's accuracy figures of one MI match against
    the renderer's disparity, unrounded (numpy inputs)."""
    meas = feats[:, 0] - fr[:, 0]
    ix = np.clip(np.round(feats[:, 0]).astype(int), 0, gt_disp.shape[1] - 1)
    iy = np.clip(np.round(feats[:, 1]).astype(int), 0, gt_disp.shape[0] - 1)
    gt = gt_disp[iy, ix]
    matchable = v0 & (gt > min_disparity) & (gt < max_disparity - 1)
    err = np.abs(meas - gt)
    accepted = v & matchable
    correct = accepted & (err < 1.0)
    return {"valid_matches": int(v.sum()), "n_matchable": int(matchable.sum()),
            "median_abs_px_err": float(np.median(err[accepted])),
            "p90_abs_px_err": float(np.percentile(err[accepted], 90)),
            "precision_at_1px": float(correct.sum() / max(accepted.sum(), 1)),
            "recall_at_1px": float(correct.sum() / max(matchable.sum(), 1))}


def mi_matcher_accuracy(dev) -> dict:
    """Config 3's accuracy block on ``dev``: detect_features and one
    match_stereo(use_mi=True) on the 192x320 world of seed 2 with the right
    image inverted; its figures (``mi_accuracy``)."""
    from uasl_motion_estimation_tpu_torch.models import frontend as fe
    from uasl_motion_estimation_tpu_torch.ops import image as im
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    seq = synthetic.SyntheticStereoSequence(n_frames=1, rig=small_rig(), seed=MI_WORLD)
    left, right = seq.frame(0)
    left = torch.from_numpy(np.asarray(left, np.float32)).to(dev)
    right = torch.from_numpy(np.asarray(255.0 - right, np.float32)).to(dev)
    feats, _, v0 = im.detect_features(left, max_features=MI_FEATURES)
    cfg = fe.MatcherConfig(max_disparity=MI_DISP)
    fr, _, v = fe.match_stereo(left, right, feats, v0, cfg, use_mi=True)
    return mi_accuracy(feats.cpu().numpy(), v0.cpu().numpy(), fr.cpu().numpy(),
                       v.cpu().numpy(), seq.gt_disparity(0), cfg.min_disparity, MI_DISP)


def recovery_points(feats, v0, gt_disp, rig):
    """extra_configs.py:303-318: the detected corners (N, 2) at the
    renderer's exact depths, over the true scale; (points (N, 3) float32,
    valid (N,)), numpy."""
    ix = np.clip(np.round(feats[:, 0]).astype(int), 0, rig.width - 1)
    iy = np.clip(np.round(feats[:, 1]).astype(int), 0, rig.height - 1)
    d_gt = gt_disp[iy, ix]
    z = np.where(d_gt > 1e-3, rig.fu * rig.baseline / np.maximum(d_gt, 1e-3), 0.0)
    ok = v0 & (z > 2) & (z < 40)
    X = np.stack([(feats[:, 0] - rig.cu) * z / rig.fu, (feats[:, 1] - rig.cv) * z / rig.fv, z],
                 -1)
    return (X / RECOVERY_SCALE).astype(np.float32), ok


def bad_init_recovery(dev) -> dict:
    """bench_mi_scale's bad-init recovery on ``dev``: the MI scale LM from
    each ``JAX_RECOVERY`` start on frame 0 of the cross-modal world of seed
    3, the grid-detected corners at the renderer's depths over the true
    scale; {s_init: (recovered scale, LM iterations)}."""
    from uasl_motion_estimation_tpu_torch.models.scale import ScaleConfig, estimate_scale
    from uasl_motion_estimation_tpu_torch.ops import image as im
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = small_rig()
    seq = synthetic.SyntheticStereoSequence(n_frames=RECOVERY_FRAMES, rig=rig,
                                            seed=RECOVERY_WORLD, cross_modal=True)
    left, right = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in seq.frame(0))
    feats, _, v0 = im.detect_features_grid(left, max_features=MI_FEATURES, quality_level=1e-4)
    pts, ok = recovery_points(feats.cpu().numpy(), v0.cpu().numpy(), seq.gt_disparity(0), rig)
    pts = torch.from_numpy(pts).to(dev)
    scfg = ScaleConfig(intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                       baseline=rig.baseline)._replace(coarse_candidates=13)
    out = {}
    for s_init in JAX_RECOVERY:
        s, lm = estimate_scale(left, right, pts, torch.from_numpy(ok).to(dev),
                               torch.tensor(s_init, device=dev), scfg)
        out[s_init] = (float(s), int(lm.n_iter))
    return out


def ba4_problem():
    """Config 4's 16 perturbed windows as one batched problem of numpy arrays
    (cam, pts, obs, mask), built by the port's copy of tests/test_ba.py's
    ``make_window`` and ``perturb`` (``synthetic.ba_window``), and its
    BAConfig."""
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.solvers.ba import BAConfig
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    intr = Intrinsics(*BA4_INTR)
    windows = []
    for s in range(BA4_WINDOWS):
        cams, pts, obs, mask = synthetic.ba_window(intr, BA4_BASELINE, n_frames=BA4_FRAMES,
                                                   n_pts=BA4_POINTS, noise=BA4_NOISE, seed=s)
        windows.append((*synthetic.perturb_ba_window(cams, pts, seed=s + 100), obs, mask))
    return tuple(np.stack(x) for x in zip(*windows)), BAConfig(intr=intr, baseline=BA4_BASELINE)


def covariance_figures(res, poses) -> dict:
    """cov_circuit.py:176-200's figures of one unified result against the
    true poses, unrounded: each motion's translation error against the
    sigma its emitted covariance gives, and the pose covariances' chain."""
    tr_p = np.trace(res.pose_cov, axis1=1, axis2=2)
    err_t = []
    for j in range(len(poses) - 1):
        # m_j maps frame-j points into frame j + 1, as the engine emits it
        m_est = np.linalg.inv(res.traj_ba[j + 1]) @ res.traj_ba[j]
        m_gt = np.linalg.inv(poses[j + 1]) @ poses[j]
        err_t.append(np.linalg.norm(m_est[:3, 3] - m_gt[:3, 3]))
    err_t = np.asarray(err_t)
    sigma_t = np.sqrt(np.trace(res.motion_cov[:, :3, :3], axis1=1, axis2=2))
    return {"motion_cov_trace_median": float(np.median(np.trace(res.motion_cov, axis1=1,
                                                                axis2=2))),
            "pose_cov_trace_first": float(tr_p[1]), "pose_cov_trace_last": float(tr_p[-1]),
            "pose_cov_positive": bool((tr_p[1:] > 0).all()),
            "pose_cov_growth_x": float(tr_p[-1] / max(tr_p[1], 1e-12)),
            "median_motion_t_err_m": float(np.median(err_t)),
            "median_motion_t_sigma_m": float(np.median(sigma_t)),
            "err_within_3sigma_frac": float(np.mean(err_t < 3 * np.maximum(sigma_t, 1e-9)))}


def config2_euroc(dev, card, held) -> dict:
    """Config 2 on the card: staged VO and the integrated engine over RANSAC
    seeds 0-4 (every motion, every window converged, medians within
    ``EUROC_ATE_X`` of JAX's, BA's below VO's), the integrated engine on
    JAX's draws (seeds 0-2, within ``WITNESS_TOL`` of JAX's ATE), frames/s of
    each (median of 3 after the seed runs), their stream syncs and K1 per
    run, and K1 at the 11x74 strip timed as the K1 table's rows."""
    from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, make_sampler
    from uasl_motion_estimation_tpu_torch.models.smoother import (
        SmootherConfig, unified_system_scan)
    from uasl_motion_estimation_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    world = euroc_world()
    seq, frames, cfg = world
    gt = seq.gt_positions()
    out: dict = {"render_s": time.perf_counter() - t0}
    pipe = OdometryPipeline(cfg, seed=0, device=dev)
    ls, rs = pipe.stage_frames(frames)
    staged, unified = [], []
    for seed in EUROC_SEEDS:
        log = metrics.MetricsLogger()
        pipe = OdometryPipeline(cfg, seed=seed, device=dev, logger=log)
        traj, shim = held(f"config 2 staged seed {seed}",
                          lambda: pipe.run_staged(ls, rs, chunk=EUROC_CHUNK),
                          keep=K1_PER_CHUNK if seed == 0 else 0)
        if seed == 0:
            strip_calls = [c for c in shim.calls if (c[2], c[3]) == EUROC_STRIP]
        staged.append({"seed": seed, "ate_m": float(metrics.ate_rmse(traj[:, :3, 3], gt)),
                       "success": sum(bool(r["success"]) for r in log.records)})
        with BAHeld() as k3:
            res, _ = held(f"config 2 integrated seed {seed}",
                          lambda: euroc_unified(frames, cfg, seed, dev))
        if seed == EUROC_SEEDS[0]:  # its first group's BA problem, at its start
            out["k3_gaps"] = hold_ba_schur(*k3.problem, "config 2's first BA group")
        ate_vo, ate_ba = unified_ates(res, gt)
        unified.append({"seed": seed, "ate_vo_m": ate_vo, "ate_ba_m": ate_ba,
                        "vo_success": int((res.per_frame[:, 16] > 0.5).sum()),
                        "ba_converged": int(res.ba_converged.sum()),
                        "windows": len(res.ba_converged), "k3_launches": k3.launches})
    med = {"staged_ate_m": float(np.median([r["ate_m"] for r in staged])),
           "unified_ate_vo_m": float(np.median([r["ate_vo_m"] for r in unified])),
           "unified_ate_ba_m": float(np.median([r["ate_ba_m"] for r in unified]))}
    jax_med = {k: float(np.median(JAX_EUROC[k])) for k in med}
    out.update(staged=staged, unified=unified, median=med, jax_median=jax_med)
    print(f"config 2 (EuRoC-like 480x752 stereo, 17 frames, 64 disparities): staged VO ATE by "
          f"seed {[round(r['ate_m'], 5) for r in staged]} m, motions "
          f"{[r['success'] for r in staged]}/{EUROC_FRAMES - 1}; integrated ATE VO "
          f"{[round(r['ate_vo_m'], 5) for r in unified]} m, after BA "
          f"{[round(r['ate_ba_m'], 5) for r in unified]} m, windows converged "
          f"{[r['ba_converged'] for r in unified]}/{unified[0]['windows']}, K3 launches "
          f"{[r['k3_launches'] for r in unified]} (2 a BA trip, 1 a covariance call); medians "
          f"staged "
          f"{med['staged_ate_m']:.5f} (JAX {jax_med['staged_ate_m']:.5f}), VO "
          f"{med['unified_ate_vo_m']:.5f} (JAX {jax_med['unified_ate_vo_m']:.5f}), BA "
          f"{med['unified_ate_ba_m']:.5f} m (JAX {jax_med['unified_ate_ba_m']:.5f}; JAX r05 at "
          f"seed 0: 0.0344 / 0.0304 / 0.0116 m)", flush=True)
    bad = [r for r in staged if r["success"] < JAX_EUROC["staged_success"]]
    bad += [r for r in unified if r["ba_converged"] < JAX_EUROC["ba_converged"]
            or r["vo_success"] < JAX_EUROC["vo_success"]]
    if bad:
        raise AssertionError(f"config 2: a motion failed or a window did not converge: {bad}")
    if not (all(med[k] <= EUROC_ATE_X * jax_med[k] for k in med)
            and med["unified_ate_ba_m"] < med["unified_ate_vo_m"]):
        raise AssertionError(f"config 2 medians {med} against JAX's {jax_med}: each must be "
                             f"within {EUROC_ATE_X}x JAX's, BA's below VO's")

    wit = []
    for r in euroc_witness(dev, world=world):
        wit.append(r)
        print(f"config 2 witness, JAX's draws, seed {r['seed']}: ATE VO {r['ate_vo_m']:.5f} m, "
              f"after BA {r['ate_ba_m']:.5f} m; JAX {r['jax_ate_vo_m']:.5f} / "
              f"{r['jax_ate_ba_m']:.5f} m ({1e3 * r['diff_vo_m']:+.3f} / "
              f"{1e3 * r['diff_ba_m']:+.3f} mm); converged {r['ba_converged']}; deepest pick "
              f"{r['deepest_pick']}; K1 {r['launches']}", flush=True)
    out["witness"] = wit
    if not all(max(abs(r["diff_vo_m"]), abs(r["diff_ba_m"])) <= WITNESS_TOL for r in wit):
        raise AssertionError(f"config 2 witness off JAX's ATE by more than {WITNESS_TOL} m: "
                             f"{wit}")

    pipe = OdometryPipeline(cfg, seed=0, device=dev)

    def staged_run():
        pipe.reset()
        return pipe.run_staged(ls, rs, chunk=EUROC_CHUNK)

    scfg, sampler = SmootherConfig(pipe=cfg), make_sampler(0, cfg.vo.n_ransac)

    def unified_run():
        return unified_system_scan(ls, rs, sampler, scfg, wchunk=EUROC_WCHUNK)

    out["speed"] = {}
    for name, run in (("staged", staged_run), ("integrated", unified_run)):
        times = timed_runs(run)
        kg_calls = K1_PER_CHUNK * -(-(EUROC_FRAMES - 1) // EUROC_CHUNK) if name == "staged" \
            else K1_PER_GROUP
        k1 = kernel_times_ms(run, K1_KERNEL, kg_calls)
        r = out["speed"][name] = {
            "fps": (EUROC_FRAMES - 1) / float(np.median(times)), "run_s": times,
            "syncs": count_syncs(run), "k1_launches": kg_calls,
            "k1_ms_per_run": None if k1 is None else sum(k1)}
        print(f"config 2 {name} frames/s {r['fps']:.2f} (median of {times}); {r['syncs']} stream "
              f"syncs per run; K1 {kg_calls} launches, {r['k1_ms_per_run']} ms of device time "
              f"per run; card {card}", flush=True)

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    img, anc = strip_calls[0][:2]
    h, w = img.shape[-2:]
    img3 = img.reshape(-1, h, w)
    out["k1_strip"] = time_gather_case({"anchors": "path", "img": img3,
                                        "anc": anc.reshape(img3.shape[0], -1, 2),
                                        "tile": EUROC_STRIP}, flush)
    r = out["k1_strip"]
    print(f"K1 at config 2's ZNCC strip {r['shape']} on {h}x{w} (generic instantiation): cold "
          f"{r['ms']:.4f} ms (runs {r['ms_runs']}; the kernel alone {r['kernel_ms']} ms), warm "
          f"{r['warm_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, grid_sample "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.2f} MB), "
          f"share {100 * r['share']:.1f} %; card {card}", flush=True)
    return out


def config3_mi(dev, card) -> dict:
    """Config 3 on the card: the MI matcher's accuracy (every K2 call within
    ``K2_TOL`` of plain) within ``MI_TOL`` of JAX's, and the bad-init
    recoveries within ``RECOVERY_TOL`` of the true scale and
    ``RECOVERY_JAX_TOL`` of JAX's."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    kmi.MI.launches = kmi.MI.strip_launches = 0
    with MIShim() as mi:
        acc = mi_matcher_accuracy(dev)
    strip, held_strip = kmi.MI.strip_launches, mi.checked
    out = {"accuracy": acc, "jax": JAX_MI, "k2_strip_launches": strip,
           "k2_max_abs_err": mi.worst}
    print(f"config 3 (MI matcher, 192x320, 256 features x 64 disparities, right image "
          f"inverted): " + ", ".join(f"{k} {v:.5g} (JAX {JAX_MI[k]:.5g})" for k, v in acc.items())
          + f"; K2 strip launches {strip}, each within {mi.worst:.3g} of plain (JAX r05: "
          f"precision 0.968, recall 0.956, median 0.123 px)", flush=True)
    kmi.MI.launches = kmi.MI.strip_launches = 0
    with MIShim() as mi:
        rec = bad_init_recovery(dev)
    out["recovery"] = {str(k): {"recovered": s, "n_iter": n, "jax": JAX_RECOVERY[k]}
                       for k, (s, n) in rec.items()}
    out["k2_pair_launches"] = kmi.MI.launches - kmi.MI.strip_launches
    out["k2_max_abs_err"] = max(out["k2_max_abs_err"], mi.worst)
    print(f"config 3 bad-init recovery (true scale {RECOVERY_SCALE}): "
          + "; ".join(f"from {k}: {s:.6f} in {n} iterations (JAX {JAX_RECOVERY[k]:.6f})"
                      for k, (s, n) in rec.items())
          + f"; K2 pair launches {out['k2_pair_launches']}, each within {mi.worst:.3g} of "
          f"plain", flush=True)
    bad = [k for k, tol in MI_TOL.items() if not abs(acc[k] - JAX_MI[k]) <= tol]
    if not abs(acc["valid_matches"] - JAX_MI["valid_matches"]) <= MI_VALID_TOL * JAX_MI[
            "valid_matches"]:
        bad.append("valid_matches")
    bad += [k for k, (s, _) in rec.items()
            if not (abs(s - RECOVERY_SCALE) <= RECOVERY_TOL * RECOVERY_SCALE
                    and abs(s - JAX_RECOVERY[k]) <= RECOVERY_JAX_TOL * JAX_RECOVERY[k])]
    if bad or strip != 1 or held_strip != strip or mi.checked != kmi.MI.launches:
        raise AssertionError(f"config 3 off JAX's figures at {bad}, or K2 unheld: {out}")
    return out


def config4_ba(dev, card) -> dict:
    """Config 4 on the card: the 16 windows in one batched ``ba_solve``, each
    held to JAX's ``jax.vmap(ba_solve)`` (cost, cameras, convergence, and
    iterations within ``BA4_ITER_GAP``), its stream syncs (one host read per
    LM iteration for the whole batch), and windows/s (median of 3 after it)."""
    from uasl_motion_estimation_tpu_torch.solvers.ba import BAProblem, ba_solve

    from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba

    arrays, bcfg = ba4_problem()
    prob = BAProblem(*(torch.from_numpy(a).to(dev) for a in arrays))
    before = kba.BA_SCHUR.launches
    res = ba_solve(prob, bcfg)
    k3_launches = kba.BA_SCHUR.launches - before
    cost = res.cost.cpu().numpy()
    cam = res.cam.cpu().numpy()
    n_iter = res.n_iter.cpu().numpy()
    conv = res.converged.cpu().numpy()
    jcam = np.load(Path(__file__).resolve().parent / DRAWS_DIR / JAX_BA4_FILE)["cam"]
    jcost, jiter = np.asarray(JAX_BA4["cost"]), np.asarray(JAX_BA4["n_iter"])
    times = timed_runs(lambda: ba_solve(prob, bcfg).cost.cpu())
    out = {"cost": cost.tolist(), "mean_cost": float(cost.mean()),
           "jax_mean_cost": JAX_BA4["mean_cost"],
           "cost_rel_err": float(np.max(np.abs(cost - jcost) / jcost)),
           "cam_err": float(np.abs(cam - jcam).max()), "n_iter": n_iter.tolist(),
           "n_iter_gap": int(np.abs(n_iter - jiter).max()),
           "n_iter_differ": np.nonzero(n_iter != jiter)[0].tolist(), "converged": conv.tolist(),
           "syncs": count_syncs(lambda: ba_solve(prob, bcfg)),
           "windows_s": BA4_WINDOWS / float(np.median(times)), "run_s": times,
           "k3_launches": k3_launches}
    print(f"config 4 (16 windows x 10 frames x 256 points, one batch): mean cost "
          f"{out['mean_cost']:.6f} (JAX {JAX_BA4['mean_cost']:.6f}, r05 0.3819), per window "
          f"cost within {out['cost_rel_err']:.3g} relative and cameras within "
          f"{out['cam_err']:.3g} of JAX's, iterations {out['n_iter']} (JAX "
          f"{JAX_BA4['n_iter']}; differ at windows {out['n_iter_differ']}), converged "
          f"{int(conv.sum())}/{BA4_WINDOWS}; {out['syncs']} "
          f"stream syncs per solve; {out['windows_s']:.2f} windows/s (median of {times}); K3 "
          f"{k3_launches} launches (2 a trip); card {card}", flush=True)
    if not (out["cost_rel_err"] <= BA4_COST_RTOL and out["cam_err"] <= BA4_CAM_TOL
            and k3_launches == 2 * int(n_iter.max())
            and out["converged"] == JAX_BA4["converged"] and out["n_iter_gap"] <= BA4_ITER_GAP
            and out["syncs"] <= int(n_iter.max()) + 1):
        raise AssertionError(f"config 4 off JAX's per-window solve: {out}")
    return out


def covariance_calibration(dev, card, world, held) -> dict:
    """cov_circuit.py's engine-covariance block on the card: the corrupted
    40-frame world through ``run_unified_system`` at RANSAC seed 1 (4 windows
    a group, its default): pose covariances positive and growing, the share
    of motions within 3 sigma no more than ``COV_FRAC_SLACK`` below JAX's,
    the median translation sigma within ``COV_SIGMA_X`` of JAX's."""
    from uasl_motion_estimation_tpu_torch.models.smoother import run_unified_system

    seq, frames, cfg = world
    with BAHeld() as k3:
        res, _ = held("covariance run", lambda: run_unified_system(
            frames, cfg, seed=COV_SEED, wchunk=COV_WCHUNK, device=dev))
    fig = covariance_figures(res, seq.poses)
    print(f"covariances (cov_circuit.py, corrupted 40-frame world, seed {COV_SEED}): "
          + ", ".join(f"{k} {v:.6g} (JAX {JAX_COV[k]:.6g})" for k, v in fig.items()
                      if k in JAX_COV)
          + f"; every pose covariance after the first positive: {fig['pose_cov_positive']}; "
          f"K3 {k3.launches} launches "
          f"(JAX r05: 89.7 % within 3 sigma, growth 2145x); card {card}", flush=True)
    if not (fig["pose_cov_positive"] and fig["pose_cov_growth_x"] > 1.0
            and fig["err_within_3sigma_frac"] >= JAX_COV["err_within_3sigma_frac"]
            - COV_FRAC_SLACK
            and fig["median_motion_t_sigma_m"] <= COV_SIGMA_X * JAX_COV["median_motion_t_sigma_m"]
            and fig["median_motion_t_sigma_m"] >= JAX_COV["median_motion_t_sigma_m"]
            / COV_SIGMA_X):
        raise AssertionError(f"covariances off JAX's calibration: {fig}")
    return {**fig, "k3_launches": k3.launches}


def north_star_configs(dev, card, cov_world) -> dict:
    """The JAX package's remaining published configurations on the card:
    config 2 (``config2_euroc``), config 3 (``config3_mi``), config 4
    (``config4_ba``) and cov_circuit.py's covariance check
    (``covariance_calibration``, on ``cov_world``: (sequence, frames,
    SmootherConfig) of the corrupted world). Every K1 call of every run is
    held to the plain version exactly, at a case ``check_gather`` holds."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    out: dict = {"launches": 0, "k1_held": 0}

    def held(name, fn, keep=0):
        kg.GATHER.launches = 0
        with GatherShim(keep=keep, check=True) as shim:
            result = fn()
        check_path_k1(name, shim, kg.GATHER.launches)
        out["launches"] += kg.GATHER.launches
        out["k1_held"] += shim.checked
        return result, shim

    out["config2"] = config2_euroc(dev, card, held)
    out["launches"] += sum(r["launches"] for r in out["config2"]["witness"])
    out["k1_held"] += sum(r["launches"] for r in out["config2"]["witness"])
    kg.GATHER.launches = 0
    with GatherShim(check=True) as shim:
        out["config3"] = config3_mi(dev, card)
    check_path_k1("config 3", shim, kg.GATHER.launches)
    out["launches"] += kg.GATHER.launches
    out["k1_held"] += shim.checked
    out["config4"] = config4_ba(dev, card)
    out["covariances"] = covariance_calibration(dev, card, cov_world, held)
    print(f"north-star configurations: K1 {out['launches']} launches, every one held to plain "
          f"exactly ({out['k1_held']})", flush=True)
    return out


def timed_runs(run, n=3) -> list[float]:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()  # ends in a device->host copy
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from uasl_motion_estimation_tpu_torch.models.cross_modal import run_cross_modal_staged
    from uasl_motion_estimation_tpu_torch.models.pipeline import (
        OdometryPipeline, default_config)
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

    t_start = time.perf_counter()
    phase_s: dict = {}
    card = card_line()
    print(card, flush=True)
    print(f"toolchain: {toolchain()}; python {sys.version.split()[0]}")
    dev = torch.device("cuda:0")
    build_kernels()

    k1_err = check_gather(dev)
    print(f"K1 == plain at {len(SHAPES)} tile shapes x {len(LEVELS)} levels (batches {CHUNK} "
          f"and {UNIFIED_WCHUNK}), at the edge cases, at the mono engine's {len(KLT_SHAPES)} KLT "
          f"tiles x {len(MONO_LEVELS)} levels (batches {MONO_BATCHES}), the per-frame loops' "
          f"batch 1 and every other case of K1_HELD ({len(held_cases())} cases in all), max abs "
          f"err {k1_err}")
    k2_err, ent_err = check_mi(dev)
    print(f"K2 vs plain at the matcher and scale shapes, sentinels 20/25/31/400, P 81/121, "
          f"bins 20/32: max abs err {k2_err:.3g} (tolerance {K2_TOL}); identical patches "
          f"vs their entropy: {ent_err:.3g} (tolerance {ENTROPY_TOL})")
    ba4_arrays, ba4_cfg = ba4_problem()
    ba4 = tuple(torch.from_numpy(a).to(dev) for a in ba4_arrays)
    hold_ba_schur(ba4, ba4_cfg, "config 4's start (LM damping)")
    hold_ba_schur(ba4, ba4_cfg, "config 4's start (the covariances' regularisation)", v_eps=1e-9)
    k3_times = time_ba_schur(dev, card)

    small_err = small_world_agrees(dev)
    print(f"small stereo world: card vs CPU max motion difference {small_err:.3g}")
    cm_scale_err, cm_rot_err = small_cross_modal_agrees(dev)
    print(f"small cross-modal world: card vs CPU max relative scale difference "
          f"{cm_scale_err:.3g}, max rotation difference {cm_rot_err:.3g}", flush=True)
    uni_err = small_unified_agrees(dev)
    print(f"small integrated world: card vs CPU max motion difference {uni_err:.3g}", flush=True)

    t0 = time.perf_counter()
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    print(f"rendered {N_FRAMES} frames {rig.height}x{rig.width} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gt = seq.gt_positions()

    # --- stereo VO path ---
    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    log = metrics.MetricsLogger()
    pipe = OdometryPipeline(cfg, seed=0, device=dev, logger=log)
    ls, rs = pipe.stage_frames(frames)

    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    t0 = time.perf_counter()
    traj = pipe.run_staged(ls, rs, chunk=CHUNK)
    first_s = time.perf_counter() - t0
    stereo_launches = {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches}
    if stereo_launches["gather_tiles"] <= 0:
        raise AssertionError("the stereo path never launched K1")
    if traj.shape != (N_FRAMES, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectory: shape {traj.shape}")
    ate = metrics.ate_rmse(traj[:, :3, 3], gt)
    n_ok = sum(bool(r["success"]) for r in log.records)
    inliers = [r["n_inliers"] for r in log.records]
    print(f"stereo path: launches {stereo_launches}, first run {first_s:.3f} s, "
          f"ATE {ate:.5f} m (JAX reference 0.0379 m), successful steps {n_ok}/{N_FRAMES - 1}, "
          f"inliers min {min(inliers)} median {int(np.median(inliers))}")
    if not ate < 0.1:
        raise AssertionError(f"ATE {ate} m >= 0.1 m")

    pipe.logger = None

    def stereo_run():
        pipe.reset()
        return pipe.run_staged(ls, rs, chunk=CHUNK)

    times = timed_runs(stereo_run)
    stereo_syncs = count_syncs(stereo_run)
    print(f"stereo staged frames/s {(N_FRAMES - 1) / float(np.median(times)):.2f} "
          f"(median of {times}, chunk {CHUNK}); {stereo_syncs} stream syncs per run "
          f"({SYNCS_BEFORE['stereo']} before the constants were cached); card {card}",
          flush=True)
    # K1's calls in one run (the first chunk's kept for its timings), and its
    # device time over another
    n_chunks = -(-(N_FRAMES - 1) // CHUNK)
    with GatherShim(keep=K1_PER_CHUNK) as shim:
        stereo_run()
    n_calls = sum(shim.counts.values())
    if not n_calls == stereo_launches["gather_tiles"] == K1_PER_CHUNK * n_chunks:
        raise AssertionError(f"the shim saw {n_calls} K1 calls in a stereo run, the launch "
                             f"count says {stereo_launches['gather_tiles']}, expected "
                             f"{K1_PER_CHUNK} per chunk")
    k1_run_ms = kernel_times_ms(stereo_run, K1_KERNEL, n_calls)
    per_run = None if k1_run_ms is None else sum(k1_run_ms)
    print(f"K1 over one staged stereo run: {n_calls} launches, {per_run} ms of device time "
          f"(torch.profiler); card {card}", flush=True)

    # --- cross-modal metric-scale path: the same world, its right images in
    # the second modality (the remap SyntheticStereoSequence applies with
    # cross_modal=True) ---
    cm_cfg = cross_modal_config(rig)
    rs_cm = np.stack([255.0 * (1.0 - (f[1] / 255.0) ** 0.7) for f in frames])
    staged = (ls, torch.from_numpy(np.clip(rs_cm, 0, 255).astype(np.uint8)).to(dev))
    torch.cuda.synchronize()

    compared, session_ids = matcher_strip_ids(dev, *staged)
    print(f"MI matcher, first chunk of the full-size cross-modal world: strip ids == "
          f"per-candidate ids at all {compared} in-image candidates; match_stereo(use_mi=True) "
          f"launched K2 once, in strip mode", flush=True)

    kg.GATHER.launches = kmi.MI.launches = kmi.MI.strip_launches = 0
    t0 = time.perf_counter()
    res = run_cross_modal_staged(staged, cm_cfg, seed=0, chunk=CHUNK, device=dev)
    first_s = time.perf_counter() - t0
    cm_launches = {"gather_tiles": kg.GATHER.launches, "mi_hist": kmi.MI.launches}
    cm_modes = {"strip": kmi.MI.strip_launches, "pairs": kmi.MI.launches - kmi.MI.strip_launches}
    if min(cm_launches.values()) <= 0 or cm_modes["pairs"] <= 0:
        raise AssertionError(f"the cross-modal path skipped a kernel: {cm_launches} {cm_modes}")
    if cm_modes["strip"] != n_chunks:
        raise AssertionError(f"the MI matcher ran {n_chunks} times but K2's strip mode "
                             f"launched {cm_modes['strip']} times")
    print(f"cross-modal path: launches {cm_launches}, K2 by mode {cm_modes} (strip: the "
          f"matcher, once per chunk; pairs: the scale LM), first run {first_s:.3f} s")
    gt_speed = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    jax_ref = JAX_CROSS_MODAL
    figures = []
    for seed in CM_SEEDS:
        if seed != CM_SEEDS[0]:
            res = run_cross_modal_staged(staged, cm_cfg, seed=seed, chunk=CHUNK, device=dev)
        if res.trajectory.shape != (N_FRAMES, 4, 4) or not np.isfinite(res.trajectory).all():
            raise AssertionError(f"bad cross-modal trajectory: shape {res.trajectory.shape}")
        scale_err = np.abs(res.scales - gt_speed) / gt_speed
        figures.append((sum(r["success"] for r in res.records), float(np.median(scale_err)),
                        float(scale_err.max()), metrics.ate_rmse(res.trajectory[:, :3, 3], gt)))
        print(f"cross-modal seed {seed}: successful steps {figures[-1][0]}/{N_FRAMES - 1}, "
              f"scale error median {figures[-1][1]:.5f} max {figures[-1][2]:.5f}, "
              f"ATE {figures[-1][3]:.5f} m; per-step scale errors "
              f"{np.round(scale_err, 4).tolist()}")
    cm_ok = min(f[0] for f in figures)
    med_err = float(np.median([f[1] for f in figures]))
    cm_ate = float(np.median([f[3] for f in figures]))
    jax_med, jax_ate = (float(np.median(jax_ref[k])) for k in ("scale_err_median", "ate_m"))
    print(f"cross-modal over seeds {list(CM_SEEDS)}: fewest successful steps {cm_ok} "
          f"(JAX {jax_ref['n_success']}), median scale error {med_err:.5f} (JAX {jax_med:.5f}), "
          f"median ATE {cm_ate:.5f} m (JAX {jax_ate:.5f} m)")
    if cm_ok < jax_ref["n_success"]:
        raise AssertionError(f"{cm_ok} steps succeeded, JAX {jax_ref['n_success']}")
    if not med_err < max(0.02, 1.5 * jax_med):
        raise AssertionError(f"median scale error {med_err}")
    if not cm_ate <= 1.5 * jax_ate:
        raise AssertionError(f"cross-modal median ATE {cm_ate} m > 1.5 x JAX's {jax_ate} m")

    def cm_run():
        return run_cross_modal_staged(staged, cm_cfg, seed=0, chunk=CHUNK, device=dev)

    times = timed_runs(cm_run)
    cm_syncs = count_syncs(cm_run)
    with GatherShim() as cm_shim:
        cm_run()
    print(f"cross-modal staged frames/s {(N_FRAMES - 1) / float(np.median(times)):.2f} "
          f"(median of {times}, chunk {CHUNK}); {cm_syncs} stream syncs per run "
          f"({SYNCS_BEFORE['cross_modal']} before the constants were cached); card {card}",
          flush=True)

    phase_s["kernel checks, small worlds, stereo and cross-modal"] = time.perf_counter() - t_start

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return result

    # --- integrated VO+BA engine, then the streaming engines ---
    integ = phase("integrated", integrated_path, dev, rig, frames, gt, ls, rs, card)
    streams = phase("streaming", streaming_paths, dev, rig, frames, pipe, traj,
                    integ.pop("result"), card)
    cov_world = integ.pop("corrupted_world")

    # --- stereo with the top-k detector, the per-frame cross-modal loop, and
    # the monocular engine ---
    topk = phase("stereo_topk", topk_stereo, dev, rig, ls, rs, gt, card)
    rights_u8 = list(np.clip(rs_cm, 0, 255).astype(np.uint8))
    cm_frame = phase("cross_modal_per_frame", cross_modal_per_frame, dev, rig, frames, rights_u8,
                     gt, card)
    mono = phase("mono", mono_path, dev, card)

    # --- the latency mode, its parallax gate and checkpoint, P3P, and the
    # cross-modal session with the 5-point solver ---
    latency = phase("latency", latency_mode, dev, rig, frames, gt, card)
    parallax = phase("parallax_gate", parallax_gate, dev, card)
    ckpt = phase("checkpoint", checkpoint_resume, dev, rig, frames, card)
    p3p = phase("p3p", p3p_phase, dev, rig, ls, rs, gt, card)
    cm5 = phase("cross_modal_5point", cross_modal_fivepoint, dev, rig, staged, gt, card)

    # --- the JAX package's stress worlds, its 501-frame sequence, and the
    # witnesses on JAX's draws ---
    render = LongRender(LONG_FRAMES)
    try:
        stress = phase("stress_worlds", stress_worlds_phase, dev, card)
        witness = phase("witness", witness_phase, dev, rig, staged, gt, [f[3] for f in figures],
                        card)
        long_seq = phase("long_sequence", long_sequence_phase, dev, card, render)
    finally:
        render.close()

    # --- the JAX package's remaining published configurations: EuRoC-like
    # stereo VO and VO+BA, the MI matcher's accuracy, 16 batched 10-frame BA
    # windows, and the engine's covariance calibration ---
    north = phase("north_star_configs", north_star_configs, dev, card, cov_world)

    # --- the parallel layer: 4 gloo ranks sharing the card, one NCCL rank,
    # and the synthetic example ---
    par = phase("parallel", parallel_phase, dev, rig, frames, card)
    print(json.dumps({"paths": {
        "stereo": {"syncs": stereo_syncs, "syncs_before": SYNCS_BEFORE["stereo"]},
        "cross_modal": {"syncs": cm_syncs, "syncs_before": SYNCS_BEFORE["cross_modal"]},
        "integrated": integ, **streams, "stereo_topk": topk, "cross_modal_per_frame": cm_frame,
        "mono": mono, "latency": latency, "parallax_gate": parallax, "checkpoint": ckpt,
        "p3p": p3p, "cross_modal_5point": cm5, "stress_worlds": stress,
        "long_sequence": long_seq, "witness": witness, "north_star_configs": north,
        "parallel": par}, "card": card}))

    # --- kernel timings ---
    tg, event_floor = time_gather(dev, shim.calls)
    print(f"K1 cold timings: two CUDA events with no launch between them read "
          f"{event_floor:.4f} ms after the same flush")
    for name, r in tg.items():
        key = (*r["shape"][2:], *r["image"])
        r["launches"] = {"stereo": shim.counts.get(key, 0),
                         "cross_modal": cm_shim.counts.get(key, 0)}
        print(f"K1 {name} {r['shape']}: cold {r['ms']:.4f} ms (runs {r['ms_runs']}; the kernel "
              f"alone {r['kernel_ms']} ms), warm {r['warm_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, grid_sample {r['library_ms']:.4f} ms (runs "
              f"{r['library_ms_runs']}), bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.2f} MB), "
              f"share {100 * r['share']:.1f} % ({r['kernel_share']} of the kernel alone); "
              f"launches per run {r['launches']}; card {card}")
    tm = time_mi(dev, session_ids)
    for name, r in tm.items():
        err = f", max abs err vs plain {r['max_abs_err']:.3g}" if "max_abs_err" in r else ""
        print(f"K2 {name} {r['shape']}{err}: kernel {r['ms']:.4f} ms (runs {r['ms_runs']}), "
              f"plain {r['plain_ms']:.4f} ms (runs {r['plain_ms_runs']}), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes'] / 1e6:.2f} MB, "
              f"{r['ops']:.3g} ops); card {card}")
    strip_t, pairs_t = tm["strip_session"], tm["pairs_scale_lm"]

    phase_s["kernel timings"] = time.perf_counter() - t_start - sum(phase_s.values())
    print(f"phase seconds {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    headline = f"path 11x138 on {rig.height}x{rig.width}"  # the ZNCC strip, level 0
    strip = tg[headline]
    print(json.dumps({"kernels": [{
        "name": "gather_tiles",
        "route": "cuda",
        "source": "uasl_motion_estimation_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "uasl_motion_estimation_tpu/ops/pallas/gather.py:37",
        "launches": stereo_launches["gather_tiles"],
        "launches_by_path": {"stereo": stereo_launches["gather_tiles"],
                             "cross_modal": cm_launches["gather_tiles"],
                             "integrated": integ["launches"]["gather_tiles"],
                             "integrated_corrupted": integ["launches_corrupted"],
                             "streaming": streams["streaming"]["launches"],
                             "unified_streaming": streams["unified_streaming"]["launches"],
                             "stereo_topk": topk["launches"],
                             "cross_modal_per_frame": cm_frame["launches"]["gather_tiles"],
                             **{f"mono_{name}": mono[name]["launches"] for name in mono
                                if name != "fivepoint"},
                             "latency_vo": latency["vo"]["launches"]["gather_tiles"],
                             "latency_ba": latency["ba"]["launches"]["gather_tiles"],
                             "parallax_gate": parallax["parallax_2"]["launches"],
                             "stereo_p3p": p3p["launches"],
                             "cross_modal_5point": cm5["launches"]["gather_tiles"],
                             "stress_worlds": stress["launches"],
                             "long_sequence_staged": long_seq["launches"],
                             "long_sequence_streaming": long_seq["streaming"]["launches"],
                             "witness_cross_modal": witness["cross_modal"][0]["launches"][
                                 "gather_tiles"],
                             "witness_unified_turn10": witness["unified_turn10"][0]["launches"],
                             "north_star_configs": north["launches"],
                             "parallel_gloo_ranks": par["launches"]["gloo_ranks"],
                             "parallel_nccl_rank": par["launches"]["nccl_rank"]},
        "max_abs_err": k1_err,
        "ms": strip["ms"],
        "warm_ms": strip["warm_ms"],
        "plain_ms": strip["plain_ms"],
        "bound_ms": strip["bound_ms"],
        "bound_by": "bytes",
        "share": strip["share"],
        "library_ms": strip["library_ms"],
        "headline": headline,
        "per_run_ms": per_run,
        "per_run_launches": n_calls,
        "per_run_ms_integrated": integ["k1_ms_per_run"],
        "per_run_launches_integrated": integ["k1_calls"],
        "per_run_ms_mono": {name: mono[name]["k1_ms_per_run"] for name in mono
                            if name != "fivepoint"},
        "per_run_ms_latency": {mode: latency[mode]["k1_ms_per_run"] for mode in latency},
        "per_run_launches_latency": {mode: latency[mode]["k1_calls"] for mode in latency},
        "kernel_ms": strip["kernel_ms"],
        "event_floor_ms": event_floor,
        "stress_tile_cold_ms": stress["k1_cold"],
        "euroc_strip": {key: north["config2"]["k1_strip"][key] for key in (
            "shape", "image", "ms", "kernel_ms", "warm_ms", "plain_ms", "library_ms", "bound_ms",
            "share")},
        "timings": {name: {key: r[key] for key in (
            "anchors", "shape", "image", "ms", "kernel_ms", "warm_ms", "plain_ms", "library_ms",
            "bound_ms", "share", "kernel_share", "launches")} for name, r in tg.items()},
    }, {
        "name": "mi_hist",
        "route": "cuda",
        "source": "uasl_motion_estimation_tpu_torch/csrc/mi_hist.cu",
        "replaces": "uasl_motion_estimation_tpu/ops/pallas/mi.py:34",
        "launches": cm_launches["mi_hist"],
        "launches_by_path": {"stereo": stereo_launches["mi_hist"],
                             "cross_modal": cm_launches["mi_hist"],
                             "integrated": integ["launches"]["mi_hist"],
                             "latency_vo": latency["vo"]["launches"]["mi_hist"],
                             "cross_modal_5point": cm5["launches"]["mi_hist"],
                             "witness_cross_modal": witness["cross_modal"][0]["launches"][
                                 "mi_hist"],
                             "config3_mi": north["config3"]["k2_strip_launches"]
                             + north["config3"]["k2_pair_launches"]},
        "max_abs_err": max(k2_err, strip_t["max_abs_err"], north["config3"]["k2_max_abs_err"],
                           *(r["k2_max_abs_err"] for r in witness["cross_modal"])),
        "ms": strip_t["ms"],
        "plain_ms": strip_t["plain_ms"],
        "bound_ms": strip_t["bound_ms"],
        "bound_by": strip_t["bound_by"],
        "library_ms": None,
        "modes": {
            "strip": {"launches": cm_modes["strip"], "shape": strip_t["shape"],
                      "ms": strip_t["ms"], "plain_ms": strip_t["plain_ms"],
                      "bound_ms": strip_t["bound_ms"], "bound_by": strip_t["bound_by"]},
            "pairs": {"launches": cm_modes["pairs"], "shape": pairs_t["shape"],
                      "ms": pairs_t["ms"], "plain_ms": pairs_t["plain_ms"],
                      "bound_ms": pairs_t["bound_ms"], "bound_by": pairs_t["bound_by"]},
        },
        "timings": {name: {key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                                   "bound_by")} for name, r in tm.items()},
    }, {
        "name": "ba_schur",
        "route": "cuda",
        "source": "uasl_motion_estimation_tpu_torch/csrc/ba_schur.cu",
        "replaces": None,
        "launches_by_path": {
            "config4_ba": north["config4"]["k3_launches"],
            "config2_integrated": [r["k3_launches"] for r in north["config2"]["unified"]],
            "covariance_run": north["covariances"]["k3_launches"]},
        "shape": list(BA_CELL),
        "ms": k3_times["A"] + k3_times["B"],
        "ms_by_kernel": {"A": k3_times["A"], "B": k3_times["B"]},
        "solve_ms": k3_times["solve"],
        "plain_ms": k3_times["plain_reduce"] + k3_times["plain_step"],
        "bound_ms": k3_times["bound_ms"],
        "bound_by": k3_times["bound_by"],
        "share": k3_times["share"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
