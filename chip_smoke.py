"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. Fails at once without a CUDA card; prints the card's name and power limit.
2. Builds every CUDA kernel of the staged stereo-VO path from ``csrc/``.
3. Holds each kernel against its plain PyTorch version on the card at every
   shape the main path gives it (tile gather K1: exact, it is a copy).
4. Drives the main path at full size: ``bench.py``'s world (376x1241,
   40 frames, seed 0, 500 features, 4 KLT levels, 128 disparities, 200
   RANSAC hypotheses) through ``OdometryPipeline.stage_frames`` and
   ``run_staged(chunk=13)``, with every kernel's launch count set to 0
   just before and read just after; each must have launched.
5. Checks the output: ATE against ground truth < 0.1 m, and on a small
   world the card agrees with the port's CPU run (plain kernel versions)
   given the same RANSAC samples.
6. Times the staged frames/s (median of 3 after the measured run) and each
   kernel against its plain version.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": {...}}``.
Any failed phase ends the run with a non-zero exit code.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 40
CHUNK = 13
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


def random_anchors(gen, batch, n, h, w, dev):
    """Anchors over and beyond the image, plus the int32 extremes."""
    ax = torch.randint(-300, w + 300, (batch, n), generator=gen)
    ay = torch.randint(-60, h + 60, (batch, n), generator=gen)
    ax[:, 0], ay[:, 0] = -2**31, 2**31 - 1
    ax[:, 1], ay[:, 1] = 2**31 - 1, -2**31
    return torch.stack([ax, ay], -1).to(torch.int32).to(dev)


def check_gather(dev) -> float:
    """K1 vs its plain version at every main-path tile shape and level."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for h, w in LEVELS:
        img = (torch.rand(CHUNK, h, w, generator=gen) * 255).to(dev)
        for th, tw in SHAPES:
            anc = random_anchors(gen, CHUNK, 500, h, w, dev)
            got = kg.gather_tiles(img, anc, th, tw)
            want = kg.gather_tiles_plain(img, anc, th, tw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or got.shape != (CHUNK, 500, th, tw):
                raise AssertionError(f"K1 differs from plain at {h}x{w} tile {th}x{tw}: {err}")
            worst = max(worst, err)
    return worst


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


def time_gather(dev) -> dict:
    """K1 and plain times at the ZNCC-strip and level-0 KLT-tile shapes,
    (13, 500) anchors on a (13, 376, 1241) image, kernel and plain in turns."""
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    gen = torch.Generator().manual_seed(1)
    img = (torch.rand(CHUNK, 376, 1241, generator=gen) * 255).to(dev)
    xs = torch.randint(0, 1241, (CHUNK, 500), generator=gen)
    ys = torch.randint(0, 376, (CHUNK, 500), generator=gen)
    anc = torch.stack([xs, ys], -1).to(torch.int32).to(dev)
    out = {}
    for name, (th, tw) in (("zncc_strip", (11, 138)), ("klt_tile", (22, 22))):
        k1 = time_ms(lambda: kg.gather_tiles(img, anc, th, tw))
        plain = time_ms(lambda: kg.gather_tiles_plain(img, anc, th, tw))
        k2 = time_ms(lambda: kg.gather_tiles(img, anc, th, tw))
        plain2 = time_ms(lambda: kg.gather_tiles_plain(img, anc, th, tw))
        out[name] = {"shape": [CHUNK, 500, th, tw], "ms": min(k1, k2),
                     "plain_ms": min(plain, plain2), "ms_runs": [k1, k2],
                     "plain_ms_runs": [plain, plain2]}
    return out


def small_world_agrees(dev):
    """192x320, 8 frames, 256 features: the card against the port's CPU run
    (plain kernel versions), both given the same CPU-drawn RANSAC samples.
    Success flags equal, motions within 1e-3."""
    from uasl_motion_estimation_tpu_torch._shared import synthetic
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from uasl_motion_estimation_tpu_torch._shared import metrics, synthetic
    from uasl_motion_estimation_tpu_torch.models.pipeline import (
        OdometryPipeline, default_config)
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import _build
    from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

    card = card_line()
    print(card, flush=True)
    print(f"toolchain: {toolchain()}; python {sys.version.split()[0]}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    lib = _build.build_library(kg.SOURCE)
    kg.GATHER.load()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    print(open(f"{lib}.log").read().strip())

    max_err = check_gather(dev)
    print(f"K1 == plain at {len(SHAPES)} tile shapes x {len(LEVELS)} levels, max abs err {max_err}")

    small_err = small_world_agrees(dev)
    print(f"small world: card vs CPU max motion difference {small_err:.3g}")

    t0 = time.perf_counter()
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    print(f"rendered {N_FRAMES} frames {rig.height}x{rig.width} in {time.perf_counter() - t0:.1f} s")

    cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    log = metrics.MetricsLogger()
    pipe = OdometryPipeline(cfg, seed=0, device=dev, logger=log)
    ls, rs = pipe.stage_frames(frames)

    kg.GATHER.launches = 0
    t0 = time.perf_counter()
    traj = pipe.run_staged(ls, rs, chunk=CHUNK)
    first_s = time.perf_counter() - t0
    launches = kg.GATHER.launches
    if launches <= 0:
        raise AssertionError("the main path never launched K1")
    if traj.shape != (N_FRAMES, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectory: shape {traj.shape}")
    ate = metrics.ate_rmse(traj[:, :3, 3], seq.gt_positions())
    n_ok = sum(bool(r["success"]) for r in log.records)
    inliers = [r["n_inliers"] for r in log.records]
    print(f"main path: K1 launches {launches}, first run {first_s:.3f} s, "
          f"ATE {ate:.5f} m (JAX reference 0.0379 m), successful steps {n_ok}/{N_FRAMES - 1}, "
          f"inliers min {min(inliers)} median {int(np.median(inliers))}")
    if not ate < 0.1:
        raise AssertionError(f"ATE {ate} m >= 0.1 m")

    pipe.logger = None
    times = []
    for _ in range(3):
        pipe.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj_rep = pipe.run_staged(ls, rs, chunk=CHUNK)  # ends in a device->host copy
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fps = (N_FRAMES - 1) / float(np.median(times))
    rep_ate = metrics.ate_rmse(traj_rep[:, :3, 3], seq.gt_positions())
    print(f"staged frames/s {fps:.2f} (median of {times}, chunk {CHUNK}); "
          f"repeat ATE {rep_ate:.5f} m; card {card}")

    tg = time_gather(dev)
    for name, r in tg.items():
        print(f"K1 {name} {r['shape']}: kernel {r['ms']:.4f} ms (runs {r['ms_runs']}), "
              f"plain {r['plain_ms']:.4f} ms (runs {r['plain_ms_runs']}); card {card}")

    print(json.dumps({"kernels": [{
        "name": "gather_tiles",
        "route": "cuda",
        "source": "uasl_motion_estimation_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "uasl_motion_estimation_tpu/ops/pallas/gather.py:37",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": tg["zncc_strip"]["ms"],
        "plain_ms": tg["zncc_strip"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
