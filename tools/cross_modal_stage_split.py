"""Where the cross-modal session's time goes on a CUDA card.

    python3 tools/cross_modal_stage_split.py

On ``chip_smoke.py``'s cross-modal world (``CameraRig()`` 376x1241, seed 0,
the right images in the second modality, ``CrossModalConfig`` at its
defaults) it times one 13-step chunk stage by stage, each stage fenced with
``torch.cuda.synchronize`` (median of 5), and counts the host reads each
stage makes. Then it profiles one whole staged run (40 frames, chunk 13)
with ``torch.profiler`` and prints the device's busy time, the kernel
launches and the top device kernels. Needs a card; prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from uasl_motion_estimation_tpu_torch.models import frontend as fe  # noqa: E402
from uasl_motion_estimation_tpu_torch.models.cross_modal import (  # noqa: E402
    CrossModalConfig, run_cross_modal_staged)
from uasl_motion_estimation_tpu_torch.models.mono_pipeline import make_mono_samplers  # noqa: E402
from uasl_motion_estimation_tpu_torch.models.mono_vo import (  # noqa: E402
    MonoVOParams, mono_vo_solve)
from uasl_motion_estimation_tpu_torch.models.scale import (  # noqa: E402
    ScaleConfig, estimate_scale)
from uasl_motion_estimation_tpu_torch.ops import geometry as geo  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops import image as im  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import synthetic  # noqa: E402

N_FRAMES, CHUNK = 40, 13


def staged_world(dev):
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0,
                                            cross_modal=True)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    ls = np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8)
    rs = np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8)
    intr = geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = CrossModalConfig(vo=MonoVOParams(intr=intr),
                           scale=ScaleConfig(intr=intr, baseline=rig.baseline))
    return torch.from_numpy(ls).to(dev), torch.from_numpy(rs).to(dev), cfg


def host_reads(fn):
    """(fn's result, the stream syncs fn made), from torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def stage_split(ls, rs, cfg, reps=5):
    """ms and host reads per stage of the first chunk's 13 steps, in the
    order ``cross_modal._session_step`` runs them."""
    sampler = make_mono_samplers(0, cfg.vo)[0]
    lf = ls[:CHUNK + 1].float()
    rf = rs[1:CHUNK + 1].float()
    prev, cur = lf[:-1], lf[1:]
    state = {}

    def pyramids():
        state["pyr"] = im.build_pyramid(lf, cfg.klt.n_levels)

    def detect():
        state["det"] = im.detect_features_grid(prev, max_features=cfg.max_features,
                                               quality_level=cfg.detect_quality)

    def klt():
        feats, _, v0 = state["det"]
        pyr = state["pyr"]
        state["trk"] = fe.klt_track(prev, cur, feats, v0, cfg.klt,
                                    pyr_prev=[x[:-1] for x in pyr],
                                    pyr_next=[x[1:] for x in pyr])

    def sample():
        state["smp"] = torch.stack([sampler(s, v) for s, v in enumerate(state["trk"].valid)])

    def mono_vo():
        feats = state["det"][0]
        trk = state["trk"]
        res = mono_vo_solve(torch.stack([feats, trk.pts], dim=-2), trk.valid, state["smp"],
                            cfg.vo)
        X = torch.matmul(res.pts3d, res.R.transpose(-1, -2)) + res.t[..., None, :]
        z = X[..., 2]
        state["X"] = X
        state["ok"] = (res.inlier_mask & (z > cfg.min_depth) & (z < cfg.max_depth)
                       & torch.isfinite(X).all(dim=-1))

    def mi_matcher():
        uv = geo.project(state["X"], cfg.vo.intr)
        fr, _, mv = fe.match_stereo(cur, rf, uv, state["ok"], cfg.matcher, use_mi=True)
        disp = uv[..., 0] - fr[..., 0]
        ratio = cfg.vo.intr.fu * cfg.scale.baseline / torch.clamp(disp, min=1e-6) / torch.clamp(
            state["X"][..., 2], min=1e-6)
        ok = mv & (disp > cfg.matcher.min_disparity) & torch.isfinite(ratio)
        state["s0"] = torch.nanquantile(torch.where(ok, ratio, torch.nan), 0.5, dim=-1)

    def scale_lm():
        s0 = torch.where(torch.isfinite(state["s0"]), state["s0"], torch.ones_like(state["s0"]))
        estimate_scale(cur, rf, state["X"], state["ok"], s0, cfg.scale)

    stages = [pyramids, detect, klt, sample, mono_vo, mi_matcher, scale_lm]
    times = {s.__name__: [] for s in stages}
    reads = {}
    for rep in range(reps + 1):
        for s in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:  # the first pass warms up and counts host reads
                reads[s.__name__] = host_reads(s)[1]
            else:
                s()
            torch.cuda.synchronize()
            if rep:
                times[s.__name__].append(1e3 * (time.perf_counter() - t0))
    return {k: {"ms": float(np.median(v)), "host_reads": reads[k]} for k, v in times.items()}


def profile_run(ls, rs, cfg):
    def run():
        return run_cross_modal_staged((ls, rs), cfg, seed=0, chunk=CHUNK, device=ls.device)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    launches = sum(1 for e in evs if "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower())
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_s": wall, "device_busy_ms": busy_us / 1e3, "kernel_launches": launches,
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    ls, rs, cfg = staged_world(torch.device("cuda:0"))
    out = {"card": card, "chunk_steps": CHUNK, "stages": stage_split(ls, rs, cfg)}
    out.update(profile_run(ls, rs, cfg))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
