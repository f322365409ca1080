"""Where the integrated VO+BA engine's time goes on a CUDA card.

    python3 tools/unified_stage_split.py

On ``chip_smoke.py``'s stereo world (``CameraRig()`` 376x1241, 40 frames,
seed 0, ``SmootherConfig`` at its defaults, 5 windows per group) it runs the
stages of the first group of windows one by one, each fenced with
``torch.cuda.synchronize`` (median of 5 after a warm-up pass): the track
tables, the RANSAC samples, the per-motion VO, BA (problem set-up and the
LM loop), the covariances and refined motions, and the host side of a
whole run (the packed outputs' transfer and the float64 composition). For
each stage it counts the host reads (torch's sync debug mode) and, under
``torch.profiler``, the kernel launches and the device's busy time. Then it
profiles one whole ``unified_system_scan``: wall time, device busy time,
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

from uasl_motion_estimation_tpu_torch.device import setup_device  # noqa: E402
from uasl_motion_estimation_tpu_torch.models import smoother as sm  # noqa: E402
from uasl_motion_estimation_tpu_torch.models.pipeline import (  # noqa: E402
    default_config, make_sampler)
from uasl_motion_estimation_tpu_torch.ops import geometry as geo  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import synthetic  # noqa: E402

N_FRAMES, WCHUNK = 40, 5


def staged_world(dev):
    rig = synthetic.CameraRig()
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    ls, rs = (torch.from_numpy(np.clip(np.stack([f[k] for f in frames]), 0, 255)
                               .astype(np.uint8)).to(dev) for k in (0, 1))
    pipe = default_config(geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline)
    return ls, rs, sm.SmootherConfig(pipe=pipe)


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


def device_events(fn):
    """(kernel launches, device busy ms) of fn, by torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in evs if "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower())
    return launches, sum(e.time_range.elapsed_us() for e in evs) / 1e3


def stage_split(ls, rs, cfg, reps=5):
    """ms, host reads, launches and device ms per stage of the first group,
    each stage one of the functions ``smoother.unified_solve_group`` runs,
    called in its order on its outputs."""
    sampler = make_sampler(0, cfg.pipe.vo.n_ransac)
    group = sm.unified_window_starts(N_FRAMES, cfg.window, cfg.ba_rate)[:WCHUNK]
    lf, rf = ls.float(), rs.float()
    state = {}

    def tracks():
        state["obs"], state["mask"] = sm._build_window_tracks(lf, rf, group, cfg)
        state["quv"], state["qvalid"] = sm._quad_matches(state["obs"], state["mask"])

    def samples():
        state["samples"] = sm._group_samples(state["qvalid"], group, sampler, 0, cfg)

    def vo():
        state["vo"], state["motions"] = sm._group_vo(state["quv"], state["qvalid"],
                                                     state["samples"], cfg)

    def ba():
        state["problems"], state["res"] = sm._group_ba(state["motions"], state["obs"],
                                                       state["mask"], cfg)

    def covariances():
        sm._group_covariances(state["problems"], state["res"], cfg)

    packed = sm._scan_packed(ls, rs, sampler, cfg, WCHUNK, 0)

    def compose():
        sm.compose_unified(sm._unpack(packed.cpu().numpy(), cfg.window), N_FRAMES, cfg)

    stages = [tracks, samples, vo, ba, covariances, compose]
    times = {s.__name__: [] for s in stages}
    reads, device = {}, {}
    for rep in range(reps + 2):
        for s in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:  # warms up and counts host reads
                reads[s.__name__] = host_reads(s)[1]
            elif rep == 1:
                device[s.__name__] = device_events(s)
            else:
                s()
            torch.cuda.synchronize()
            if rep > 1:
                times[s.__name__].append(1e3 * (time.perf_counter() - t0))
    return {k: {"ms": float(np.median(v)), "host_reads": reads[k], "launches": device[k][0],
                "device_ms": device[k][1]} for k, v in times.items()}


def profile_run(ls, rs, cfg):
    sampler = make_sampler(0, cfg.pipe.vo.n_ransac)

    def run():
        return sm.unified_system_scan(ls, rs, sampler, cfg, wchunk=WCHUNK)

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
    _, syncs = host_reads(run)
    return {"profiled_wall_s": wall, "device_busy_ms": busy_us / 1e3, "kernel_launches": launches,
            "syncs_per_run": syncs, "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = setup_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    ls, rs, cfg = staged_world(dev)
    out = {"card": card, "group_windows": WCHUNK, "stages": stage_split(ls, rs, cfg)}
    out.update(profile_run(ls, rs, cfg))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
