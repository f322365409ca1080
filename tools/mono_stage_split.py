"""Where the monocular engine's time goes on a CUDA card.

    python3 tools/mono_stage_split.py

On ``chip_smoke.py``'s mono world (``benchmarks/extra_configs.py``'s
bench_mono: 480x752, 13 frames, seed 3, left camera, 256 top-k features, 2
px threshold) it times the first 8-step chunk stage by stage, through the functions
``mono_pipeline._step`` is built from and in its order, each stage fenced with
``torch.cuda.synchronize`` (median of 5), and counts each stage's host
reads (torch's sync debug mode), kernel launches and device time
(``torch.profiler``). The mono solve is timed with each solver's samples:
the pencil (``pencil8``, also the hybrid's first pass) and the exact
5-point, whose two parts are also timed alone: the nullspace SVD of the
(8, 200, 5, 9) systems and the candidates from the basis. Then it profiles
one whole ``run_mono_staged`` per solver (chunk 8) and prints the device's
busy time, the kernel launches and the top device kernels. Needs a card;
prints one JSON object.
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
from uasl_motion_estimation_tpu_torch.models import mono_pipeline as mp  # noqa: E402
from uasl_motion_estimation_tpu_torch.models import mono_vo as mv  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops import fivepoint as fp  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops import geometry as geo  # noqa: E402
from uasl_motion_estimation_tpu_torch.ops import image as im  # noqa: E402
from uasl_motion_estimation_tpu_torch.utils import synthetic  # noqa: E402

N_FRAMES, CHUNK = 13, 8


def world():
    """bench_mono's frames and the config of each solver."""
    rig = synthetic.CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                              height=480, width=752)
    seq = synthetic.SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=3)
    frames = [seq.frame(i)[0] for i in range(N_FRAMES)]
    intr = geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfgs = {s: mp.MonoPipelineConfig(vo=mv.MonoVOParams(intr=intr, inlier_threshold=2.0,
                                                         solver=s), max_features=256)
            for s in ("pencil8", "5point", "hybrid")}
    return frames, cfgs


def host_reads(fn) -> int:
    """Stream syncs fn makes, from torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_kernels(fn) -> tuple[int, float]:
    """(kernel launches, device ms) of fn, by torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3


def stage_split(ls, cfgs, reps=5) -> dict:
    """ms, host reads, launches and device ms per stage of the first chunk,
    each stage one of the functions ``mono_pipeline._step`` is built from."""
    lf = ls[:CHUNK + 1].float()
    prev, cur = lf[:-1], lf[1:]
    steps = list(range(CHUNK))
    c8, c5 = cfgs["pencil8"], cfgs["5point"]
    state = {}

    def pyramids():
        state["pyr"] = im.build_pyramid(lf, c8.klt.n_levels)

    def detect_topk():
        state["det"] = mp._detect(prev, c8)

    def klt():
        feats, _, v0 = state["det"]
        pyr = state["pyr"]
        state["m"], state["valid"] = mp._track(prev, cur, feats, v0, c8, [x[:-1] for x in pyr],
                                               [x[1:] for x in pyr])

    def sample(solver, cfg):
        samplers = mp.make_mono_samplers(0, cfg.vo)

        def run():
            state["smp_" + solver] = mp.draw_samples(steps, state["valid"], samplers, cfg)[0]
        run.__name__ = f"sample_{solver}"
        return run

    def solve(solver, cfg):
        def run():
            mv.mono_vo_solve(state["m"], state["valid"], state["smp_" + solver], cfg.vo)
        run.__name__ = f"mono_vo_solve_{solver}"
        return run

    def fivepoint_svd():
        rows = torch.arange(CHUNK, device=ls.device)[:, None, None]
        smp = state["smp_5point"]
        s1 = mv._normalize(state["m"][..., 0, :], c5.vo.intr)[rows, smp]
        s2 = mv._normalize(state["m"][..., 1, :], c5.vo.intr)[rows, smp]
        state["basis"] = fp.nullspace_basis(s1, s2)

    def fivepoint_candidates():
        fp.candidates_from_basis(state["basis"])

    stages = [pyramids, detect_topk, klt, sample("pencil8", c8), solve("pencil8", c8),
              sample("5point", c5), solve("5point", c5), fivepoint_svd, fivepoint_candidates]
    out = {}
    for s in stages:  # warm up, count host reads and kernels
        reads = host_reads(s)
        launches, dev_ms = device_kernels(s)
        out[s.__name__] = {"host_reads": reads, "launches": launches, "device_ms": dev_ms}
    for s in stages:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[s.__name__]["ms"] = float(np.median(times))
    return out


def profile_run(frames, cfg, dev) -> dict:
    def run():
        return mp.run_mono_staged(frames, cfg, seed=0, initial_speed=0.8, chunk=CHUNK, device=dev)

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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_wall_s": wall, "device_busy_ms": busy_us / 1e3, "kernel_launches": launches,
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = setup_device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    frames, cfgs = world()
    ls = torch.from_numpy(np.clip(np.stack(frames), 0, 255).astype(np.uint8)).to(dev)
    out = {"card": card, "chunk_steps": CHUNK, "stages": stage_split(ls, cfgs),
           "runs": {s: profile_run(frames, c, dev) for s, c in cfgs.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
