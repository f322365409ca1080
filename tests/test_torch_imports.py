"""The port never imports jax and never loads a file of the JAX package,
under any module name. Checked in a fresh interpreter that imports the port
and runs ``OdometryPipeline.run_staged`` and ``run_streaming``,
``run_cross_modal_staged`` (with the 5-point solver too), the unified VO+BA
engine (``run_unified_system``), the mono engines (``run_mono_staged`` with
the hybrid escalating every step, so the exact 5-point runs, and
``MonoOdometryPipeline``), the latency mode (``OdometrySystem`` with BA
and the parallax gate, checkpointed and resumed, and staged stereo VO with
``hyp_solver="p3p"``), and the parallel layer in one gloo rank (sharded VO,
the sharded unified engine, window-parallel BA, stitching) on the CPU,
after importing the host modules (io, sensors, viz, profiling, native), both
examples, ``chip_smoke.py`` (building config 4's BA windows) and the witness
tools the card runs, then looks at every loaded module's name and
``__file__``."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
import uasl_motion_estimation_tpu_torch
from uasl_motion_estimation_tpu_torch.utils import synthetic
from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, default_config
from uasl_motion_estimation_tpu_torch.models.cross_modal import (
    CrossModalConfig, run_cross_modal_staged)
from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
from uasl_motion_estimation_tpu_torch.models.mono_pipeline import (
    MonoOdometryPipeline, MonoPipelineConfig, run_mono_staged)
from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
from uasl_motion_estimation_tpu_torch.ops import fivepoint
from uasl_motion_estimation_tpu_torch.models.scale import ScaleConfig
from uasl_motion_estimation_tpu_torch.models.smoother import SmootherConfig, run_unified_system
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=96, width=160)
seq = synthetic.SyntheticStereoSequence(n_frames=3, rig=rig, seed=0, tex_size=256)
cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
                     image_shape=(96, 160))._replace(max_features=64)
pipe = OdometryPipeline(cfg, seed=0, device="cpu")
ls, rs = pipe.stage_frames([seq.frame(i) for i in range(3)])
traj = pipe.run_staged(ls, rs, chunk=2)
assert traj.shape == (3, 4, 4) and np.isfinite(traj).all()
useq = synthetic.SyntheticStereoSequence(n_frames=5, rig=rig, seed=0, tex_size=256)
uframes = [useq.frame(i) for i in range(5)]
ures = run_unified_system(uframes, SmootherConfig(pipe=cfg, ba_max_iter=3), device="cpu")
assert ures.traj_ba.shape == (5, 4, 4) and np.isfinite(ures.pose_cov).all()
pipe.reset()
straj = pipe.run_streaming(iter(uframes), chunk=2)
assert straj.shape == (5, 4, 4) and np.isfinite(straj).all()
cross = synthetic.SyntheticStereoSequence(n_frames=3, rig=rig, seed=3, tex_size=256,
                                          cross_modal=True)
intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
ccfg = CrossModalConfig(vo=MonoVOParams(intr=intr, n_ransac=32),
                        scale=ScaleConfig(intr=intr, baseline=rig.baseline, max_iter=3),
                        matcher=MatcherConfig(max_disparity=32), max_features=64)
res = run_cross_modal_staged([cross.frame(i) for i in range(3)], ccfg, chunk=2, device="cpu")
assert res.trajectory.shape == (3, 4, 4) and np.isfinite(res.scales).all()
mcfg = MonoPipelineConfig(vo=MonoVOParams(intr=intr, n_ransac=16, solver="hybrid",
                                          hybrid_ratio=2.0), max_features=64)
mframes = [f[0] for f in uframes]
stats = {}
mtraj = run_mono_staged(mframes, mcfg, chunk=2, device="cpu", stats=stats)
assert mtraj.shape == (5, 4, 4) and np.isfinite(mtraj).all() and stats["escalated"] == [0, 1, 2, 3]
ptraj = MonoOdometryPipeline(mcfg._replace(vo=mcfg.vo._replace(solver="pencil8")),
                             device="cpu").run(mframes)
assert ptraj.shape == (5, 4, 4) and np.isfinite(ptraj).all()
assert fivepoint.fivepoint_candidates(torch.rand(5, 2), torch.rand(5, 2))[0].shape == (10, 3, 3)
res5 = run_cross_modal_staged([cross.frame(i) for i in range(3)],
                              ccfg._replace(vo=ccfg.vo._replace(solver="5point")), chunk=2,
                              device="cpu")
assert np.isfinite(res5.scales).all()
from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig, OdometrySystem
from uasl_motion_estimation_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
import tempfile
ocfg = OdometryConfig(vo=cfg.vo, max_tracks=64, window=3, ba_rate=2, parallax=0.5,
                      matcher=MatcherConfig(max_disparity=32))
osys = OdometrySystem(ocfg, device="cpu")
otraj = osys.run(uframes[:3])
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d + "/c.npz", osys)
    resumed = OdometrySystem(ocfg, device="cpu")
    load_checkpoint(d + "/c.npz", resumed)
otraj = resumed.run(uframes[3:])
assert otraj.shape == (5, 4, 4) and np.isfinite(otraj).all()
ppipe = OdometryPipeline(cfg._replace(vo=cfg.vo._replace(hyp_solver="p3p")), device="cpu")
assert np.isfinite(ppipe.run_staged(ls, rs, chunk=2)).all()
import importlib.util
from uasl_motion_estimation_tpu_torch import native, parallel
from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
from uasl_motion_estimation_tpu_torch.parallel import launch, stitching
from uasl_motion_estimation_tpu_torch.parallel.ba_windows import window_parallel_ba
from uasl_motion_estimation_tpu_torch.solvers.ba import BAConfig, BAProblem
from uasl_motion_estimation_tpu_torch.utils import io, profiling, sensors, viz
for name in ("run_synthetic_torch", "run_dataset_torch"):
    spec = importlib.util.spec_from_file_location(name, Path("examples") / f"{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
sys.path.insert(0, ".")
import chip_smoke
for name in ("north_star_witness", "unified_witness"):
    spec = importlib.util.spec_from_file_location(name, Path("tools") / f"{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
(cam4, _, _, mask4), _ = chip_smoke.ba4_problem()
assert cam4.shape == (16, 10, 6) and mask4.any()
timer = profiling.StageTimer()
with tempfile.TemporaryDirectory() as d, launch.process_group("gloo", 1, 0, d + "/store"):
    mesh = launch.make_mesh(1, device="cpu")
    with timer("vo"):
        poses, ok, _, _ = parallel.sharded_sequence_vo(
            ls[:-1], rs[:-1], ls[1:], rs[1:], make_sampler(0, cfg.vo.n_ransac), cfg, mesh)
    scfg = SmootherConfig(pipe=cfg, ba_max_iter=3)
    uls, urs = (np.clip(np.stack([f[k] for f in uframes]), 0, 255).astype(np.uint8)
                for k in (0, 1))
    uout = parallel.sharded_unified_scan(uls, urs, make_sampler(0, cfg.vo.n_ransac), scfg, mesh)
    cams = torch.zeros(2, 3, 6)
    cams[..., 5] = -torch.arange(3.0)
    prob = BAProblem(cams, torch.rand(2, 8, 3) + torch.tensor([0.0, 0.0, 5.0]),
                     torch.rand(2, 3, 8, 4) * 50, torch.ones(2, 3, 8, dtype=torch.bool))
    bres = window_parallel_ba(prob, BAConfig(intr=intr, baseline=rig.baseline, n_fixed=1,
                                             max_iter=2), mesh, n_sweeps=1)
assert poses.shape == (2, 4, 4) and uout.vo_motions.shape == (1, 4, 4, 4)
assert torch.isfinite(bres.cam).all() and timer.counts["vo"] == 1
segs = torch.from_numpy(np.stack([traj[:2], traj[1:]]).astype(np.float32))
assert stitching.stitch_segments(segs, 1).shape == (3, 4, 4)
jax_pkg = (Path(uasl_motion_estimation_tpu_torch.__file__).resolve().parent.parent
           / "uasl_motion_estimation_tpu")
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
loaded += sorted(m for m in sys.modules if m.startswith("uasl_motion_estimation_tpu.")
                 or m == "uasl_motion_estimation_tpu")
loaded += sorted(f"{m} from {f}" for m, mod in list(sys.modules.items())
                 for f in [getattr(mod, "__file__", None)]
                 if f and Path(f).resolve().is_relative_to(jax_pkg))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
