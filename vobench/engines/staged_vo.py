"""Offline staged stereo VO: a recorded drive on the device, one
``OdometryPipeline.run_staged(ls, rs, chunk)`` from ``reset()`` a pass.

Traffic parameters: ``frames`` (the segment), ``chunk`` (steps a batch),
``trace_passes``. The comparison judges one pass:

- ``frontend_px``: the front end's quad matches, by the photometric steps
  the reference would still take from them (the median over valid matches
  of the largest of a match's KLT and two stereo steps,
  ``common.frontend_steps``);
- ``vo_solve_px``: each step's motion and success flag against the
  reference's float64 solve on the step's own matches and inliers
  (``common.judge_steps``);
- ``chain_m``: the host chain against the reference's float64 chain of the
  same motions.

On earlier lines a run prints sanity figures against the renderer's truth:
the quad matches' median distance from where the true point appears, the
motions' median gap from the true motions, and the ATE.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import vo as rvo
from ..reference.prec import F64
from ..spans import Capture, patch
from . import common


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device, small: dict):
        from uasl_motion_estimation_tpu_torch.models import frontend as fe
        from uasl_motion_estimation_tpu_torch.models import pipeline as pl
        from uasl_motion_estimation_tpu_torch.ops import image as im

        traffic = {**traffic, **small.get("traffic", {})}
        s_world, s_ransac = common.seeds(seed, 2)
        self.rig = common.rig_of(config, small)
        self.world = common.World(s_world, self.rig, traffic["frames"], device,
                                  common.scene_of(config, small)["hall_half_width"])
        self.truth = rvo.truth_motions(self.world.poses)
        self.pipe = pl.OdometryPipeline(common.pipeline_config(config, self.rig, small),
                                        seed=s_ransac, device=device)
        self.chunk = traffic["chunk"]
        self.work_per_pass = traffic["frames"] - 1
        self.capture = Capture(seed)
        self._undo = [
            patch(fe, "quad_match_frames", self.capture.wrap("qm", lambda q: (q.uv, q.valid))),
            patch(pl, "stereo_vo_solve", self.capture.wrap(
                "vo", lambda r: (r.motion, r.success, r.inlier_mask), lambda r: (r.success,))),
        ]
        self.SPANS = [(fe, "quad_match_frames", "frontend"), (pl, "stereo_vo_solve", "solve")]
        self.K1 = (im, "gather_tiles")

    def run_pass(self) -> None:
        self.pipe.reset()
        traj = self.pipe.run_staged(self.world.ls, self.world.rs, chunk=self.chunk)
        if self.capture.on and self.capture.full is not None:
            self.capture.full["traj"] = traj

    def failed(self) -> int:
        """Steps the program failed over the window's passes."""
        return sum(int((~s).sum()) for s in self.capture.tallied("vo"))

    def lm_iters(self) -> list:
        return []

    def release(self) -> None:
        for u in self._undo:
            u()
        del self.pipe

    @staticmethod
    def _outputs(cap: dict):
        quads = torch.cat([q[0] for q in cap["qm"]])
        valid = torch.cat([q[1] for q in cap["qm"]])
        motion, success, inliers = (torch.cat([v[k] for v in cap["vo"]]) for k in range(3))
        return quads, valid, inliers, motion, success, cap["traj"]

    def _numbers(self, quads, valid, inliers, motion, success, traj) -> tuple[dict, dict]:
        """(the compared numbers, the sanity figures) of a subject's pass."""
        b = quads.shape[0]
        i0 = torch.arange(b, device=quads.device)
        steps = common.frontend_steps(self.world.ls, self.world.rs, quads, i0, i0 + 1)
        out = {"frontend_px": common.median_of(steps[valid])}
        out.update(common.judge_steps(quads, valid, inliers, motion, success, self.truth, self.rig))
        out["chain_m"] = common.chain_gap_m(traj, motion, success)
        truth_q = self.world.truth_quads(quads[:, :, 0], i0, i0 + 1, F64)
        extras = {"quads_truth_px": common.median_of(common.quad_error_px(quads, truth_q, valid)),
                  "vo_truth_px": out.pop("vo_truth_px")}
        return out, extras

    def judge(self, cap: dict) -> dict:
        out, self._extras = self._numbers(*self._outputs(cap))
        return out

    def control(self, cap: dict) -> dict:
        """The numbers of the reference put in the program's place in TF32."""
        quads, _, inliers, _, _, _ = self._outputs(cap)
        b = quads.shape[0]
        i0 = torch.arange(b, device=quads.device)
        q, valid, use, motion, success, traj = common.control_steps(
            self.world, quads[:, :, 0], i0, i0 + 1, inliers, self.truth, self.rig)
        return self._numbers(q, valid, use, motion, success, traj)[0]

    def sanity(self, cap: dict) -> list[str]:
        """Figures against the renderer's truth, after ``judge``."""
        _, valid, _, _, success, traj = self._outputs(cap)
        ate = rvo.ate_rmse(np.asarray(traj)[:, :3, 3], self.world.poses[:, :3, 3])
        return [f"sanity: ATE {ate:.5f} m against the renderer's poses over "
                f"{len(traj)} frames; {int(success.sum())}/{success.numel()} steps solved; "
                f"median valid matches {float(valid.sum(-1).float().median()):.0f}; "
                f"quad matches {self._extras['quads_truth_px']:.4f} px and motions "
                f"{self._extras['vo_truth_px']:.4f} px (medians) from the truth"]
