"""What the engines share: seeds, the rig, the port's configuration from a
configuration file, the world, and the judging of stereo-VO steps."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import geometry as g
from ..reference import photometric as ph
from ..reference import vo as rvo
from ..reference.prec import F64, TF32, Prec
from ..world.render_torch import Hall, Rig, kitti_like_trajectory


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds drawn from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def rig_of(config: dict, small: dict) -> Rig:
    return Rig(**{**config["rig"], **small.get("rig", {})})


def scene_of(config: dict, small: dict) -> dict:
    return {**config["scene"], **small.get("scene", {})}


def pipeline_config(config: dict, rig: Rig, small: dict):
    """The port's ``PipelineConfig``: ``default_config`` at the rig, with
    the configuration file's ``pipeline`` settings."""
    from uasl_motion_estimation_tpu_torch.models import frontend as fe
    from uasl_motion_estimation_tpu_torch.models import pipeline as pl
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    p = {**config["pipeline"], **small.get("pipeline", {})}
    cfg = pl.default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
                            n_ransac=p["n_ransac"], min_spread_area=p["min_spread_area"])
    return cfg._replace(max_features=p["max_features"], detector=p["detector"],
                        matcher=fe.MatcherConfig(max_disparity=p["max_disparity"]))


class World:
    """The hall rendered along the drive, on the device: (lefts, rights)
    uint8 frames and the true cam-to-world poses."""

    def __init__(self, seed: int, rig: Rig, n_frames: int, device, hall_half_width: float):
        self.rig = rig
        self.poses = kitti_like_trajectory(n_frames)
        self.hall = Hall(seed, device, hall_half_width=hall_half_width)
        self.ls, self.rs = self.hall.stereo(self.poses, rig)
        self.planes = (self.hall.point, self.hall.normal)

    def truth_quads(self, first: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                    p: Prec) -> torch.Tensor:
        """Where the points seen at left pixels ``first`` (B, N, 2) in frames
        ``i0`` (B,) appear: (B, N, 4, 2) [left i0, right i0, left i1,
        right i1] (NaN where the ray meets no plane)."""
        T = torch.as_tensor(self.poses, dtype=torch.float64, device=first.device)
        T0, T1 = T[i0], T[i1]
        X = g.cast(self.planes, T0, first, self.rig, p)
        return torch.stack([p.t(first), g.project(T0, X, self.rig, p, right=True),
                            g.project(T1, X, self.rig, p),
                            g.project(T1, X, self.rig, p, right=True)], -2)


def quad_error_px(quads: torch.Tensor, truth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per valid match, the largest distance of its other three points from
    the truth (inf where the truth is undefined); (n_valid,)."""
    err = torch.linalg.norm(quads[..., 1:, :].double() - truth[..., 1:, :].double(), dim=-1)
    err = torch.amax(torch.nan_to_num(err, nan=torch.inf), -1)
    return err[valid]


def frontend_steps(ls, rs, quads, i0, i1, block: int = 32) -> torch.Tensor:
    """Per quad match (B, N), the largest of the three photometric steps the
    reference would still take from it (``reference/photometric.py``): the
    KLT step at the tracked point (prev left -> cur left) and the stereo
    steps of both right matches. ``ls``, ``rs`` (n, H, W) frames, ``i0``,
    ``i1`` (B,) the frames of each step."""
    out = []
    for a in range(0, quads.shape[0], block):
        q, j0, j1 = quads[a:a + block].double(), i0[a:a + block], i1[a:a + block]
        L0, L1, R0, R1 = ls[j0], ls[j1], rs[j0], rs[j1]
        out.append(torch.maximum(
            ph.klt_step(L0, L1, q[..., 0, :], q[..., 2, :]),
            torch.maximum(ph.stereo_step(L0, R0, q[..., 0, :], q[..., 1, :]),
                          ph.stereo_step(L1, R1, q[..., 2, :], q[..., 3, :]))))
    return torch.cat(out)


def median_of(x: torch.Tensor) -> float:
    x = torch.nan_to_num(x, nan=torch.inf)
    return float(x.median()) if x.numel() else float("inf")


def judge_steps(quads, valid, inliers, motion, success, truth, rig) -> dict:
    """Stereo-VO steps against the plain reference (float64): the least-
    squares motion on the subject's own matches and inliers, started from
    the true motion, and the true motion itself.

    ``vo_solve_px``: the largest gap between a subject's motion and the
    reference's, where both solve the step (where one of them solves it
    and the other does not, inf). ``vo_truth_px`` (a sanity figure, not
    compared): the median gap between the subject's motion (the identity
    where it failed) and the true one, over the steps the reference solves.
    Gaps in pixels at 15 m (``geometry.pose_gap_px``)."""
    n_valid, n_inl = valid.sum(-1), inliers.sum(-1)
    ref, cost = rvo.solve_motion(quads, inliers, rig, F64, init=truth.to(quads.device))
    ref_ok = (n_valid >= 6) & (n_inl >= 6) & torch.isfinite(cost)
    success = success.to(ref_ok.device)
    gap = g.pose_gap_px(motion, ref, rig.fu)
    gap = torch.where(success & ref_ok, gap, torch.zeros_like(gap))
    gap = torch.where(success != ref_ok, torch.full_like(gap, torch.inf), gap)
    eye = torch.eye(4, dtype=torch.float64, device=motion.device)
    used = torch.where(success[:, None, None], motion.double(), eye)
    tgap = g.pose_gap_px(used, truth.to(motion.device), rig.fu)
    tgap = tgap[ref_ok]
    return {"vo_solve_px": float(gap.max()),
            "vo_truth_px": float(tgap.median()) if tgap.numel() else float("inf")}


def chain_gap_m(traj: np.ndarray, motions: torch.Tensor, success: torch.Tensor) -> float:
    """Largest distance between the subject's trajectory positions and the
    reference's float64 chain of the subject's own motions and flags."""
    ref = rvo.chain(motions.cpu(), success.cpu(), F64).numpy()
    return float(np.max(np.linalg.norm(np.asarray(traj)[:, :3, 3] - ref[:, :3, 3], axis=-1)))


def control_steps(world: World, first, i0, i1, inliers, truth, rig):
    """The reference in the program's place, in TF32: its quad matches of
    the program's detections, its motions on them over the program's
    inliers, their flags by the count rule, and its chain."""
    quads = world.truth_quads(first, i0, i1, TF32)
    valid = torch.isfinite(quads).all(-1).all(-1)
    use = inliers & valid
    quads = torch.nan_to_num(quads)
    motion, cost = rvo.solve_motion(quads, use, rig, TF32, init=truth.to(quads.device))
    success = (use.sum(-1) >= 6) & torch.isfinite(cost)
    traj = rvo.chain(motion.cpu(), success.cpu(), TF32).double().numpy()
    return quads, valid, use, motion, success, traj
