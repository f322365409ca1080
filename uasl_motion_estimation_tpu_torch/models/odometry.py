"""Latency-mode stereo odometry: persistent tracks, per-frame VO, windowed BA.

Port of ``uasl_motion_estimation_tpu/models/odometry.py``, the consumer loop
the reference implies (SURVEY.md section 3.5): WBA-style tracks kept across
frames in a fixed-capacity table (models/tracks.py), per-frame egomotion from
the tracks' quad matches, and every ``ba_rate`` keyframes a bundle adjustment
of the sliding window (the reference consumer's ``BundleAdjuster`` cadence,
file_IO.h:69-73).

On the device: one ``track_and_solve`` per frame (KLT of the table's newest
observations, two ZNCC ``match_stereo`` calls, grid detection, the table
update and ``stereo_vo_solve``, all on the K1 tile gather) and one
``ba_refine_window`` per BA. On the host: the float64 pose chain, the
parallax keyframe gate and the BA schedule. Each frame's figures come back
in one packed transfer, and each BA's cameras go up and come back in one.

RANSAC samples come from ``sampler(step, valid)`` with step = frame index - 1
(the step that brings in that frame), keyed on (seed, step) by default: a
resumed run draws what the uninterrupted one drew, and tests inject the JAX
reference's draws through the same seam.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from ..ops import lie
from ..solvers.ba import BAConfig, BAProblem, ba_solve, gate_tracks
from ..utils.metrics import MetricsLogger
from . import frontend as fe
from . import tracks as tr
from .pipeline import Sampler, make_sampler
from .smoother import T_from_cam6, cam6_from_T
from .stereo_vo import StereoVOParams, stereo_vo_solve


class OdometryConfig(NamedTuple):
    """Same fields and defaults as the JAX OdometryConfig."""

    vo: StereoVOParams
    max_tracks: int = 500  # TrackingInfo.nb_feats (file_IO.h:69)
    window: int = 5  # TrackingInfo.window_size
    ba_rate: int = 5  # BA every ba_rate keyframes (file_IO.h:71)
    n_fixed: int = 2  # fixed frames in BA (VisualOdometry.h:25)
    matcher: fe.MatcherConfig = fe.MatcherConfig()
    klt: fe.KLTConfig = fe.KLTConfig()
    detect_nms_radius: int = 5
    detect_quality: float = 1e-4
    detector: str = "grid"  # "grid" (bucketed best-per-cell) or "topk"
    # parallax keyframe gate (TrackingInfo.parallax, file_IO.h:73): while the
    # median tracked displacement since the last keyframe is below this many
    # pixels the pose still updates, but the table, the keyframe image and
    # the BA window do not advance; 0 makes every frame a keyframe
    parallax: float = 0.0
    min_track_sep: float = 8.0  # new detections must be this far from tracks
    epipolar_tol: float = 1.5  # |v_l - v_r| rectified consistency
    ba_min_obs: int = 2
    track_gate_px: float = 3.0  # pre-BA gate against the VO-chained cameras


class StepOutput(NamedTuple):
    table: tr.TrackTable
    motion: torch.Tensor  # (4, 4) keyframe cam -> current cam
    success: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    mean_reproj_error: torch.Tensor
    n_tracks: torch.Tensor
    median_flow: torch.Tensor  # median |displacement| of the matched tracks (px)


def _detect(img: torch.Tensor, cfg: OdometryConfig):
    if cfg.detector == "grid":
        return im.detect_features_grid(img, max_features=cfg.max_tracks,
                                       quality_level=cfg.detect_quality)
    if cfg.detector == "topk":
        return im.detect_features(img, max_features=cfg.max_tracks,
                                  quality_level=cfg.detect_quality,
                                  nms_radius=cfg.detect_nms_radius)
    raise ValueError(f"unknown detector {cfg.detector!r} (\"grid\" or \"topk\")")


def track_and_solve(table: tr.TrackTable, prev_left: torch.Tensor, cur_left: torch.Tensor,
                    cur_right: torch.Tensor, step: int, sampler: Sampler | None,
                    cfg: OdometryConfig) -> StepOutput:
    """One frame on (H, W) f32 images: KLT-extend the tracks from
    ``prev_left`` (the keyframe), stereo-match them, replenish the table
    with fresh detections, and solve VO on the surviving tracks' quad
    matches with ``sampler(step, valid)``'s RANSAC samples."""
    prev_uv, prev_ok = tr.latest_uv(table)  # (M, 4), (M,)

    # 1. temporal KLT on the left camera
    tracked = fe.klt_track(prev_left, cur_left, prev_uv[:, :2], prev_ok, cfg.klt)

    # 2. stereo match at the tracked locations
    f_right, _, stereo_ok = fe.match_stereo(cur_left, cur_right, tracked.pts, tracked.valid,
                                            cfg.matcher)
    epi_ok = torch.abs(f_right[:, 1] - tracked.pts[:, 1]) <= cfg.epipolar_tol
    tracked_uv = torch.cat([tracked.pts, f_right], dim=-1)  # (M, 4)
    tracked_ok = tracked.valid & stereo_ok & epi_ok

    # 3. fresh detections away from the surviving tracks
    det_xy, _, det_ok = _detect(cur_left, cfg)
    d2 = torch.sum((det_xy[:, None, :] - tracked.pts[None, :, :]) ** 2, dim=-1)  # (K, M)
    d2 = torch.where(tracked_ok[None, :], d2, torch.full_like(d2, torch.inf))
    far = torch.amin(d2, dim=1) > cfg.min_track_sep ** 2
    new_right, _, new_stereo_ok = fe.match_stereo(cur_left, cur_right, det_xy, det_ok & far,
                                                  cfg.matcher)
    new_uv = torch.cat([det_xy, new_right], dim=-1)
    new_ok = det_ok & far & new_stereo_ok

    # 4. advance the table
    new_table = tr.advance(table, tracked_uv, tracked_ok, new_uv, new_ok)

    # 5. VO from the (keyframe, current) quad matches of the surviving tracks
    quad = torch.stack([prev_uv[:, 0:2], prev_uv[:, 2:4], tracked_uv[:, 0:2],
                        tracked_uv[:, 2:4]], dim=1)  # (M, 4, 2)
    quad_valid = prev_ok & tracked_ok
    samples = sampler(step, quad_valid) if cfg.vo.ransac else None
    res = stereo_vo_solve(quad, quad_valid, None, cfg.vo, samples=samples)

    # the median of an even count averages the two middle values, as
    # jnp.nanmedian does (torch.nanmedian would take the lower one)
    flow = torch.linalg.norm(tracked.pts - prev_uv[:, :2], dim=-1)
    median_flow = torch.nanquantile(torch.where(quad_valid, flow, torch.nan), 0.5)

    return StepOutput(table=new_table, motion=res.motion, success=res.success,
                      n_matches=torch.sum(quad_valid), n_inliers=res.n_inliers,
                      mean_reproj_error=res.mean_reproj_error,
                      n_tracks=torch.sum(new_table.active), median_flow=median_flow)


def bootstrap_frame(cur_left: torch.Tensor, cur_right: torch.Tensor,
                    cfg: OdometryConfig) -> tr.TrackTable:
    """Fill an empty table from the first stereo pair (H, W)."""
    m = cfg.max_tracks
    table = tr.empty_table(m, cfg.window, cur_left.dtype, cur_left.device)
    det_xy, _, det_ok = _detect(cur_left, cfg)
    f_right, _, stereo_ok = fe.match_stereo(cur_left, cur_right, det_xy, det_ok, cfg.matcher)
    return tr.advance(table, torch.zeros_like(table.uv[:, 0]), torch.zeros_like(table.active),
                      torch.cat([det_xy, f_right], dim=-1), det_ok & stereo_ok)


def _ba_config(cfg: OdometryConfig) -> BAConfig:
    return BAConfig(intr=cfg.vo.intr1, baseline=float(cfg.vo.baseline), n_fixed=cfg.n_fixed)


def ba_refine_window(table: tr.TrackTable, window_cams: torch.Tensor, cfg: OdometryConfig
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed BA over the table (BundleAdjuster semantics,
    BundleAdjuster.h:432-476).

    ``window_cams``: (W, 6) [angle-axis, translation] world->cam of the
    window frames, oldest first, in the BA gauge (world = window frame 0).
    Each track's point starts from its newest observation's disparity,
    moved into the gauge by that frame's camera. Returns (refined cams
    (W, 6), points (M, 3), final cost)."""
    obs, mask = tr.ba_window_view(table, min_obs=cfg.ba_min_obs)
    w = table.uv.shape[1]
    # a track without observations has -1 in every slot: argmax gives 0,
    # the first maximum, as jnp.argmax
    slot_ids = torch.arange(w, device=table.uv.device)
    newest = torch.argmax(torch.where(table.obs_mask, slot_ids, -1), dim=1)  # (M,)
    uv_new = table.uv[torch.arange(table.uv.shape[0], device=newest.device), newest]
    p = cfg.vo
    pts_cam = geo.triangulate_disparity(uv_new[:, 0:2], uv_new[:, 2:4], p.intr1, p.intr2,
                                        p.baseline)
    cam_of_track = window_cams[newest]  # (M, 6)
    R = lie.so3_exp(cam_of_track[:, :3])
    pts_world = torch.matmul(R.transpose(-1, -2),
                             (pts_cam - cam_of_track[:, 3:6])[..., None])[..., 0]
    ba_cfg = _ba_config(cfg)
    keep = gate_tracks(window_cams, pts_world, obs, mask, ba_cfg, cfg.track_gate_px)
    result = ba_solve(BAProblem(cam=window_cams, pts=pts_world, obs=obs,
                                mask=mask & keep[None, :]), ba_cfg)
    return result.cam, result.pts, result.cost


def cam6_from_pose(T_w2c: np.ndarray, device: str | torch.device = "cpu") -> torch.Tensor:
    """(..., 4, 4) world->cam matrices -> (..., 6) float32 [angle-axis,
    translation] on ``device``: one upload and one batched so3_log."""
    return cam6_from_T(torch.as_tensor(np.asarray(T_w2c, np.float32)).to(device))


def pose_from_cam6(cam6: torch.Tensor) -> torch.Tensor:
    """(..., 6) [angle-axis, translation] -> (..., 4, 4) world->cam matrices
    on cam6's device: one batched so3_exp, left on the device so that the
    caller can read it together with other results."""
    return T_from_cam6(cam6)


def _image(img, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(img):
        return img.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(img, np.float32)).to(device)


# the packed per-frame read: [motion 16, then one column each]
_PACKED = ("success", "n_matches", "n_inliers", "n_tracks", "mean_reproj_error", "median_flow")


class OdometrySystem:
    """Host frame loop with persistent tracks, the parallax keyframe gate
    and BA refinement.

    ``device``: the card by default (``device.setup_device``); ``"cpu"``
    only when asked. ``sampler``: a replacement for the RANSAC sampler,
    called as ``sampler(step, valid)`` (a seam for injecting reference
    draws); by default ``make_sampler(seed, cfg.vo.n_ransac)``.
    """

    def __init__(self, cfg: OdometryConfig, seed: int = 0, logger: MetricsLogger | None = None,
                 use_ba: bool = True, device: str | torch.device | None = None,
                 sampler: Sampler | None = None):
        self.cfg = cfg
        self.logger = logger
        self.use_ba = use_ba
        self.device = setup_device(device)
        self._injected = sampler
        self.set_seed(seed)
        self.reset()

    def set_seed(self, seed: int) -> None:
        """Key the default RANSAC sampler on ``seed`` (an injected sampler
        stays as it is)."""
        self.seed = seed
        self.sampler = self._injected or make_sampler(seed, self.cfg.vo.n_ransac)

    def reset(self):
        self.pose = np.eye(4)  # cam-to-world of the current frame
        self.trajectory = [self.pose.copy()]
        self.table: tr.TrackTable | None = None
        self.kf_left: torch.Tensor | None = None  # the last keyframe's left image
        self.kf_pose = np.eye(4)  # cam-to-world of the keyframe
        self.frame_idx = 0
        self.n_keyframes = 0
        self.window_poses: list[np.ndarray] = []  # cam-to-world per window frame
        self.window_traj_idx: list[int] = []  # trajectory index per window frame

    def process_pair(self, left, right) -> dict:
        """Feed one stereo pair (numpy arrays or tensors); returns the
        frame's metrics record."""
        left = _image(left, self.device)
        right = _image(right, self.device)
        rec: dict = {"frame": self.frame_idx}
        if self.table is None:
            self.table = bootstrap_frame(left, right, self.cfg)
            self.window_poses = [self.pose.copy()]
            self.window_traj_idx = [0]
            self.kf_left = left
            self.kf_pose = self.pose.copy()
            self.n_keyframes = 1
            rec["n_tracks"] = int(torch.sum(self.table.active))
        else:
            # tracks anchor on the last keyframe (the previous frame unless
            # the parallax gate held it): VO solves keyframe -> current
            out = track_and_solve(self.table, self.kf_left, left, right, self.frame_idx - 1,
                                  self.sampler, self.cfg)
            row = torch.cat([out.motion.reshape(16)] + [
                getattr(out, f).reshape(1).to(out.motion.dtype) for f in _PACKED])
            row = row.cpu().numpy().astype(np.float64)
            o = dict(zip(_PACKED, row[16:]))
            success = bool(o["success"] > 0.5)
            if success:
                self.pose = self.kf_pose @ np.linalg.inv(row[:16].reshape(4, 4))
            self.trajectory.append(self.pose.copy())
            flow = float(o["median_flow"])
            # parallax gate: hold the keyframe while the scene has not moved
            # enough; a failed frame always advances (stale anchors must not
            # persist through tracking loss)
            advance = (self.cfg.parallax <= 0.0 or not np.isfinite(flow)
                       or flow >= self.cfg.parallax or not success)
            rec.update(success=success, n_matches=int(o["n_matches"]),
                       n_inliers=int(o["n_inliers"]), n_tracks=int(o["n_tracks"]),
                       mean_reproj_error=float(o["mean_reproj_error"]),
                       median_flow_px=round(flow, 2), keyframe=bool(advance))
            if advance:
                self.table = out.table
                self.kf_left = left
                self.kf_pose = self.pose.copy()
                self.n_keyframes += 1
                self.window_poses.append(self.pose.copy())
                self.window_traj_idx.append(len(self.trajectory) - 1)
                if len(self.window_poses) > self.cfg.window:
                    self.window_poses.pop(0)
                    self.window_traj_idx.pop(0)
                if (self.use_ba and self.n_keyframes % self.cfg.ba_rate == 0
                        and len(self.window_poses) == self.cfg.window):
                    rec["ba_cost"] = self._run_ba()
        self.frame_idx += 1
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    def _run_ba(self) -> float:
        """Refine the window in the gauge of its oldest frame: world->cam_i
        maps frame-0 coordinates into frame i, so cam_i = inv(pose_i) @ base.
        The refined poses go back to each window keyframe's trajectory index
        (with the parallax gate on, those are not the trajectory's tail)."""
        base = self.window_poses[0]
        cams = cam6_from_pose(np.stack([np.linalg.inv(p) @ base for p in self.window_poses]),
                              self.device)
        refined, _, cost = ba_refine_window(self.table, cams, self.cfg)
        rows = torch.cat([pose_from_cam6(refined).reshape(-1), cost.reshape(1)])
        rows = rows.cpu().numpy().astype(np.float64)
        T_w2c = rows[:-1].reshape(len(self.window_poses), 4, 4)
        for i in range(self.cfg.n_fixed, len(self.window_poses)):
            cam_to_world = base @ np.linalg.inv(T_w2c[i])
            self.window_poses[i] = cam_to_world
            self.trajectory[self.window_traj_idx[i]] = cam_to_world
        self.pose = self.window_poses[-1].copy()
        self.kf_pose = self.pose.copy()
        return float(rows[-1])

    def run(self, frames: Iterable) -> np.ndarray:
        """Process (left, right) pairs; (N, 4, 4) cam-to-world poses."""
        for left, right in frames:
            self.process_pair(left, right)
        return np.asarray(self.trajectory)
