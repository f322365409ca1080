"""End-to-end stereo odometry pipeline: frames in, trajectory out.

Port of ``uasl_motion_estimation_tpu/models/pipeline.py``: front-end
(models/frontend.py) -> stereo VO (models/stereo_vo.py) -> pose chain
composed on the host in float64.

The staged engine keeps the JAX design: frames go to the device once as
uint8; each group of ``chunk`` steps converts its ``chunk + 1`` frames to
f32 and builds their left pyramids ONCE, then runs all its steps as one
batch (the leading dim that ``vmap`` gives in JAX). RANSAC samples for step
``i`` come from a generator keyed on the global step index, so the
per-frame and staged engines solve step ``i`` with the same samples.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from . import frontend as fe
from .stereo_vo import StereoVOParams, _sample_hypotheses, stereo_vo_solve

# sampler(step, valid (N,) bool) -> (n_ransac, 3) int64 match-index triples
Sampler = Callable[[int, torch.Tensor], torch.Tensor]


class PipelineConfig(NamedTuple):
    vo: StereoVOParams
    max_features: int = 500  # TrackingInfo.nb_feats default (file_IO.h:69-73)
    matcher: fe.MatcherConfig = fe.MatcherConfig()
    klt: fe.KLTConfig = fe.KLTConfig()
    detect_nms_radius: int = 5
    detect_quality: float = 1e-4
    detector: str = "grid"  # "grid" bucketed GFTT ("topk" is not ported yet)


class FrameOutput(NamedTuple):
    motion: torch.Tensor  # (..., 4, 4) prev-cam -> cur-cam
    state: torch.Tensor  # (..., 6)
    success: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    mean_reproj_error: torch.Tensor
    cov: torch.Tensor  # (..., 6, 6) motion covariance ([dt, dtheta] tangent)


def _step(prev_left, prev_right, cur_left, cur_right, steps, sampler, cfg,
          pyr_prev=None, pyr_cur=None) -> FrameOutput:
    """Front-end + pose solve for a batch of steps (global indices
    ``steps``) on f32 images (B, H, W)."""
    qm = fe.quad_match_frames(
        prev_left, prev_right, cur_left, cur_right,
        max_features=cfg.max_features, matcher=cfg.matcher, klt=cfg.klt,
        detect_kwargs=(("nms_radius", cfg.detect_nms_radius),
                       ("quality_level", cfg.detect_quality)),
        detector=cfg.detector, pyr_prev_left=pyr_prev, pyr_cur_left=pyr_cur,
    )
    samples = None
    if cfg.vo.ransac:
        samples = torch.stack([sampler(s, v) for s, v in zip(steps, qm.valid, strict=True)])
    res = stereo_vo_solve(qm.uv, qm.valid, None, cfg.vo, samples=samples)
    return FrameOutput(motion=res.motion, state=res.state, success=res.success,
                       n_matches=torch.sum(qm.valid, dim=-1), n_inliers=res.n_inliers,
                       mean_reproj_error=res.mean_reproj_error, cov=res.cov)


def vo_step(prev_left, prev_right, cur_left, cur_right, step: int,
            sampler: Sampler, cfg: PipelineConfig) -> FrameOutput:
    """One frame of odometry on (H, W) images (uint8 or f32; compute is f32)."""
    imgs = [x.to(torch.float32)[None] for x in (prev_left, prev_right, cur_left, cur_right)]
    out = _step(*imgs, [step], sampler, cfg)
    return FrameOutput(*(x[0] for x in out))


def vo_sequence_scan_shared(ls: torch.Tensor, rs: torch.Tensor, step0: int,
                            sampler: Sampler, cfg: PipelineConfig,
                            chunk: int = 8) -> FrameOutput:
    """All n-1 steps of a staged sequence (n, H, W), ``chunk`` steps at a
    time. Per group, the f32 conversion and KLT pyramids of its chunk+1
    frames are built once and shared by the two steps that use each frame;
    device memory for front-end intermediates stays O(chunk) frames. The
    last group may be shorter (no padded steps are computed).

    Returns FrameOutput with n-1 entries along the leading dim."""
    n = int(ls.shape[0])
    outs = []
    for base in range(0, n - 1, chunk):
        m = min(chunk, n - 1 - base)
        lf = ls[base:base + m + 1].to(torch.float32)
        rf = rs[base:base + m + 1].to(torch.float32)
        pyr = im.build_pyramid(lf, cfg.klt.n_levels)
        outs.append(_step(
            lf[:-1], rf[:-1], lf[1:], rf[1:],
            list(range(step0 + base, step0 + base + m)), sampler, cfg,
            pyr_prev=[p[:-1] for p in pyr], pyr_cur=[p[1:] for p in pyr]))
    return FrameOutput(*(torch.cat(xs) for xs in zip(*outs)))


def _vo_scan_packed(ls, rs, step0, sampler, cfg, chunk) -> torch.Tensor:
    """vo_sequence_scan_shared with the per-step outputs packed into one
    (B, 20) f32 tensor [motion 16, success, n_matches, n_inliers,
    mean_reproj_error], so the host reads them in one transfer."""
    out = vo_sequence_scan_shared(ls, rs, step0, sampler, cfg, chunk)
    b = out.motion.shape[0]
    f32 = out.motion.dtype
    return torch.cat([
        out.motion.reshape(b, 16),
        out.success[:, None].to(f32),
        out.n_matches[:, None].to(f32),
        out.n_inliers[:, None].to(f32),
        out.mean_reproj_error[:, None].to(f32),
    ], dim=1)


class OdometryPipeline:
    """Host-side frame loop with the reference's degraded-frame contract: a
    failed frame keeps the last pose (SURVEY.md section 5).

    ``sampler``: optional replacement for the RANSAC sampler, called as
    ``sampler(step, valid)`` (a test seam for injecting reference samples).
    """

    def __init__(self, cfg: PipelineConfig, seed: int = 0, logger=None,
                 device: str | torch.device | None = None,
                 sampler: Sampler | None = None):
        self.cfg = cfg
        self.seed = seed
        self.logger = logger
        self.device = setup_device(device)
        self.sampler = sampler or self._sample
        self.reset()

    def _sample(self, step: int, valid: torch.Tensor) -> torch.Tensor:
        """Gumbel-top-3 samples from a generator keyed on (seed, global
        step): every engine solves step i with the same samples."""
        gen = torch.Generator(device=valid.device)
        gen.manual_seed((self.seed << 32) + step)
        return _sample_hypotheses(gen, self.cfg.vo.n_ransac, valid)

    def reset(self):
        self.pose = np.eye(4)  # cam-to-world of current frame
        self.trajectory = [self.pose.copy()]
        self.prev_pair: tuple | None = None
        self.frame_idx = 0

    def _to_device(self, img, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(device=self.device, dtype=dtype)

    def _chain(self, packed: np.ndarray) -> None:
        """Compose the host pose chain in float64 from packed step rows."""
        pose = self.pose.copy()
        for i in range(packed.shape[0]):
            success = bool(packed[i, 16] > 0.5)
            if success:
                # pose_cur = pose_prev * motion^-1 (motion maps prev->cur pts)
                pose = pose @ np.linalg.inv(packed[i, :16].reshape(4, 4).astype(np.float64))
            self.trajectory.append(pose.copy())
            if self.logger is not None:
                self.logger.log(frame=self.frame_idx + i + 1, success=success,
                                n_matches=int(packed[i, 17]), n_inliers=int(packed[i, 18]),
                                mean_reproj_error=float(packed[i, 19]))
        self.pose = pose

    def process_pair(self, left: np.ndarray, right: np.ndarray) -> dict:
        """Feed one stereo pair; returns the per-frame metrics record."""
        left = self._to_device(left, torch.float32)
        right = self._to_device(right, torch.float32)
        rec: dict = {"frame": self.frame_idx}
        if self.prev_pair is not None:
            out = vo_step(*self.prev_pair, left, right, self.frame_idx - 1,
                          self.sampler, self.cfg)
            motion, success, n_m, n_i, err = (
                t.cpu().numpy() for t in (out.motion, out.success, out.n_matches,
                                          out.n_inliers, out.mean_reproj_error))
            if bool(success):
                self.pose = self.pose @ np.linalg.inv(motion.astype(np.float64))
            rec.update(success=bool(success), n_matches=int(n_m), n_inliers=int(n_i),
                       mean_reproj_error=float(err))
            self.trajectory.append(self.pose.copy())
        self.prev_pair = (left, right)
        self.frame_idx += 1
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    def run(self, frames: Iterable[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
        """Process a whole sequence pair by pair; (N, 4, 4) cam-to-world poses."""
        for left, right in frames:
            self.process_pair(left, right)
        return np.asarray(self.trajectory)

    def stage_frames(self, frames: list[tuple[np.ndarray, np.ndarray]]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Upload a frame sequence to the device as uint8 (4x fewer bytes
        than f32; converted on the device). Returns (lefts, rights)."""
        ls = np.stack([np.asarray(f[0]) for f in frames])
        rs = np.stack([np.asarray(f[1]) for f in frames])
        ls = self._to_device(np.clip(ls, 0, 255).astype(np.uint8), torch.uint8)
        rs = self._to_device(np.clip(rs, 0, 255).astype(np.uint8), torch.uint8)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ls, rs

    def run_staged(self, ls: torch.Tensor, rs: torch.Tensor, chunk: int = 8) -> np.ndarray:
        """Whole staged sequence; the per-step outputs come back in one
        transfer and the pose chain is composed on the host in float64.
        Returns (N, 4, 4) cam-to-world poses."""
        n = int(ls.shape[0])
        packed = _vo_scan_packed(ls, rs, self.frame_idx, self.sampler, self.cfg,
                                 chunk).cpu().numpy()
        self._chain(packed)
        self.frame_idx += n
        return np.asarray(self.trajectory)


def default_config(
    intr: geo.Intrinsics,
    baseline: float,
    image_shape: tuple[int, int] | None = None,
    **vo_overrides,
) -> PipelineConfig:
    """Reference-default pipeline config; ``image_shape`` (h, w) scales the
    RANSAC spread gate (1000 px^2 at KITTI resolution, cpp:63) with area."""
    if image_shape is not None and "min_spread_area" not in vo_overrides:
        h, w = image_shape
        vo_overrides["min_spread_area"] = 1000.0 * (h * w) / (376.0 * 1241.0)
    vo = StereoVOParams(intr1=intr, intr2=intr, baseline=baseline, **vo_overrides)
    return PipelineConfig(vo=vo)
