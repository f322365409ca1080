"""Monocular odometry pipeline: top-k GFTT detection + KLT + essential-matrix
egomotion, with relative-scale propagation.

Port of ``uasl_motion_estimation_tpu/models/mono_pipeline.py``, the consumer
loop around ``MonoVisualOdometry`` (SURVEY.md section 3.5): translation from
an essential matrix is known only up to scale, so each step's scale is
carried from the previous one by comparing distances between the structure
the two consecutive reconstructions share (findRelativeScale,
MonoVisualOdometry.cpp:76-87).

Two engines, as in the JAX package: the staged scan (``run_mono_staged``:
frames on the device once as uint8, ``chunk`` steps per batch with their
f32 frames and KLT pyramids built once, the relative-scale association of
all step pairs at once, one transfer of the per-step outputs) and the
per-frame loop (``MonoOdometryPipeline``). RANSAC samples come from
samplers keyed on (seed, global step), so both engines solve step i with
the same samples; ``make_mono_samplers`` gives the solver's and the hybrid
escalation's.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from ..utils.metrics import MetricsLogger
from . import frontend as fe
from .mono_vo import MonoVOParams, MonoVOResult, minimal_set, mono_vo_solve
from .pipeline import Sampler, make_sampler

# the hybrid escalation's samples: stream 5 of each step's key (JAX folds 5
# into the step's key)
ESCALATION_STREAM = 5


class MonoPipelineConfig(NamedTuple):
    """Same fields and defaults as the JAX MonoPipelineConfig."""

    vo: MonoVOParams
    max_features: int = 500
    klt: fe.KLTConfig = fe.KLTConfig()
    detect_nms_radius: int = 5
    detect_quality: float = 0.01


class MonoFrameOutput(NamedTuple):
    result: MonoVOResult
    matches: torch.Tensor  # (..., N, 2, 2) [prev uv, cur uv]
    valid: torch.Tensor  # (..., N)


class MonoScanOutput(NamedTuple):
    """Stacked per-step outputs of the staged mono scan (device)."""

    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3) unit-norm
    success: torch.Tensor  # (B,)
    n_inliers: torch.Tensor  # (B,)
    n_matches: torch.Tensor  # (B,) valid tracked matches into the solver
    rel_scale: torch.Tensor  # (B,) scale of step i relative to step i-1; [0] = 1


def make_mono_samplers(seed: int, vo: MonoVOParams) -> tuple[Sampler, Sampler]:
    """(sampler, sampler5): the solver's Gumbel-top-k samples
    (k = ``minimal_set(vo.solver)``) keyed on (seed, global step), and the
    hybrid escalation's 5-point samples keyed on (seed, global step, 5)."""
    return (make_sampler(seed, vo.n_ransac, k=minimal_set(vo.solver)),
            make_sampler(seed, vo.n_ransac, k=5, stream=ESCALATION_STREAM))


def _draw(sampler: Sampler, steps, valid: torch.Tensor) -> torch.Tensor:
    return torch.stack([sampler(s, v) for s, v in zip(steps, valid, strict=True)])


# the stages of one batch of steps, in the order _step runs them (each one
# function, which tools/mono_stage_split.py times)
def _detect(prev: torch.Tensor, cfg: MonoPipelineConfig):
    """The top-k GFTT features of the previous frames (B, H, W):
    (xy (B, N, 2), scores, valid (B, N))."""
    return im.detect_features(prev, max_features=cfg.max_features,
                              quality_level=cfg.detect_quality, nms_radius=cfg.detect_nms_radius)


def _track(prev, cur, feats, v0, cfg: MonoPipelineConfig, pyr_prev=None, pyr_cur=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """KLT of the features from prev to cur: matches (B, N, 2, 2) [prev uv,
    cur uv] and their valid mask (B, N)."""
    tracked = fe.klt_track(prev, cur, feats, v0, cfg.klt, pyr_prev=pyr_prev, pyr_next=pyr_cur)
    return torch.stack([feats, tracked.pts], dim=-2), tracked.valid


def draw_samples(steps, valid: torch.Tensor, samplers, cfg: MonoPipelineConfig):
    """The solver's samples of the global ``steps`` and, for ``"hybrid"``,
    its escalation's (else None); ``samplers`` is (sampler, sampler5)."""
    sampler, sampler5 = samplers
    if cfg.vo.solver != "hybrid":
        return _draw(sampler, steps, valid), None
    if sampler5 is None:
        raise ValueError("solver='hybrid' needs sampler5 for its escalation")
    return _draw(sampler, steps, valid), _draw(sampler5, steps, valid)


def _step(prev, cur, steps, samplers, cfg: MonoPipelineConfig, pyr_prev=None, pyr_cur=None,
          stats: dict | None = None) -> MonoFrameOutput:
    """Detect in prev, KLT to cur, solve essential + pose, for a batch of
    steps (global indices ``steps``) on f32 images (B, H, W). ``stats``
    goes to ``mono_vo_solve`` (the hybrid's escalation masks)."""
    feats, _, v0 = _detect(prev, cfg)
    matches, valid = _track(prev, cur, feats, v0, cfg, pyr_prev, pyr_cur)
    samples, samples5 = draw_samples(steps, valid, samplers, cfg)
    res = mono_vo_solve(matches, valid, samples, cfg.vo, samples5, stats)
    return MonoFrameOutput(result=res, matches=matches, valid=valid)


def mono_vo_step(prev_img, cur_img, step: int, sampler: Sampler, cfg: MonoPipelineConfig,
                 sampler5: Sampler | None = None) -> MonoFrameOutput:
    """One mono frame on (H, W) images (uint8 or f32; compute is f32):
    detect in prev, KLT to cur, solve essential + pose for global step
    ``step``. ``sampler5``: the hybrid escalation's sampler."""
    out = _step(prev_img.to(torch.float32)[None], cur_img.to(torch.float32)[None], [step],
                (sampler, sampler5), cfg)
    return MonoFrameOutput(MonoVOResult(*(x[0] for x in out.result)), out.matches[0],
                           out.valid[0])


def _relative_scales(m_prev, m_cur, inl_prev, inl_cur, p3_prev, p3_cur, R_prev, t_prev
                     ) -> torch.Tensor:
    """findRelativeScale between consecutive steps, batched over step pairs
    (...): the previous step's current-frame track positions are matched to
    this step's detections in the same (shared) frame by nearest neighbour
    (first index on ties, within 1 px), and the previous structure, moved
    into the shared frame, is compared with this step's."""
    prev_pts = m_prev[..., :, 1, :]
    cur_pts = m_cur[..., :, 0, :]
    d2 = torch.sum((prev_pts[..., :, None, :] - cur_pts[..., None, :, :]) ** 2, dim=-1)
    nn = torch.argmin(d2, dim=-1)  # first minimum, as jnp.argmin
    close = torch.take_along_dim(d2, nn[..., None], dim=-1)[..., 0] < 1.0
    mask = close & inl_prev & torch.take_along_dim(inl_cur, nn, dim=-1)
    prev_3d = torch.matmul(p3_prev, R_prev.transpose(-1, -2)) + t_prev[..., None, :]
    cur_3d = torch.take_along_dim(p3_cur, nn[..., None], dim=-2)
    return geo.relative_scale(prev_3d, cur_3d, mask)


def _mono_scan(ls, step0: int, samplers, cfg: MonoPipelineConfig, chunk: int
               ) -> tuple[MonoScanOutput, MonoFrameOutput, dict]:
    """mono_sequence_scan, also returning every step's MonoFrameOutput and,
    for ``"hybrid"``, the (B,) ``escalated`` and ``replaced`` masks (else
    an empty dict)."""
    n = int(ls.shape[0])
    outs, hyb = [], []
    for base in range(0, n - 1, chunk):
        m = min(chunk, n - 1 - base)
        lf = ls[base:base + m + 1].to(torch.float32)
        pyr = im.build_pyramid(lf, cfg.klt.n_levels)
        hyb.append({})
        outs.append(_step(lf[:-1], lf[1:], list(range(step0 + base, step0 + base + m)), samplers,
                          cfg, pyr_prev=[p[:-1] for p in pyr], pyr_cur=[p[1:] for p in pyr],
                          stats=hyb[-1]))
    res = MonoVOResult(*(torch.cat(xs) for xs in zip(*(o.result for o in outs))))
    steps = MonoFrameOutput(res, torch.cat([o.matches for o in outs]),
                            torch.cat([o.valid for o in outs]))
    m = steps.matches
    rel = torch.ones(m.shape[0], dtype=res.t.dtype, device=m.device)
    if m.shape[0] > 1:
        rel[1:] = _relative_scales(m[:-1], m[1:], res.inlier_mask[:-1], res.inlier_mask[1:],
                                   res.pts3d[:-1], res.pts3d[1:], res.R[:-1], res.t[:-1])
    scan = MonoScanOutput(R=res.R, t=res.t, success=res.success, n_inliers=res.n_inliers,
                          n_matches=torch.sum(steps.valid, dim=-1), rel_scale=rel)
    return scan, steps, {k: torch.cat([h[k] for h in hyb]) for k in hyb[0]}


def mono_sequence_scan(ls: torch.Tensor, step0: int, sampler: Sampler, cfg: MonoPipelineConfig,
                       chunk: int = 8, sampler5: Sampler | None = None) -> MonoScanOutput:
    """All n-1 steps of a staged mono sequence ``ls`` (n, H, W) (uint8 or
    f32), ``chunk`` steps at a time: each group converts its chunk + 1
    frames to f32 and builds their KLT pyramids once, shared by the two
    steps that use each frame (the last group may be shorter; no padded
    steps are computed). Then the relative-scale association of all
    consecutive step pairs at once. ``step0`` is the global index of the
    first step; ``sampler5`` is the hybrid escalation's sampler."""
    return _mono_scan(ls, step0, (sampler, sampler5), cfg, chunk)[0]


def _pack_result(R, t, success, n_inliers, *rest) -> torch.Tensor:
    """(B, 14 + len(rest)) float32 rows [R 9, t 3, success, n_inliers,
    rest...], read on the host in one transfer."""
    f32 = R.dtype
    cols = [R.reshape(-1, 9), t.reshape(-1, 3), success.reshape(-1, 1).to(f32),
            n_inliers.reshape(-1, 1).to(f32)]
    return torch.cat(cols + [x.reshape(-1, 1).to(f32) for x in rest], dim=1)


def _motion(R, t, speed: float) -> np.ndarray:
    motion = np.eye(4)
    motion[:3, :3] = np.asarray(R, np.float64)
    motion[:3, 3] = np.asarray(t, np.float64) * speed
    return motion


def run_mono_staged(
    frames,
    cfg: MonoPipelineConfig,
    seed: int = 0,
    initial_speed: float = 1.0,
    chunk: int = 8,
    device: str | torch.device | None = None,
    sampler: Sampler | None = None,
    sampler5: Sampler | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Host API for the staged mono engine: (N, 4, 4) cam-to-world chain
    composed in float64, with relative-scale speed propagation and the
    degraded-frame contract (a failed step keeps the pose and the speed).

    ``solver="hybrid"`` escalates inside the scan, per chunk: only the
    steps whose pencil solution failed or whose inlier ratio fell below
    ``hybrid_ratio`` are re-solved with the exact 5-point, as one batch
    (``mono_vo_solve``). The JAX package escalates after its scan instead,
    because its vmapped ``lax.cond`` would run both solvers on every step;
    the steps escalated, their samples and the motions kept are the same,
    but here a replaced step's relative scale comes from the structure of
    the solution kept, as in the per-frame engine, where JAX's staged
    engine keeps the pencil's. ``sampler``/``sampler5`` replace
    ``make_mono_samplers(seed, cfg.vo)``. ``stats``, when given, gets the
    per-step ``success``, ``n_inliers``, ``n_matches`` and ``rel_scale``,
    and the ``escalated`` and ``replaced`` steps."""
    dev = setup_device(device)
    default, default5 = make_mono_samplers(seed, cfg.vo)
    stack = np.stack([np.asarray(f) for f in frames])
    ls = torch.from_numpy(np.clip(stack, 0, 255).astype(np.uint8)).to(dev)
    b = int(ls.shape[0]) - 1
    scan, _, hyb = _mono_scan(ls, 0, (sampler or default, sampler5 or default5), cfg, chunk)
    host = _pack_result(scan.R, scan.t, scan.success, scan.n_inliers, scan.n_matches,
                        scan.rel_scale, *hyb.values()).cpu().numpy()
    succ = host[:, 12] > 0.5
    if stats is not None:
        steps = {k: np.nonzero(host[:, 16 + j] > 0.5)[0].tolist() for j, k in enumerate(hyb)}
        stats.update(success=succ.tolist(), n_inliers=host[:, 13].astype(np.int64).tolist(),
                     n_matches=host[:, 14].astype(np.int64).tolist(),
                     rel_scale=host[:, 15].tolist(), escalated=steps.get("escalated", []),
                     replaced=steps.get("replaced", []))

    pose = np.eye(4)
    traj = [pose.copy()]
    speed = float(initial_speed)
    for i in range(b):
        if succ[i]:
            if i > 0:
                s = float(host[i, 15])
                if np.isfinite(s) and 0.1 < s < 10.0:
                    speed *= s
            pose = pose @ np.linalg.inv(_motion(host[i, :9].reshape(3, 3), host[i, 9:12], speed))
        traj.append(pose.copy())
    return np.asarray(traj)


class MonoOdometryPipeline:
    """Per-frame loop: pose chain with relative-scale propagation.

    The first motion's translation is normalized to ``initial_speed`` (mono
    gauge freedom); later frames inherit metric consistency through the
    relative scale of shared triangulated structure."""

    def __init__(self, cfg: MonoPipelineConfig, seed: int = 0, initial_speed: float = 1.0,
                 logger: MetricsLogger | None = None, device: str | torch.device | None = None):
        self.cfg = cfg
        self.initial_speed = initial_speed
        self.logger = logger
        self.device = setup_device(device)
        self.sampler, self.sampler5 = make_mono_samplers(seed, cfg.vo)
        self.reset()

    def reset(self):
        self.pose = np.eye(4)
        self.trajectory = [self.pose.copy()]
        self.prev_img: torch.Tensor | None = None
        self.prev_out: MonoFrameOutput | None = None
        self.speed = self.initial_speed
        self.frame_idx = 0

    def process_frame(self, img: np.ndarray) -> dict:
        img = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        rec: dict = {"frame": self.frame_idx}
        if self.prev_img is not None:
            # samples keyed on the GLOBAL step index: the staged engine
            # solves each step with the same ones
            out = mono_vo_step(self.prev_img, img, self.frame_idx - 1, self.sampler, self.cfg,
                               self.sampler5)
            res = out.result
            rel = [self._relative_scale(out)] if self.prev_out is not None else []
            host = _pack_result(res.R, res.t, res.success, res.n_inliers, *rel).cpu().numpy()[0]
            success = bool(host[12] > 0.5)
            if success:
                if rel and np.isfinite(host[14]) and 0.1 < host[14] < 10.0:
                    self.speed *= float(host[14])
                self.pose = self.pose @ np.linalg.inv(
                    _motion(host[:9].reshape(3, 3), host[9:12], self.speed))
            rec.update(success=success, n_inliers=int(host[13]))
            self.trajectory.append(self.pose.copy())
            self.prev_out = out
        self.prev_img = img
        self.frame_idx += 1
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    def _relative_scale(self, out: MonoFrameOutput) -> torch.Tensor:
        """Ratio of distances between the structure this step and the last
        share (findRelativeScale semantics), on the device: ()."""
        prev = self.prev_out
        return _relative_scales(prev.matches, out.matches, prev.result.inlier_mask,
                                out.result.inlier_mask, prev.result.pts3d, out.result.pts3d,
                                prev.result.R, prev.result.t)

    def run(self, frames: Iterable[np.ndarray]) -> np.ndarray:
        for f in frames:
            self.process_frame(f)
        return np.asarray(self.trajectory)
