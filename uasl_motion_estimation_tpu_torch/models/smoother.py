"""Integrated system: a unified track table feeding both per-motion VO and
window-parallel bundle adjustment.

Port of ``uasl_motion_estimation_tpu/models/smoother.py`` (the unified
engine). Windows of ``window`` frames tile the sequence at stride
``ba_rate``; each detects once in its birth frame and KLT/ZNCC-extends its
tracks through the rest (the reference's WBA_Point bookkeeping,
feature_types.h:122-197). Every consecutive-frame motion in a window is
solved by the stereo VO on quad matches read from that table, BA starts
from those motions and refines the window, and the host installs the
refined motions and composes the pose chain in float64.

Where JAX ``vmap``s over windows and ``lax.map``s over groups of
``wchunk`` windows, the port takes a group's windows as the leading batch
dimension of the front-end, the VO and BA, and loops over groups in Python,
so device memory holds one group's working set. Each group packs its
outputs into float32 rows on the device, and a scan's rows reach the host
in one transfer.

RANSAC samples come from ``sampler(motion, valid)`` with the GLOBAL motion
index (JAX keys them by ``fold_in(base_key, index)``): by default a
generator keyed on (seed, index), as ``OdometryPipeline`` draws them, so
overlapping windows, the staged and the streaming engines solve the same
problems.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from ..ops import lie
from ..solvers.ba import BAConfig, BAProblem, ba_camera_covariances, ba_solve, gate_tracks
from ..utils import profiling
from . import frontend as fe
from .pipeline import PipelineConfig, Sampler, _u8, make_sampler, stream_stacks
from .stereo_vo import stereo_vo_solve


class SmootherConfig(NamedTuple):
    """Same fields and defaults as the JAX SmootherConfig (see its comments
    for why each default)."""

    pipe: PipelineConfig
    window: int = 5  # TrackingInfo.window_size default (file_IO.h:69)
    # window stride; must satisfy ba_rate <= window - 1, or motions would be
    # left with no covering window (the engines raise)
    ba_rate: int = 4
    n_fixed: int = 1  # gauge: stereo BA has metric scale from the baseline
    ba_min_obs: int = 2
    ba_max_iter: int = 25
    huber_delta: float = 1.0  # HuberLoss(1.0), BundleAdjuster.h:447
    track_gate_px: float = 3.0  # pre-BA track gate against the VO-chained init
    min_frame_obs: int = 15  # gated observations at both ends of a BA install
    track_mode: str = "chain"  # "chain" KLT j-1 -> j | "template" against frame 0
    install_disc_px: float = 4.8  # refined-vs-VO install cap, pixel-equivalent
    install_disc_depth_m: float = 15.0  # nominal depth for dt -> px


class FullSystemResult(NamedTuple):
    traj_vo: np.ndarray  # (N, 4, 4) cam-to-world, VO chain only
    traj_ba: np.ndarray  # (N, 4, 4) cam-to-world, BA-refined
    per_frame: np.ndarray  # (B, 20) packed VO stats
    ba_cost: np.ndarray  # (K,)
    ba_converged: np.ndarray  # (K,)
    n_track_obs: np.ndarray  # (K,)
    # per installed motion ([dt, dtheta] tangent): BA motion covariance where
    # a refinement was installed, the VO solve's otherwise (B, 6, 6)
    motion_cov: np.ndarray
    # per-frame pose covariance along traj_ba, chained in float64 (N, 6, 6)
    pose_cov: np.ndarray


def _detect_and_match(left, right, cfg: PipelineConfig):
    """Grid-GFTT detection + ZNCC stereo match on birth frames (..., H, W)."""
    feats, _, v0 = im.detect_features_grid(left, max_features=cfg.max_features,
                                           quality_level=cfg.detect_quality)
    f_right, _, sv = fe.match_stereo(left, right, feats, v0, cfg.matcher)
    return feats, f_right, v0 & sv


def _frames_at(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] for host indices, without uploading them: (K, H, W)."""
    return torch.stack([x[int(i)] for i in idx])


def _build_window_tracks(lf: torch.Tensor, rf: torch.Tensor, starts,
                         cfg: SmootherConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Track tables of K windows at once: detect in each window's first
    frame, then KLT + stereo-match through its other window-1 frames.

    ``lf``, ``rf`` (n, H, W) float32; ``starts`` (K,) host window starts.
    Returns (obs (K, W, M, 4) [ul, vl, ur, vr], mask (K, W, M) bool). A
    track's mask is monotone: once lost it stays lost."""
    with profiling.span("unified.tracks"):
        p = cfg.pipe
        starts = [int(s) for s in starts]
        l0, r0 = _frames_at(lf, starts), _frames_at(rf, starts)
        feats, f_right, valid = _detect_and_match(l0, r0, p)

        obs_slices = [torch.cat([feats, f_right], dim=-1)]
        mask_slices = [valid]
        pts = feats
        disp = feats[..., 0] - f_right[..., 0]
        pyr0 = im.build_pyramid(l0, p.klt.n_levels)
        pyr_prev = pyr0
        for j in range(1, cfg.window):
            lj = _frames_at(lf, [s + j for s in starts])
            rj = _frames_at(rf, [s + j for s in starts])
            pyr_cur = im.build_pyramid(lj, p.klt.n_levels)
            if cfg.track_mode == "template":
                # anchored on the birth template, seeded by the chained position
                tracked = fe.klt_track(l0, lj, feats, valid, p.klt, init_next=pts,
                                       pyr_prev=pyr0, pyr_next=pyr_cur)
            else:
                tracked = fe.klt_track(l0, lj, pts, valid, p.klt, pyr_prev=pyr_prev,
                                       pyr_next=pyr_cur)
            fr, _, sv = fe.match_stereo(lj, rj, tracked.pts, tracked.valid, p.matcher,
                                        d_prior=disp)
            valid = valid & tracked.valid & sv
            obs_slices.append(torch.cat([tracked.pts, fr], dim=-1))
            mask_slices.append(valid)
            pts = tracked.pts
            disp = tracked.pts[..., 0] - fr[..., 0]
            pyr_prev = pyr_cur
        return torch.stack(obs_slices, dim=1), torch.stack(mask_slices, dim=1)


def _inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.matmul(Rt, T[..., :3, 3:4])
    return torch.cat([torch.cat([Rt, t], dim=-1), T[..., 3:4, :]], dim=-2)


def cam6_from_T(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([lie.so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def T_from_cam6(c: torch.Tensor) -> torch.Tensor:
    top = torch.cat([lie.so3_exp(c[..., :3]), c[..., 3:6, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _init_window_problem_local(motions_local: torch.Tensor, obs: torch.Tensor,
                               mask: torch.Tensor, cfg: SmootherConfig) -> BAProblem:
    """BAProblems of windows (leading batch dims) in their frame-0 gauge:
    cameras chained from the window-local step motions (..., W-1, 4, 4),
    points triangulated from the birth-frame disparity (project3D,
    StereoVisualOdometry.cpp:22-32), tracks gated against that init."""
    p = cfg.pipe.vo
    T = torch.eye(4, dtype=motions_local.dtype, device=motions_local.device)
    T = T.expand(*motions_local.shape[:-3], 4, 4)
    cams = [torch.zeros(*motions_local.shape[:-3], 6, dtype=motions_local.dtype,
                        device=motions_local.device)]
    for j in range(1, cfg.window):
        T = torch.matmul(motions_local[..., j - 1, :, :], T)
        cams.append(cam6_from_T(T))
    cam0 = torch.stack(cams, dim=-2)  # (..., W, 6) world(=frame 0) -> cam
    pts = geo.triangulate_disparity(obs[..., 0, :, 0:2], obs[..., 0, :, 2:4], p.intr1,
                                    p.intr2, p.baseline)
    keep = mask[..., 0, :] & (torch.sum(mask, dim=-2) >= cfg.ba_min_obs)
    gate_cfg = BAConfig(intr=p.intr1, baseline=float(p.baseline))
    keep = keep & gate_tracks(cam0, pts, obs, mask, gate_cfg, cfg.track_gate_px)
    return BAProblem(cam=cam0, pts=pts, obs=obs, mask=mask & keep[..., None, :])


def unified_window_starts(n_frames: int, window: int, stride: int) -> np.ndarray:
    """Window starts tiling every motion: 0, stride, ... with a final window
    clamped to n_frames - window so the sequence tail is always covered."""
    if n_frames < window:
        return np.zeros((0,), np.int32)
    starts = list(range(0, n_frames - window + 1, stride))
    if starts[-1] != n_frames - window:
        starts.append(n_frames - window)
    return np.asarray(starts, np.int32)


class UnifiedOutput(NamedTuple):
    """Per-window outputs of the unified scan (numpy, on the host)."""

    vo_motions: np.ndarray  # (K, W-1, 4, 4) per-window VO step motions
    vo_success: np.ndarray  # (K, W-1) bool
    vo_n_matches: np.ndarray  # (K, W-1) int32
    vo_n_inliers: np.ndarray  # (K, W-1) int32
    vo_err: np.ndarray  # (K, W-1) mean reprojection error
    refined_motions: np.ndarray  # (K, W-1, 4, 4) BA-refined
    ba_cost: np.ndarray  # (K,)
    ba_converged: np.ndarray  # (K,) bool
    n_track_obs: np.ndarray  # (K,) int32
    n_frame_obs: np.ndarray  # (K, W) int32 gated observations per window frame
    vo_cov: np.ndarray  # (K, W-1, 6, 6) VO motion covariances ([dt, dtheta])
    cam_cov: np.ndarray  # (K, W, 6, 6) BA camera covariances (gauge frame 0)
    ba_motion_cov: np.ndarray  # (K, W-1, 6, 6) refined-motion covariances


def _layout(W: int) -> tuple:
    """(dtype, per-window shape) of each UnifiedOutput field, in order: the
    layout of the packed float32 rows a scan sends to the host."""
    f, i, b = np.float32, np.int32, bool
    return ((f, (W - 1, 4, 4)), (b, (W - 1,)), (i, (W - 1,)), (i, (W - 1,)), (f, (W - 1,)),
            (f, (W - 1, 4, 4)), (f, ()), (b, ()), (i, ()), (i, (W,)), (f, (W - 1, 6, 6)),
            (f, (W, 6, 6)), (f, (W - 1, 6, 6)))


def _unpack(packed: np.ndarray, window: int) -> UnifiedOutput:
    """(K, F) float32 rows -> UnifiedOutput (integer and bool fields are
    exact in float32: counts stay far below 2^24)."""
    fields, col = [], 0
    for dtype, shape in _layout(window):
        size = int(np.prod(shape))
        fields.append(packed[:, col:col + size].reshape(-1, *shape).astype(dtype))
        col += size
    return UnifiedOutput(*fields)


def _motion_covs_from_cam_covs(cam: torch.Tensor, cam_cov: torch.Tensor) -> torch.Tensor:
    """(..., W, 6) cameras + (..., W, 6, 6) camera covariances -> (..., W-1,
    6, 6) covariances of the step motions m_j = T_{j+1} T_j^{-1} on the
    [dt, dtheta] right tangent: first order, with the Jacobian of the motion
    with respect to both endpoint cameras (``torch.func.jacfwd``), the
    cameras treated as independent."""
    from torch.func import jacfwd, vmap

    # each motion's tensors keep a leading unit dim inside the transforms:
    # torch.func gives float64 tangents through where() on 0-d float32
    # tensors, which then meet the float32 primals
    def one(c_j, c_j1, C_j, C_j1):  # (1, 6), (1, 6), (6, 6), (6, 6)
        m0_inv = _inv_se3(T_from_cam6(c_j1) @ _inv_se3(T_from_cam6(c_j)))

        def delta(d):  # (1, 12) -> (1, 6)
            mm = T_from_cam6(c_j1 + d[:, 6:]) @ _inv_se3(T_from_cam6(c_j + d[:, :6]))
            dM = m0_inv @ mm
            return torch.cat([dM[:, :3, 3], lie.so3_log(dM[:, :3, :3])], dim=-1)

        J = jacfwd(delta)(torch.zeros(1, 12, dtype=cam.dtype, device=cam.device))[0, :, 0]
        return J[:, :6] @ C_j @ J[:, :6].T + J[:, 6:] @ C_j1 @ J[:, 6:].T

    lead = cam.shape[:-2]
    W = cam.shape[-2]
    c = cam.reshape(-1, W, 1, 6)
    C = cam_cov.reshape(-1, W, 6, 6)
    out = vmap(one)(c[:, :-1].reshape(-1, 1, 6), c[:, 1:].reshape(-1, 1, 6),
                    C[:, :-1].reshape(-1, 6, 6), C[:, 1:].reshape(-1, 6, 6))
    return out.reshape(*lead, W - 1, 6, 6)


def _ba_config(cfg: SmootherConfig) -> BAConfig:
    return BAConfig(intr=cfg.pipe.vo.intr1, baseline=float(cfg.pipe.vo.baseline),
                    n_fixed=cfg.n_fixed, max_iter=cfg.ba_max_iter, huber_delta=cfg.huber_delta)


def _quad_matches(obs: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quad matches of each window's motions read from its track table:
    motion j has prev = frame j, cur = frame j+1, as (k, W-1, M, 4, 2)
    [prevL, prevR, curL, curR], and its validity (k, W-1, M) (monotone
    masks: valid at j+1 implies valid at j)."""
    quv = torch.stack([obs[:, :-1, :, 0:2], obs[:, :-1, :, 2:4],
                       obs[:, 1:, :, 0:2], obs[:, 1:, :, 2:4]], dim=-2)
    return quv, mask[:, 1:]


def _group_samples(qvalid: torch.Tensor, start_group: np.ndarray, sampler: Sampler,
                   index_offset: int, cfg: SmootherConfig) -> torch.Tensor | None:
    """RANSAC samples of every motion of the group, keyed on its global
    motion index: (k, W-1, n_ransac, 3), or None without RANSAC."""
    if not cfg.pipe.vo.ransac:
        return None
    with profiling.span("unified.sample"):
        return torch.stack([
            torch.stack([sampler(index_offset + int(s) + j, qvalid[i, j])
                         for j in range(cfg.window - 1)])
            for i, s in enumerate(start_group)])


def _group_vo(quv: torch.Tensor, qvalid: torch.Tensor, samples: torch.Tensor | None,
              cfg: SmootherConfig):
    """Per-motion stereo VO of the group: (VO result, window-local step
    motions (k, W-1, 4, 4) with every failed motion the identity)."""
    with profiling.span("unified.vo"):
        vo = stereo_vo_solve(quv, qvalid, None, cfg.pipe.vo, samples=samples)
        eye4 = torch.eye(4, dtype=vo.motion.dtype, device=vo.motion.device)
        return vo, torch.where(vo.success[..., None, None], vo.motion, eye4)


def _group_ba(motions_local: torch.Tensor, obs: torch.Tensor, mask: torch.Tensor,
              cfg: SmootherConfig):
    """Windowed BA of the group from its VO motions: (problems, result)."""
    with profiling.span("unified.ba"):
        problems = _init_window_problem_local(motions_local, obs, mask, cfg)
        return problems, ba_solve(problems, _ba_config(cfg))


def _group_covariances(problems: BAProblem, res, cfg: SmootherConfig):
    """(camera covariances (k, W, 6, 6), refined-motion covariances and
    refined motions (k, W-1, ...)) at the BA solution."""
    with profiling.span("unified.cov"):
        cam_cov = ba_camera_covariances(problems._replace(cam=res.cam, pts=res.pts),
                                        _ba_config(cfg))
        Ts = T_from_cam6(res.cam)
        refined = torch.matmul(Ts[:, 1:], _inv_se3(Ts[:, :-1]))
        return cam_cov, _motion_covs_from_cam_covs(res.cam, cam_cov), refined


def unified_solve_group(lf: torch.Tensor, rf: torch.Tensor, start_group: np.ndarray,
                        sampler: Sampler, index_offset: int, cfg: SmootherConfig
                        ) -> torch.Tensor:
    """Solve one group of windows end to end: track tables -> per-motion VO
    -> batched BA -> covariances and refined motions (each stage one of the
    functions above, which ``tools/unified_stage_split.py`` times).

    ``start_group`` (k,) window starts into ``lf``/``rf`` (n, H, W) float32;
    ``index_offset`` is the global index of frame 0. Returns the group's
    outputs packed as (k, F) float32 rows on the device (``_unpack``)."""
    with profiling.span("unified.group"):
        obs, mask = _build_window_tracks(lf, rf, start_group, cfg)
        quv, qvalid = _quad_matches(obs, mask)
        samples = _group_samples(qvalid, start_group, sampler, index_offset, cfg)
        vo, motions_local = _group_vo(quv, qvalid, samples, cfg)
        problems, res = _group_ba(motions_local, obs, mask, cfg)
        cam_cov, ba_motion_cov, refined = _group_covariances(problems, res, cfg)
        k = obs.shape[0]
        fields = (motions_local, vo.success, torch.sum(qvalid, dim=-1), vo.n_inliers,
                  vo.mean_reproj_error, refined, res.cost, res.converged,
                  torch.sum(problems.mask, dim=(1, 2)), torch.sum(problems.mask, dim=2),
                  vo.cov, cam_cov, ba_motion_cov)
        return torch.cat([f.reshape(k, -1).to(torch.float32) for f in fields], dim=1)


def _check_stride(cfg: SmootherConfig) -> None:
    if cfg.ba_rate > cfg.window - 1:
        raise ValueError(
            "unified engine needs ba_rate <= window-1 for full motion coverage "
            f"(got ba_rate={cfg.ba_rate}, window={cfg.window}); larger strides "
            "would leave uncovered motions as identity")


def _scan_packed(ls: torch.Tensor, rs: torch.Tensor, sampler: Sampler, cfg: SmootherConfig,
                 wchunk: int, index_offset: int) -> torch.Tensor:
    """All windows of a staged sequence, ``wchunk`` at a time: (K, F)
    float32 packed rows on the device."""
    _check_stride(cfg)
    n = int(ls.shape[0])
    starts = unified_window_starts(n, cfg.window, cfg.ba_rate)
    if len(starts) == 0:
        width = sum(int(np.prod(shape)) for _, shape in _layout(cfg.window))
        return torch.zeros((0, width), dtype=torch.float32, device=ls.device)
    lf = ls.to(torch.float32)
    rf = rs.to(torch.float32)
    return torch.cat([unified_solve_group(lf, rf, starts[g:g + wchunk], sampler,
                                          index_offset, cfg)
                      for g in range(0, len(starts), wchunk)])


def unified_system_scan(ls: torch.Tensor, rs: torch.Tensor, sampler: Sampler,
                        cfg: SmootherConfig, wchunk: int = 4, index_offset: int = 0
                        ) -> UnifiedOutput:
    """Integrated system on one track table per window: detect ->
    track/match -> per-motion VO -> windowed BA, for the staged frames
    ``ls``, ``rs`` (n, H, W) (uint8 or float32) on one device, ``wchunk``
    windows per group.

    ``index_offset`` is the global index of frame ``ls[0]``: the samples of
    motion i come from ``sampler(index_offset + i, valid)``, so a sequence
    processed in streaming super-chunks solves the same per-motion problems
    as the same sequence staged whole. The outputs reach the host in one
    transfer."""
    packed = _scan_packed(ls, rs, sampler, cfg, wchunk, index_offset).cpu().numpy()
    profiling.count("sync.unified_readback")
    return _unpack(packed, cfg.window)


def _compose_from_chunks(chunks: list[tuple[UnifiedOutput, np.ndarray, int]], n_frames: int,
                         cfg: SmootherConfig) -> FullSystemResult:
    """Host-side float64 composition of the unified engine's outputs.

    ``chunks``: (output, global window starts (K,), frames valid through)
    triples, one for the staged scan and several for the streaming engine.
    The install policy is the JAX engine's: each motion takes the VO motion
    of its covering window with the best (success, inliers), and the
    refined motion of the covering window with the most gated support at
    both endpoint frames (at least ``min_frame_obs``) whose refinement stays
    within ``install_disc_px`` of that window's own VO motion; else the VO
    motion stands."""
    from ..parallel.stitching import chain_covariances_np  # the parallel layer imports this module

    with profiling.span("unified.compose"):
        b = n_frames - 1
        W = cfg.window
        motions = np.tile(np.eye(4), (b, 1, 1))
        packed = np.zeros((b, 20), np.float32)
        # installed-motion covariances start at the failed-solve prior
        motion_cov = np.tile(np.eye(6) * 1e2, (b, 1, 1))
        best_vo = [(-1, -1)] * b  # (success, inliers) of the installed VO motion
        ba_cands: dict[int, list] = {}
        ba_cost, ba_conv, n_track = [], [], []

        for out, g_starts, n_valid in chunks:
            vo_m = np.asarray(out.vo_motions, np.float64)
            refined = np.asarray(out.refined_motions, np.float64)
            nfo = np.asarray(out.n_frame_obs)
            succ = np.asarray(out.vo_success)
            n_matches = np.asarray(out.vo_n_matches)
            n_inliers = np.asarray(out.vo_n_inliers)
            vo_err = np.asarray(out.vo_err)
            vo_cov = np.asarray(out.vo_cov, np.float64)
            ba_mcov = np.asarray(out.ba_motion_cov, np.float64)
            for i, s in enumerate(g_starts):
                for j in range(W - 1):
                    m = s + j
                    if m >= b or s + j + 1 >= n_valid:
                        continue  # padding / beyond the real sequence
                    key = (int(succ[i, j]), int(n_inliers[i, j]))
                    if key > best_vo[m]:
                        best_vo[m] = key
                        motions[m] = vo_m[i, j]
                        motion_cov[m] = vo_cov[i, j]
                        packed[m, :16] = vo_m[i, j].reshape(16)
                        packed[m, 16] = float(succ[i, j])
                        packed[m, 17] = float(n_matches[i, j])
                        packed[m, 18] = float(n_inliers[i, j])
                        packed[m, 19] = float(vo_err[i, j])
                    support = int(min(nfo[i, j], nfo[i, j + 1]))
                    if support >= cfg.min_frame_obs:
                        ba_cands.setdefault(m, []).append(
                            (support, refined[i, j], vo_m[i, j], ba_mcov[i, j]))
            ba_cost.append(np.asarray(out.ba_cost))
            ba_conv.append(np.asarray(out.ba_converged))
            n_track.append(np.asarray(out.n_track_obs))

        fu = float(cfg.pipe.vo.intr1.fu)

        def discrepancy_px(a, b_):
            dt = np.linalg.norm(a[:3, 3] - b_[:3, 3])
            Rr = a[:3, :3].T @ b_[:3, :3]
            ang = np.arccos(np.clip((np.trace(Rr) - 1.0) / 2.0, -1.0, 1.0))
            return fu * (dt / cfg.install_disc_depth_m + ang)

        motions_ba = motions.copy()
        motion_cov_ba = motion_cov.copy()
        for m, cands in ba_cands.items():
            for _, ref, win_vo, mcov in sorted(cands, key=lambda c: -c[0]):
                if discrepancy_px(ref, win_vo) <= cfg.install_disc_px:
                    motions_ba[m] = ref
                    motion_cov_ba[m] = mcov
                    break

        def chain(ms):
            traj = np.empty((n_frames, 4, 4))
            traj[0] = np.eye(4)
            for i in range(b):
                traj[i + 1] = traj[i] @ np.linalg.inv(ms[i])
            return traj

        return FullSystemResult(
            traj_vo=chain(motions), traj_ba=chain(motions_ba), per_frame=packed,
            ba_cost=np.concatenate(ba_cost), ba_converged=np.concatenate(ba_conv),
            n_track_obs=np.concatenate(n_track), motion_cov=motion_cov_ba,
            pose_cov=chain_covariances_np(motions_ba, motion_cov_ba))


def compose_unified(out: UnifiedOutput, n_frames: int, cfg: SmootherConfig
                    ) -> FullSystemResult:
    """Host-side composition of one staged ``unified_system_scan`` output."""
    starts = unified_window_starts(n_frames, cfg.window, cfg.ba_rate)
    return _compose_from_chunks([(out, starts, n_frames)], n_frames, cfg)


def run_unified_system(frames: list[tuple[np.ndarray, np.ndarray]], cfg: SmootherConfig,
                       seed: int = 0, wchunk: int = 4,
                       device: str | torch.device | None = None,
                       sampler: Sampler | None = None) -> FullSystemResult:
    """The unified engine on a whole sequence, staged on ``device`` (default:
    the CUDA card) as uint8."""
    dev = setup_device(device)
    sampler = sampler or make_sampler(seed, cfg.pipe.vo.n_ransac)
    ls = torch.from_numpy(np.stack([_u8(f[0]) for f in frames])).to(dev)
    rs = torch.from_numpy(np.stack([_u8(f[1]) for f in frames])).to(dev)
    out = unified_system_scan(ls, rs, sampler, cfg, wchunk=wchunk)
    return compose_unified(out, len(frames), cfg)


def run_unified_streaming(frames: Iterable, cfg: SmootherConfig, seed: int = 0,
                          wchunk: int = 4, groups: int = 2, prefetch: int = 2,
                          stats: dict | None = None, start_frame: int = 0,
                          device: str | torch.device | None = None,
                          sampler: Sampler | None = None) -> FullSystemResult:
    """Streaming integrated system: VO + windowed BA over an unbounded frame
    iterable with bounded device memory and uploads that overlap compute.

    Frames go up in fixed-shape super-chunks of ``groups * wchunk`` windows
    (``pipeline.stream_stacks``: a background thread, pinned host stacks, a
    copy stream); consecutive super-chunks overlap by ``window - ba_rate``
    frames, so window state never crosses a boundary. The tail super-chunk
    is padded by repeating the final frame (identity motions into the
    padding, never installed). Samples are keyed on global motion indices,
    so the result is motion for motion the staged ``unified_system_scan``'s.

    Resume: ``start_frame`` (a multiple of the super-chunk advance
    ``groups * wchunk * ba_rate``) processes exactly the super-chunks the
    unbroken run would from that frame on; the result is relative to
    ``start_frame`` (its traj[0] is the identity); chain it onto the earlier
    part with ``merge_unified_results``. ``stats`` gets the in-run
    ``upload_s`` and ``upload_bytes`` per super-chunk."""
    _check_stride(cfg)
    W, stride = cfg.window, cfg.ba_rate
    dev = setup_device(device)
    sampler = sampler or make_sampler(seed, cfg.pipe.vo.n_ransac)
    n_win = groups * wchunk
    span = (n_win - 1) * stride + W  # frames per super-chunk
    advance = n_win * stride  # frames consumed per super-chunk
    overlap = span - advance  # frames carried to the next super-chunk
    if start_frame % advance != 0:
        raise ValueError(f"start_frame must be a super-chunk boundary (multiple of "
                         f"{advance}), got {start_frame}")

    def stacks():
        """(frames, meta=(global offset, real frames)) per super-chunk."""
        buf: list = []
        offset = start_frame  # global index of buf[0]
        for f in frames:
            buf.append((_u8(f[0]), _u8(f[1])))
            if len(buf) == span:
                yield buf, (offset, span)
                buf = buf[advance:]
                offset += advance
        if len(buf) > overlap or (offset == start_frame and len(buf) > 1):
            yield buf + [buf[-1]] * (span - len(buf)), (offset, len(buf))

    results = []
    for ls, rs, (offset, n_real) in stream_stacks(stacks(), dev, prefetch, stats):
        results.append((_scan_packed(ls, rs, sampler, cfg, wchunk, offset), offset, n_real))
        del ls, rs  # before the next super-chunk is taken (stream_stacks' bound)
    if not results:
        return FullSystemResult(
            traj_vo=np.eye(4)[None], traj_ba=np.eye(4)[None],
            per_frame=np.zeros((0, 20), np.float32), ba_cost=np.zeros(0),
            ba_converged=np.zeros(0, bool), n_track_obs=np.zeros(0, np.int32),
            motion_cov=np.zeros((0, 6, 6)), pose_cov=np.zeros((1, 6, 6)))
    # compose relative to start_frame (the samples stayed global)
    n_frames = results[-1][1] + results[-1][2] - start_frame
    local_starts = unified_window_starts(span, W, stride)
    chunks = [(_unpack(packed.cpu().numpy(), W), offset - start_frame + local_starts,
               offset - start_frame + n_real) for packed, offset, n_real in results]
    return _compose_from_chunks(chunks, n_frames, cfg)


def merge_unified_results(a: FullSystemResult, b: FullSystemResult, at: int | None = None
                          ) -> FullSystemResult:
    """Chain a resumed streaming result ``b`` (from
    ``run_unified_streaming(start_frame=at)``, relative to frame ``at``)
    onto the partial result ``a`` it resumes. ``at`` defaults to the last
    frame of ``a``."""
    if at is None:
        at = a.traj_vo.shape[0] - 1

    def chain(ta, tb):
        return np.concatenate([ta[: at + 1], ta[at] @ tb[1:]])

    # transport b's pose covariances (zero at its frame 0) past a's boundary
    # covariance: C = Ad(Tb^-1) C_at Ad^T + C_b
    C_at = a.pose_cov[at]
    cov_tail = np.empty((b.pose_cov.shape[0] - 1, 6, 6))
    for k in range(1, b.pose_cov.shape[0]):
        Ad = geo.se3_adjoint_np(np.linalg.inv(b.traj_ba[k]))
        cov_tail[k - 1] = Ad @ C_at @ Ad.T + b.pose_cov[k]

    return FullSystemResult(
        traj_vo=chain(a.traj_vo, b.traj_vo), traj_ba=chain(a.traj_ba, b.traj_ba),
        per_frame=np.concatenate([a.per_frame[:at], b.per_frame]),
        ba_cost=np.concatenate([a.ba_cost, b.ba_cost]),
        ba_converged=np.concatenate([a.ba_converged, b.ba_converged]),
        n_track_obs=np.concatenate([a.n_track_obs, b.n_track_obs]),
        motion_cov=np.concatenate([a.motion_cov[:at], b.motion_cov]),
        pose_cov=np.concatenate([a.pose_cov[: at + 1], cov_tail]))
