"""Cross-modal metric-scale session: mono VO + MI scale from the baseline.

Port of ``uasl_motion_estimation_tpu/models/cross_modal.py``: the pipeline
the reference's only link-instantiated ``Optimiser<ScaleState, ...>``
(optimisation.cpp:749) exists for. The two cameras of the rig see different
modalities, so intensity stereo fails; per step the session

1. runs monocular VO on the left camera (detect -> KLT -> essential-matrix
   RANSAC, models/mono_vo.py): motion and structure up to scale;
2. seeds the metric scale from the MI cross-modal matcher: the structure's
   MI disparities give metric depths fu*B/d, and the median metric/mono
   depth ratio is the initial scale;
3. refines it by maximizing per-feature patch MI across the baseline
   (models/scale.py).

Every step of a batch runs in lock-step (the JAX ``vmap``); MI scoring goes
through the joint-histogram kernel K2 and patch tiles through K1. RANSAC
samples come from a sampler called as ``sampler(step, valid)`` with the
global step index, so the per-frame and staged engines solve each step with
the same samples: width-8 draws for ``pencil8``, width 5 for ``5point``, and
for ``hybrid`` also the escalation's 5-point draws from ``sampler5``
(``mono_pipeline.make_mono_samplers`` builds both).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from ..solvers.lm import StopCondition
from . import frontend as fe
from .mono_pipeline import draw_samples, make_mono_samplers
from .mono_vo import MonoVOParams, mono_vo_solve
from .pipeline import Sampler
from .scale import ScaleConfig, estimate_scale


class CrossModalConfig(NamedTuple):
    """Same fields and defaults as the JAX CrossModalConfig."""

    vo: MonoVOParams  # left-camera mono VO
    scale: ScaleConfig  # MI scale optimiser (shares intr/baseline)
    matcher: fe.MatcherConfig = fe.MatcherConfig()  # MI matcher (s0 init)
    klt: fe.KLTConfig = fe.KLTConfig()
    max_features: int = 500  # TrackingInfo.nb_feats default (file_IO.h:69)
    detect_quality: float = 1e-4
    min_depth: float = 1.0  # structure gate for scale estimation (mono units)
    max_depth: float = 60.0
    s0_min: float = 0.05  # s0 sanity range: outside it the previous scale is used
    s0_max: float = 20.0


class CrossModalStep(NamedTuple):
    R: torch.Tensor  # (..., 3, 3) rotation prev->cur
    t: torch.Tensor  # (..., 3) unit-norm translation
    scale: torch.Tensor  # (...) refined metric scale (meters per mono unit)
    s0: torch.Tensor  # (...) MI-matcher initial scale
    s0_valid: torch.Tensor  # (...) bool: the matcher seeded it or the LM refined it
    n_init: torch.Tensor  # (...) MI matches feeding s0
    n_scale_pts: torch.Tensor  # (...) structure points feeding the MI optimiser
    n_inliers: torch.Tensor  # (...) mono RANSAC inliers
    vo_success: torch.Tensor  # (...) bool
    lm_stop: torch.Tensor  # (...) StopCondition of the scale LM
    mi_final: torch.Tensor  # (...) mean per-feature MI at the solution


class CrossModalResult(NamedTuple):
    trajectory: np.ndarray  # (N, 4, 4) cam-to-world METRIC poses
    scales: np.ndarray  # (N-1,) per-step metric scale
    s0: np.ndarray  # (N-1,) MI-matcher inits
    records: list  # per-frame diagnostic dicts


def _session_step(
    prev_left: torch.Tensor,
    cur_left: torch.Tensor,
    cur_right: torch.Tensor,
    steps: list[int],
    samplers: tuple[Sampler, Sampler | None],
    cfg: CrossModalConfig,
    s_prev: torch.Tensor | float = 1.0,
    pyr_prev: list[torch.Tensor] | None = None,
    pyr_cur: list[torch.Tensor] | None = None,
) -> CrossModalStep:
    """Session step for a batch of steps (global indices ``steps``) on f32
    images (B, H, W): detect -> KLT -> mono VO -> MI-matcher scale init ->
    MI-LM scale refinement. ``samplers``: (sampler, sampler5), the second
    used by ``hybrid`` only."""
    p = cfg
    intr = p.vo.intr

    feats, _, v0 = im.detect_features_grid(prev_left, max_features=p.max_features,
                                           quality_level=p.detect_quality)
    tracked = fe.klt_track(prev_left, cur_left, feats, v0, p.klt,
                           pyr_prev=pyr_prev, pyr_next=pyr_cur)
    matches = torch.stack([feats, tracked.pts], dim=-2)
    samples, samples5 = draw_samples(steps, tracked.valid, samplers, p)
    res = mono_vo_solve(matches, tracked.valid, samples, p.vo, samples5)

    # structure in the CURRENT frame, mono gauge ||t|| = 1
    X_cur = torch.matmul(res.pts3d, res.R.transpose(-1, -2)) + res.t[..., None, :]
    z = X_cur[..., 2]
    ok = (res.inlier_mask & (z > p.min_depth) & (z < p.max_depth)
          & torch.isfinite(X_cur).all(dim=-1))
    uv = geo.project(X_cur, intr)

    # scale init from the MI cross-modal matcher: disparity -> metric depth
    fr, _, mv = fe.match_stereo(cur_left, cur_right, uv, ok, p.matcher, use_mi=True)
    disp = uv[..., 0] - fr[..., 0]
    z_metric = intr.fu * p.scale.baseline / torch.clamp(disp, min=1e-6)
    ratio = z_metric / torch.clamp(z, min=1e-6)
    ratio_ok = mv & (disp > p.matcher.min_disparity) & torch.isfinite(ratio)
    n_init = torch.sum(ratio_ok, dim=-1)
    # nanquantile at 0.5 averages the two middle values, as jnp.nanmedian
    s0_med = torch.nanquantile(torch.where(ratio_ok, ratio, torch.full_like(ratio, torch.nan)),
                               0.5, dim=-1)
    s0_valid = (n_init >= 8) & torch.isfinite(s0_med) & (s0_med > p.s0_min) & (s0_med < p.s0_max)
    s_prev = torch.as_tensor(s_prev, dtype=torch.float32, device=s0_med.device).expand_as(s0_med)
    s0 = torch.where(s0_valid, s0_med, s_prev)

    s_ref, lmres = estimate_scale(cur_left, cur_right, X_cur, ok, s0, p.scale)
    good = torch.isfinite(s_ref) & (s_ref > p.s0_min) & (s_ref < p.s0_max)
    scale = torch.where(good, s_ref, s0)
    return CrossModalStep(
        R=res.R, t=res.t, scale=scale, s0=s0, s0_valid=s0_valid | good, n_init=n_init,
        n_scale_pts=torch.sum(ok, dim=-1), n_inliers=res.n_inliers,
        vo_success=res.success, lm_stop=lmres.stop, mi_final=lmres.cost)


def cross_modal_step(prev_left, cur_left, cur_right, step: int, sampler: Sampler,
                     cfg: CrossModalConfig, s_prev: torch.Tensor | float = 1.0,
                     sampler5: Sampler | None = None) -> CrossModalStep:
    """One frame of the session on (H, W) images (uint8 or f32; compute is
    f32). ``s_prev``: the previous frame's scale, used when the MI matcher
    cannot seed this frame. ``sampler5``: the hybrid escalation's sampler."""
    imgs = [x.to(torch.float32)[None] for x in (prev_left, cur_left, cur_right)]
    s_prev = torch.as_tensor(s_prev, dtype=torch.float32, device=imgs[0].device).reshape(1)
    out = _session_step(*imgs, [step], (sampler, sampler5), cfg, s_prev)
    return CrossModalStep(*(x[0] for x in out))


def cross_modal_sequence_scan(ls: torch.Tensor, rs: torch.Tensor, step0: int,
                              sampler: Sampler, cfg: CrossModalConfig,
                              chunk: int = 4, sampler5: Sampler | None = None
                              ) -> CrossModalStep:
    """All n-1 steps of a staged session (n, H, W), ``chunk`` steps at a
    time. Per group, the f32 conversion and the left KLT pyramids of its
    chunk+1 frames are built once and shared by the two steps that use each
    frame; the last group may be shorter.

    In-batch steps cannot warm-start from the previous frame's scale, so
    s_prev is fixed at 1.0; the host replaces the steps whose matcher init
    AND refinement both failed (s0_valid False) with the previous scale."""
    n = int(ls.shape[0])
    outs = []
    for base in range(0, n - 1, chunk):
        m = min(chunk, n - 1 - base)
        lf = ls[base:base + m + 1].to(torch.float32)
        rf = rs[base + 1:base + m + 1].to(torch.float32)
        pyr = im.build_pyramid(lf, cfg.klt.n_levels)
        outs.append(_session_step(
            lf[:-1], lf[1:], rf, list(range(step0 + base, step0 + base + m)),
            (sampler, sampler5), cfg,
            1.0, pyr_prev=[x[:-1] for x in pyr], pyr_cur=[x[1:] for x in pyr]))
    return CrossModalStep(*(torch.cat(xs) for xs in zip(*outs)))


_PACKED = ("R", "t", "scale", "s0", "s0_valid", "n_init", "n_scale_pts", "n_inliers",
           "vo_success", "lm_stop", "mi_final")


def _pack(out: CrossModalStep) -> np.ndarray:
    """Per-step outputs as one (B, 21) float64 host array, read in one
    device-to-host transfer: [R 9, t 3, then one column per other field]."""
    b = out.R.shape[0]
    cols = [out.R.reshape(b, 9), out.t.reshape(b, 3)]
    cols += [getattr(out, f)[:, None].to(torch.float32) for f in _PACKED[2:]]
    return torch.cat(cols, dim=1).cpu().numpy().astype(np.float64)


def _unpack(row: np.ndarray) -> dict:
    rec = {"R": row[:9].reshape(3, 3), "t": row[9:12]}
    rec.update({f: row[12 + i] for i, f in enumerate(_PACKED[2:])})
    return rec


def _record(frame: int, o: dict, scale: float) -> dict:
    return {
        "frame": frame,
        "success": bool(o["vo_success"] > 0.5),
        "n_inliers": int(o["n_inliers"]),
        "n_init": int(o["n_init"]),
        "n_scale_pts": int(o["n_scale_pts"]),
        "scale": scale,
        "s0": float(np.float32(o["s0"])),
        "lm_stop": StopCondition(int(o["lm_stop"])).name,
    }


def _chain(pose: np.ndarray, o: dict, scale: float) -> np.ndarray:
    """pose_cur = pose_prev @ motion^-1 with the metric motion [R | scale t]."""
    motion = np.eye(4)
    motion[:3, :3] = o["R"]
    motion[:3, 3] = scale * o["t"]
    return pose @ np.linalg.inv(motion)


def _stage(frames, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lefts, rights) as uint8 (n, H, W) tensors on ``dev``."""
    pairs = [(np.asarray(a), np.asarray(b)) for a, b in frames]
    ls = np.clip(np.stack([a for a, _ in pairs]), 0, 255).astype(np.uint8)
    rs = np.clip(np.stack([b for _, b in pairs]), 0, 255).astype(np.uint8)
    return torch.from_numpy(ls).to(dev), torch.from_numpy(rs).to(dev)


def run_cross_modal_staged(
    frames: Iterable[tuple[np.ndarray, np.ndarray]] | tuple[torch.Tensor, torch.Tensor],
    cfg: CrossModalConfig,
    seed: int = 0,
    chunk: int = 4,
    device: str | torch.device | None = None,
    sampler: Sampler | None = None,
) -> CrossModalResult:
    """Staged cross-modal engine: frames go to the device once as uint8, all
    steps run in chunks, the per-step outputs come back in one transfer, and
    the metric pose chain is composed on the host in float64 with the
    degraded-frame contract (a failed step keeps the last pose; a failed
    scale inherits the previous one).

    ``frames``: (left, right) pairs, or an already staged (lefts, rights)
    pair of uint8 (n, H, W) tensors on the device. ``sampler`` replaces the
    solver's sampler of ``make_mono_samplers(seed, cfg.vo)``; the hybrid
    escalation always draws from that function's second sampler.
    """
    dev = setup_device(device)
    if isinstance(frames, tuple) and len(frames) == 2 and torch.is_tensor(frames[0]):
        ls, rs = frames
    else:
        ls, rs = _stage(frames, dev)
    own, own5 = make_mono_samplers(seed, cfg.vo)
    packed = _pack(cross_modal_sequence_scan(ls, rs, 0, sampler or own, cfg, chunk, own5))

    pose = np.eye(4)
    traj = [pose.copy()]
    scales, s0s, records = [], [], []
    s_prev = 1.0
    for i in range(packed.shape[0]):
        o = _unpack(packed[i])
        scale = float(np.float32(o["scale"]))
        if o["s0_valid"] < 0.5:  # matcher AND refinement both failed
            scale = s_prev
        if o["vo_success"] > 0.5:
            pose = _chain(pose, o, scale)
            s_prev = scale
        traj.append(pose.copy())
        scales.append(scale)
        s0s.append(float(np.float32(o["s0"])))
        records.append(_record(i + 1, o, scale))
    return CrossModalResult(trajectory=np.asarray(traj), scales=np.asarray(scales),
                            s0=np.asarray(s0s), records=records)


def run_cross_modal(
    frames: Iterable[tuple[np.ndarray, np.ndarray]],
    cfg: CrossModalConfig,
    seed: int = 0,
    device: str | torch.device | None = None,
    sampler: Sampler | None = None,
) -> CrossModalResult:
    """Per-frame session loop: metric trajectory over (left, right) pairs,
    each step warm-started from the previous frame's scale. Failed frames
    keep the last pose; failed scales inherit the previous scale. Samples
    come from ``make_mono_samplers(seed, cfg.vo)``; ``sampler`` replaces the
    solver's."""
    dev = setup_device(device)
    own, own5 = make_mono_samplers(seed, cfg.vo)
    sampler = sampler or own
    pose = np.eye(4)
    traj = [pose.copy()]
    scales, s0s, records = [], [], []
    prev_left = None
    s_prev = 1.0
    for i, (left, right) in enumerate(frames):
        left = torch.as_tensor(np.asarray(left, np.float32)).to(dev)
        right = torch.as_tensor(np.asarray(right, np.float32)).to(dev)
        if prev_left is not None:
            out = cross_modal_step(prev_left, left, right, i - 1, sampler, cfg, s_prev, own5)
            o = _unpack(_pack(CrossModalStep(*(x[None] for x in out)))[0])
            scale = float(np.float32(o["scale"]))
            if o["vo_success"] > 0.5:
                pose = _chain(pose, o, scale)
                s_prev = scale
            traj.append(pose.copy())
            scales.append(scale)
            s0s.append(float(np.float32(o["s0"])))
            records.append(_record(i, o, scale))
        prev_left = left
    return CrossModalResult(trajectory=np.asarray(traj), scales=np.asarray(scales),
                            s0=np.asarray(s0s), records=records)
