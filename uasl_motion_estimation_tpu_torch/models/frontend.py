"""Feature front-end: grid GFTT detection, ZNCC and MI stereo matching,
pyramidal KLT.

Port of ``uasl_motion_estimation_tpu/models/frontend.py``. Every stage is
batched over leading dims (the sequence scan's chunk steps) and fixed-shape:
``max_features`` slots with validity masks. The ZNCC and KLT patch work goes
through integer tile gathers (kernel K1) followed by separable bilinear
resampling inside the tiles; the MI matcher samples one bilinear strip per
feature and scores its disparity windows with the joint-histogram kernel
K2 (strip mode).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import image as im
from ..ops import similarity as sim
from ..ops import stereo as st
from ..ops.kernels import mi as kmi
from ..utils import profiling


class MatcherConfig(NamedTuple):
    """Same fields and defaults as the JAX MatcherConfig. ``use_pallas``
    keeps its JAX meaning for the MI matcher's scoring (see
    ``ops/similarity.py::mutual_information_batched``)."""

    patch_radius: int = 5
    max_disparity: int = 128
    min_disparity: float = 0.5
    min_score: float = 0.6  # ZNCC acceptance threshold
    mi_bins: int = 20
    mi_min_score: float = 0.4
    refine_iters: int = 2  # 1-D photometric subpixel refinement steps
    use_pallas: bool | None = None
    prior_width: int = 24  # search width around a disparity prior


class KLTConfig(NamedTuple):
    """Same fields and defaults as the JAX KLTConfig."""

    n_levels: int = 4
    window_radius: int = 5
    iters: int = 10
    iters_coarse: int = 4
    min_eig_threshold: float = 1e-4
    max_residual: float = 12.0  # mean abs intensity error acceptance
    max_displacement: float = 75.0
    tile_margin: int = 5  # px of local search room per level (tile gather)
    converge_px: float = 0.03  # early exit when every live update is below


def _photometric_residual(patch: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Mean |patch - template| after removing the DC offset (gain/bias
    robust acceptance gate)."""
    err = patch - template
    err = err - torch.mean(err, dim=(-2, -1), keepdim=True)
    return torch.mean(torch.abs(err), dim=(-2, -1))


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _scharr_x(p: torch.Tensor) -> torch.Tensor:
    """Scharr-x gradient of the interior columns of (..., R, C) patches
    whose rows are already the ones wanted."""
    return (p[..., :, 2:] - p[..., :, :-2]) * 0.5


def _mi_disparity_scores(img_left: torch.Tensor, img_right: torch.Tensor,
                         feats_left: torch.Tensor, cfg: MatcherConfig) -> torch.Tensor:
    """(..., N, D) MI of each left patch against the right patches at
    disparities 0..D-1 on its row; -inf where a candidate patch leaves the
    image. The D candidates are the windows of one (k, D + 2r) right strip
    per feature, sampled once (``im.extract_strips``; the same ids as D
    separate patches at every in-image candidate) and scored by K2's strip
    mode, so no (..., N, D, k, k) patch or id tensor is made."""
    h, w = img_left.shape[-2:]
    r = cfg.patch_radius
    k = 2 * r + 1
    n_disp = cfg.max_disparity
    bins = cfg.mi_bins
    lead = feats_left.shape[:-1]
    d_range = torch.arange(n_disp, dtype=img_left.dtype, device=img_left.device)
    cand = torch.stack([
        feats_left[..., :, None, 0] - d_range,
        feats_left[..., :, None, 1].expand(*lead, n_disp),
    ], dim=-1)  # (..., N, D, 2)
    patches_l = im.extract_patches(img_left, feats_left, r)  # (..., N, k, k)
    strips = im.extract_strips(img_right, feats_left, r, n_disp)  # (..., N, k, D + 2r)
    strips = strips.reshape(-1, k, n_disp + 2 * r)
    if cfg.use_pallas is False:  # the one-hot path, CPU tensors only
        windows = kmi.strip_windows(strips, k).reshape(*lead, n_disp, k, k)
        scores = sim.mutual_information_batched(patches_l[..., None, :, :], windows,
                                                bins=bins, use_pallas=False)
    else:
        qa = sim.quantise(patches_l, bins).to(torch.uint8).reshape(-1, k * k)
        qs = sim.quantise(strips, bins).to(torch.uint8)
        scores = kmi.mi_strip(qa, qs, bins).reshape(*lead, n_disp)
    cand_ok = im.patch_in_bounds(cand, r + 1, h, w)
    return torch.where(cand_ok, scores, torch.full_like(scores, -torch.inf))


def match_stereo(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    feats_left: torch.Tensor,
    valid_left: torch.Tensor,
    cfg: MatcherConfig = MatcherConfig(),
    use_mi: bool = False,
    d_prior: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Epipolar stereo matching on rectified pairs, with parabola sub-pixel
    refinement of the best disparity.

    ZNCC (default): the strip cost volume, then a 1-D photometric
    Lucas-Kanade polish along the epipolar line. ``d_prior`` (..., N), if
    given, narrows the search to ``prior_width`` candidates around each
    feature's prior.

    ``use_mi=True`` scores with mutual information instead (the cross-modal
    matcher): the bilinear windows at every disparity in [0, max_disparity)
    of one strip per feature, scored by kernel K2; no prior and no
    photometric polish, since intensity consistency does not hold across
    modalities.

    Returns (feats_right (..., N, 2), scores (..., N), valid (..., N)).
    """
    h, w = img_left.shape[-2:]
    r = cfg.patch_radius
    dtype = img_left.dtype

    if use_mi:
        scores = _mi_disparity_scores(img_left, img_right, feats_left, cfg)
        min_score = cfg.mi_min_score
        d0 = None
    else:
        if d_prior is not None:
            width = cfg.prior_width
            d0 = torch.clamp(torch.round(d_prior).to(torch.int32) - width // 2, min=0)
        else:
            width = cfg.max_disparity
            d0 = None
        scores = st.zncc_disparity_scores(img_left, img_right, feats_left, width, r,
                                          d_offset=d0)
        min_score = cfg.min_score
    n_cand = scores.shape[-1]
    best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    best_score = _pick(scores, best)

    s0 = _pick(scores, torch.clamp(best - 1, 0, n_cand - 1))
    s2 = _pick(scores, torch.clamp(best + 1, 0, n_cand - 1))
    s0 = torch.where(torch.isfinite(s0), s0, best_score)
    s2 = torch.where(torch.isfinite(s2), s2, best_score)
    denom = s0 - 2 * best_score + s2
    sub = torch.where(torch.abs(denom) > 1e-9, 0.5 * (s0 - s2) / denom,
                      torch.zeros_like(denom))
    sub = torch.clamp(sub, -0.5, 0.5)

    disparity = best.to(dtype) + sub
    if d0 is not None:
        disparity = disparity + d0.to(dtype)
    feats_right = torch.stack([feats_left[..., 0] - disparity, feats_left[..., 1]], dim=-1)

    if cfg.refine_iters > 0 and not use_mi:
        # value and Scharr-x gradient from ONE widened tile per feature,
        # sized for every iteration (x moves at most 1 px per step)
        tpl = im.extract_patches_sep(img_left, feats_left, r)
        it = cfg.refine_iters
        kk = 2 * r + 3
        ax = torch.floor(feats_right[..., 0]).to(torch.int32) - (r + 1) - it
        ay = torch.floor(feats_right[..., 1]).to(torch.int32) - (r + 1)
        anchor = torch.stack([ax, ay], dim=-1)
        rt = im.extract_tiles(img_right, anchor, kk + 1, kk + 1 + 2 * it)
        a_f = anchor.to(dtype)
        fr = feats_right
        for _ in range(cfg.refine_iters):
            pbig = im.sample_tiles(rt, fr - a_f - (r + 1), kk, kk)
            p = pbig[..., 1:-1, 1:-1]
            sy = (3.0 * pbig[..., :-2, :] + 10.0 * pbig[..., 1:-1, :]
                  + 3.0 * pbig[..., 2:, :]) / 16.0
            g = _scharr_x(sy)
            err = p - tpl
            # zero-mean: the two cameras' exposures differ
            err = err - torch.mean(err, dim=(-2, -1), keepdim=True)
            den = torch.sum(g * g, dim=(-2, -1))
            step = -torch.sum(err * g, dim=(-2, -1)) / torch.clamp(den, min=1e-6)
            step = torch.clamp(step, -1.0, 1.0)
            fr = torch.stack([fr[..., 0] + step, fr[..., 1]], dim=-1)
        feats_right = fr
        disparity = feats_left[..., 0] - feats_right[..., 0]

    valid = (
        valid_left
        & torch.isfinite(best_score)
        & (best_score > min_score)
        & (disparity > cfg.min_disparity)
        & im.patch_in_bounds(feats_left, r + 1, h, w)
    )
    return feats_right, best_score, valid


class KLTResult(NamedTuple):
    pts: torch.Tensor  # (..., N, 2) tracked locations
    valid: torch.Tensor  # (..., N) bool
    residual: torch.Tensor  # (..., N) mean abs photometric error
    n_iter: torch.Tensor  # (..., n_levels) int32 iterations run per level, coarsest first


def klt_track(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts_prev: torch.Tensor,
    valid_prev: torch.Tensor,
    cfg: KLTConfig = KLTConfig(),
    init_next: torch.Tensor | None = None,
    pyr_prev: list[torch.Tensor] | None = None,
    pyr_next: list[torch.Tensor] | None = None,
) -> KLTResult:
    """Pyramidal Lucas-Kanade tracking, all features in lock-step.

    Per level, each feature gathers one tile of the next image around its
    guess and the iterations resample the window inside it. Each problem
    (leading batch element) runs its own convergence exit: it stops once its
    largest live update is at most ``converge_px`` or its iteration cap is
    reached, and its displacements freeze from then on, as the JAX
    ``while_loop`` does under ``vmap``. The loop leaves early once every
    problem has stopped; that test reads one flag from the device per
    iteration.
    """
    h, w = img_prev.shape[-2:]
    r = cfg.window_radius
    k = 2 * r + 1
    margin = cfg.tile_margin
    tile_size = k + 2 * margin + 1
    npix = k * k
    batch = pts_prev.shape[:-2]

    if pyr_prev is None:
        pyr_prev = im.build_pyramid(img_prev, cfg.n_levels)
    if pyr_next is None:
        pyr_next = im.build_pyramid(img_next, cfg.n_levels)

    guess = pts_prev if init_next is None else init_next
    d = (guess - pts_prev) / (2.0 ** (cfg.n_levels - 1))

    eig_ok = torch.ones_like(valid_prev)
    lvl0 = None
    n_iters = []
    trips = reads = 0

    for level in range(cfg.n_levels - 1, -1, -1):
        p_prev = pts_prev / 2.0 ** level
        ip, inx = pyr_prev[level], pyr_next[level]

        # template + Scharr gradients from ONE (k+2)-wide patch
        t_big = im.extract_patches_sep(ip, p_prev, r + 1)
        tpl = t_big[..., 1:-1, 1:-1]
        sy = (3.0 * t_big[..., :-2, :] + 10.0 * t_big[..., 1:-1, :]
              + 3.0 * t_big[..., 2:, :]) / 16.0
        gxp = _scharr_x(sy)
        sx = (3.0 * t_big[..., :, :-2] + 10.0 * t_big[..., :, 1:-1]
              + 3.0 * t_big[..., :, 2:]) / 16.0
        gyp = (sx[..., 2:, :] - sx[..., :-2, :]) * 0.5

        a11 = torch.sum(gxp * gxp, dim=(-2, -1))
        a12 = torch.sum(gxp * gyp, dim=(-2, -1))
        a22 = torch.sum(gyp * gyp, dim=(-2, -1))
        det = a11 * a22 - a12 * a12
        tr = a11 + a22
        min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
        eig_ok = eig_ok & (min_eig / npix > cfg.min_eig_threshold)
        inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det, torch.zeros_like(det))

        anchor = torch.floor(p_prev + d).to(torch.int32) - (r + margin)
        tiles = im.extract_tiles(inx, anchor, tile_size)
        anchor_f = anchor.to(d.dtype)
        track_ok = valid_prev & eig_ok
        if level == 0:
            lvl0 = (tpl, tiles, anchor_f)
        lo = anchor_f + r - p_prev  # displacement at tile offset 0
        hi = lo + (tile_size - k - 1)

        iters_level = cfg.iters if level == 0 else cfg.iters_coarse
        n_it = torch.zeros(batch, dtype=torch.int32, device=d.device)
        delta = torch.full(batch, torch.inf, dtype=d.dtype, device=d.device)
        for _ in range(iters_level):
            active = (n_it < iters_level) & (delta > cfg.converge_px)
            reads += 1
            if not bool(active.any()):
                break
            trips += 1
            patch = im.sample_tiles(tiles, p_prev + d - anchor_f - r, k)
            err = patch - tpl
            err = err - torch.mean(err, dim=(-2, -1), keepdim=True)
            b1 = torch.sum(err * gxp, dim=(-2, -1))
            b2 = torch.sum(err * gyp, dim=(-2, -1))
            dx = -(a22 * b1 - a12 * b2) * inv_det
            dy = -(a11 * b2 - a12 * b1) * inv_det
            upd = torch.stack([dx, dy], dim=-1)
            ok = torch.all(torch.isfinite(upd), dim=-1, keepdim=True)
            dnew = d + torch.where(ok, upd, torch.zeros_like(upd))
            dnew = torch.minimum(torch.maximum(dnew, lo), hi)
            live = torch.where(track_ok[..., None], torch.abs(dnew - d),
                               torch.zeros_like(d))
            d = torch.where(active[..., None, None], dnew, d)
            delta = torch.where(active, torch.amax(live, dim=(-2, -1)), delta)
            n_it = n_it + active.to(torch.int32)
        n_iters.append(n_it)
        if level > 0:
            d = d * 2.0

    pts_next = pts_prev + d

    if lvl0 is not None:
        # level 0's template is the bilinear patch at pts_prev and the final
        # displacement lies inside level 0's tile: no re-gather needed
        tpl0, tiles0, anchor0 = lvl0
        final_patch = im.sample_tiles(tiles0, pts_next - anchor0 - r, k)
    else:
        final_patch = im.extract_patches_sep(img_next, pts_next, r)
        tpl0 = im.extract_patches_sep(img_prev, pts_prev, r)
    residual = _photometric_residual(final_patch, tpl0)

    valid = (
        valid_prev
        & eig_ok
        & (residual < cfg.max_residual)
        & (torch.linalg.norm(d, dim=-1) < cfg.max_displacement)
        & im.patch_in_bounds(pts_next, r + 1, h, w)
        & im.patch_in_bounds(pts_prev, r + 1, h, w)
    )
    profiling.count("klt.calls")
    profiling.count("klt.trips", trips)
    profiling.count("sync.klt", reads)
    return KLTResult(pts=pts_next, valid=valid, residual=residual,
                     n_iter=torch.stack(n_iters, dim=-1))


class QuadMatches(NamedTuple):
    """Fixed-shape quad-match table (vector<StereoOdoMatchesf>,
    feature_types.h:105-115)."""

    uv: torch.Tensor  # (..., N, 4, 2): f1 prevL, f2 prevR, f3 curL, f4 curR
    valid: torch.Tensor  # (..., N)


def quad_match_frames(
    prev_left: torch.Tensor,
    prev_right: torch.Tensor,
    cur_left: torch.Tensor,
    cur_right: torch.Tensor,
    max_features: int = 500,
    matcher: MatcherConfig = MatcherConfig(),
    klt: KLTConfig = KLTConfig(),
    detect_kwargs: tuple = (),
    detector: str = "grid",
    pyr_prev_left: list[torch.Tensor] | None = None,
    pyr_cur_left: list[torch.Tensor] | None = None,
) -> QuadMatches:
    """Detect in prev-left, ZNCC-match the previous pair, KLT-track forward,
    and match the current pair with each feature's previous disparity as a
    search prior. ``detector``: ``"grid"`` (bucketed best-per-cell GFTT) or
    ``"topk"`` (global top-k GFTT with NMS, ``detect_features``).
    ``pyr_*_left``: optional prebuilt left KLT pyramids."""
    kw = dict(detect_kwargs)
    if detector == "grid":
        kw.pop("nms_radius", None)  # cell bucketing subsumes wide NMS
        feats_l, _, v0 = im.detect_features_grid(prev_left, max_features=max_features, **kw)
    elif detector == "topk":
        feats_l, _, v0 = im.detect_features(prev_left, max_features=max_features, **kw)
    else:
        raise ValueError(f"unknown detector {detector!r} (\"grid\" or \"topk\")")
    f2, _, v1 = match_stereo(prev_left, prev_right, feats_l, v0, matcher)
    tracked = klt_track(prev_left, cur_left, feats_l, v1, klt,
                        pyr_prev=pyr_prev_left, pyr_next=pyr_cur_left)
    f4, _, v3 = match_stereo(cur_left, cur_right, tracked.pts, tracked.valid,
                             matcher, d_prior=feats_l[..., 0] - f2[..., 0])
    uv = torch.stack([feats_l, f2, tracked.pts, f4], dim=-2)
    return QuadMatches(uv=uv, valid=v3)
