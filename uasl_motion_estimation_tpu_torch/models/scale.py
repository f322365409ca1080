"""MI-based metric-scale estimation from a stereo baseline (ScaleState).

Port of ``uasl_motion_estimation_tpu/models/scale.py``, the reference's
``Optimiser<ScaleState, ...>`` (optimisation.cpp:150-228, 436-537):

* residuals: per-feature mutual information between the left patch and the
  right patch reprojected with the candidate scale;
* jacobian: 1-pixel finite difference of MI along the epipolar line, chained
  with duds = fu*B/(s*Z), optionally Sobel-weighted;
* solver: the shared GN/LM engine as a maximization
  (``LMConfig(minimize=False)``, solvers/lm.py).

Batched over leading dims: each problem (one sequence step) has its own
scale, and the masked LM loop stops each on its own, as the vmapped JAX
``while_loop`` does. Every objective evaluation scores all features with the
joint-histogram kernel K2, twice (the value and its finite difference).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import const
from ..ops import geometry as geo
from ..ops import image as im
from ..ops import similarity as sim
from ..solvers.lm import LMConfig, LMResult, lm_solve


class ScaleConfig(NamedTuple):
    """Same fields and defaults as the JAX ScaleConfig."""

    intr: geo.Intrinsics
    baseline: float
    window_radius: int = 5  # ScaleState.window_size ROI half-size
    mi_bins: int = 20
    weighting: bool = False  # Sobel-gradient weights (optimisation.cpp:483)
    fd_step: float = 1.0  # dp = 1 px (optimisation.cpp:440)
    max_iter: int = 20  # OptimisationParams default (optimisation.h:31)
    use_lm: bool = True
    use_pallas: bool | None = None  # see ops/similarity.py
    # coarse-to-fine init: the mean-MI objective at this many log-spaced
    # candidates in [s0/coarse_range, s0*coarse_range], LM from the argmax
    # (0 = off, the reference's semantics)
    coarse_candidates: int = 0
    coarse_range: float = 3.0
    e1: float = 1e-4
    e2: float = 1e-6
    e3: float = 1e-6
    e4: float = 1e-6


def _patch_mi_and_weight(
    left: torch.Tensor,
    right: torch.Tensor,
    abs_gx: torch.Tensor | None,
    uv_l: torch.Tensor,
    uv_r: torch.Tensor,
    valid: torch.Tensor,
    cfg: ScaleConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., M) MI, Sobel weights and in-bounds validity of the patch pairs
    at uv_l / uv_r (..., M, 2) on images (..., H, W). ``abs_gx``: |Sobel-x|
    of ``left``, given when ``cfg.weighting``."""
    r = cfg.window_radius
    h, w = left.shape[-2:]
    ok = valid & im.patch_in_bounds(uv_l, r + 1, h, w) & im.patch_in_bounds(uv_r, r + 1, h, w)
    pl = im.extract_patches(left, uv_l, r)
    pr = im.extract_patches(right, uv_r, r)
    mi = sim.mutual_information_batched(pl, pr, bins=cfg.mi_bins, use_pallas=cfg.use_pallas)
    if cfg.weighting:
        gp = im.extract_patches(abs_gx, uv_l, r)
        weight = torch.mean(gp, dim=(-2, -1)) + 1e-20
    else:
        weight = torch.ones_like(mi)
    return mi, weight, ok


def _project_pair(pc: torch.Tensor, p: ScaleConfig) -> tuple[torch.Tensor, torch.Tensor]:
    return geo.project(pc, p.intr), geo.project(pc, p.intr, baseline_shift=p.baseline)


def estimate_scale(
    left: torch.Tensor,
    right: torch.Tensor,
    pts3: torch.Tensor,
    valid: torch.Tensor,
    s0: torch.Tensor | float,
    cfg: ScaleConfig,
) -> tuple[torch.Tensor, LMResult]:
    """Estimate the metric scale maximizing per-feature patch MI.

    Args:
      left, right: (..., H, W) rectified stereo images of the last frame.
      pts3: (..., N, 3) up-to-scale 3D points in the last frame's left-camera
        coordinates.
      valid: (..., N) which points participate.
      s0: (...) initial scale per problem (or one float for all).
      cfg: configuration.

    Returns (scale (...), LMResult with x (..., 1)).
    """
    p = cfg
    lead = pts3.shape[:-2]
    s0 = torch.as_tensor(s0, dtype=left.dtype, device=left.device).expand(lead)
    abs_gx = torch.abs(im.sobel(left)[0]) if p.weighting else None
    n = pts3.shape[-2]

    if p.coarse_candidates > 0:
        logr = math.log(p.coarse_range)
        grid = torch.linspace(-logr, logr, p.coarse_candidates, dtype=left.dtype,
                              device=left.device)
        cands = s0[..., None] * torch.exp(grid)  # (..., K)
        pc = cands[..., :, None, None] * pts3[..., None, :, :]  # (..., K, N, 3)
        uv_l, uv_r = _project_pair(pc, p)
        k = p.coarse_candidates
        mi, wt, ok = _patch_mi_and_weight(
            left, right, abs_gx, uv_l.reshape(*lead, k * n, 2), uv_r.reshape(*lead, k * n, 2),
            valid[..., None, :].expand(*lead, k, n).reshape(*lead, k * n), p)
        mi, wt, ok = (x.reshape(*lead, k, n) for x in (mi, wt, ok))
        okf = ok.to(mi.dtype)
        scores = torch.sum(mi * wt * okf, dim=-1) / torch.clamp(
            torch.sum(wt * okf, dim=-1), min=1e-9)
        best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
        s0 = torch.gather(cands, -1, best[..., None])[..., 0]

    def normal_eq(x):
        s = x[..., 0]
        pc = s[..., None, None] * pts3  # metric points at the candidate scale
        uv_l, uv_r = _project_pair(pc, p)
        mi, weight, ok = _patch_mi_and_weight(left, right, abs_gx, uv_l, uv_r, valid, p)
        okf = ok.to(mi.dtype)
        res = mi * weight * okf
        # finite-difference MI wrt a 1-px epipolar shift of the right patch
        uv_r_plus = uv_r + const([p.fd_step, 0.0], uv_r.dtype, uv_r.device)
        mi_plus, _, ok_p = _patch_mi_and_weight(left, right, abs_gx, uv_l, uv_r_plus, valid, p)
        z = torch.clamp(s[..., None] * pts3[..., 2], min=1e-6)
        duds = p.intr.fu * p.baseline / z  # optimisation.cpp:473
        J = (mi_plus - mi) / p.fd_step * duds * (ok & ok_p).to(mi.dtype)
        JJ = torch.sum(J * J * weight, dim=-1)[..., None, None]
        e = torch.sum(J * res, dim=-1)[..., None]
        cost = torch.sum(res, dim=-1) / torch.clamp(torch.sum(okf, dim=-1), min=1.0)
        return JJ, e, cost

    lm_cfg = LMConfig(max_iter=p.max_iter, use_lm=p.use_lm, minimize=False, abs_tol=p.e1,
                      grad_tol=p.e2, incr_tol=p.e3, rel_tol=p.e4)
    result = lm_solve(normal_eq, s0[..., None].clone(), lm_cfg)
    return result.x[..., 0], result
