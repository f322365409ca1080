"""Stereo visual odometry: batched RANSAC + GN/LM 6-DoF pose engine.

Port of ``uasl_motion_estimation_tpu/models/stereo_vo.py``
(StereoVisualOdometry, src/vo/StereoVisualOdometry.cpp:22-342): all
``n_ransac`` 3-point samples at once, a closed-form seed per hypothesis
(the triad alignment, or the best of Grunert's P3P candidates) and a short
fixed GN polish, one (H, N) inlier vote, then the masked GN/LM refine
(solvers/lm.py) and the motion covariance. Every function is batched
over leading dims, so the sequence scan solves its chunk of steps together.

State convention: ``x = [roll, pitch, yaw, tx, ty, tz]``; previous-frame
points map into the current frame by ``Tr = [euler_to_R(x[:3]).T | x[3:]]``.

RANSAC samples: ``jax.random`` cannot be reproduced in torch. The port draws
its Gumbel-top-3 triples from ``torch.Generator``s (one per problem), and
``stereo_vo_solve`` also takes precomputed ``samples`` so tests can inject
the JAX-drawn ones.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from ..device import const
from ..ops import geometry as geo
from ..ops import lie
from ..ops import pnp
from ..solvers.lm import LMConfig, StopCondition, lm_solve, masked_solve


class StereoVOParams(NamedTuple):
    """Same fields and defaults as the JAX StereoVOParams
    (VisualOdometry.h:32, StereoVisualOdometry.h:24-33)."""

    intr1: geo.Intrinsics
    intr2: geo.Intrinsics
    baseline: float
    use_lm: bool = False
    max_iter: int = 100
    e1: float = 1e-3  # mean reproj error tol
    e2: float = 1e-8  # gradient tol
    e3: float = 2e-5  # increment tol (relative)
    e4: float = 1e-10  # relative decrease tol
    ransac: bool = True
    n_ransac: int = 200
    inlier_threshold: float = 2.0
    min_spread_area: float = 1000.0  # RANSAC sample triangle area, cpp:63
    min_matches: int = 6  # cpp:41
    min_inliers: int = 6  # cpp:84
    hyp_solver: str = "3pt"  # "3pt" | "p3p" | "gn"
    ransac_gn_iters: int = 2


class StereoVOResult(NamedTuple):
    state: torch.Tensor  # (..., 6)
    motion: torch.Tensor  # (..., 4, 4)
    inlier_mask: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...)
    success: torch.Tensor  # (...) bool
    stop: torch.Tensor  # (...) StopCondition of the final refinement
    mean_reproj_error: torch.Tensor  # (...)
    cov: torch.Tensor  # (..., 6, 6) on the [dt, dtheta] tangent


# A torch.Generator for one problem, or a (nested) sequence, one per problem.
Key = Union[torch.Generator, Sequence["Key"]]


def _transform(state: torch.Tensor, pts3: torch.Tensor) -> torch.Tensor:
    """Apply Tr = [R(euler).T | t] to previous-frame points (cpp:126-133)."""
    R = lie.euler_to_R(state[..., :3])
    return torch.matmul(pts3, R) + state[..., None, 3:6]


def _reproject(state, pts3, p: StereoVOParams):
    pt_next = _transform(state, pts3)
    return (geo.project(pt_next, p.intr1),
            geo.project(pt_next, p.intr2, baseline_shift=p.baseline))


def _residuals(state, pts3, obs, p: StereoVOParams) -> torch.Tensor:
    """(..., N, 4) residuals [obs_l - pred_l, obs_r - pred_r] (cpp:179-185)."""
    pred_l, pred_r = _reproject(state, pts3, p)
    return torch.cat([obs[..., 0, :] - pred_l, obs[..., 1, :] - pred_r], dim=-1)


def _jacobian(state, pts3, p: StereoVOParams) -> torch.Tensor:
    """Analytic (..., N, 4, 6) jacobian of the predictions (updateJacobian,
    cpp:291-329)."""
    dRdr, dRdp, dRdy = lie.euler_dR(state[..., :3])
    pt_next = _transform(state, pts3)
    x, y, z = pt_next[..., 0], pt_next[..., 1], pt_next[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    dpts_rot = torch.stack([torch.matmul(pts3, dRdr), torch.matmul(pts3, dRdp),
                            torch.matmul(pts3, dRdy)], dim=-2)  # (..., N, 3, 3)
    eye = torch.eye(3, dtype=pts3.dtype, device=pts3.device).expand(dpts_rot.shape)
    dpts = torch.cat([dpts_rot, eye], dim=-2)  # (..., N, 6, 3)
    dx, dy, dz = dpts[..., 0], dpts[..., 1], dpts[..., 2]
    xe, ye, ze = x[..., None], y[..., None], z[..., None]
    ju_l = p.intr1.fu * (dx * ze - xe * dz) / (ze * ze)
    jv_l = p.intr1.fv * (dy * ze - ye * dz) / (ze * ze)
    ju_r = p.intr2.fu * (dx * ze - (xe - p.baseline) * dz) / (ze * ze)
    jv_r = p.intr2.fv * (dy * ze - ye * dz) / (ze * ze)
    return torch.stack([ju_l, jv_l, ju_r, jv_r], dim=-2)


def _normal_eq(state, pts3, obs, weights, p: StereoVOParams):
    """(JJ, Jr, mean squared residual) over weighted matches, in full f32
    (no TF32: see device.py)."""
    res = _residuals(state, pts3, obs, p)
    J = _jacobian(state, pts3, p)
    w = weights[..., None]
    JJ = torch.einsum("...nri,...nrj->...ij", J * w[..., None], J)
    Jr = torch.einsum("...nri,...nr->...i", J, res * w)
    n_eff = torch.clamp(torch.sum(weights, dim=-1) * 4.0, min=1.0)
    cost = torch.sum(res * res * w, dim=(-2, -1)) / n_eff
    return JJ, Jr, cost


def _cost_only(state, pts3, obs, weights, p: StereoVOParams) -> torch.Tensor:
    res = _residuals(state, pts3, obs, p)
    n_eff = torch.clamp(torch.sum(weights, dim=-1) * 4.0, min=1.0)
    return torch.sum(res * res * weights[..., None], dim=(-2, -1)) / n_eff


def _gn_fixed(state0, pts3, obs, weights, p: StereoVOParams, n_iters: int):
    """Fixed-iteration Gauss-Newton inside the RANSAC hypotheses; a step
    whose solve is not finite leaves that hypothesis where it was."""
    eye = torch.eye(6, dtype=state0.dtype, device=state0.device)
    st = state0
    for _ in range(n_iters):
        JJ, Jr, _ = _normal_eq(st, pts3, obs, weights, p)
        dx, _ = masked_solve(JJ + 1e-9 * eye, Jr)
        st = st + dx
    return st


def _sq_reproj_error(state, pts3, obs, p: StereoVOParams) -> torch.Tensor:
    """(..., N) squared reprojection error over the 4 residuals (cpp:103-110)."""
    res = _residuals(state, pts3, obs, p)
    return torch.sum(res * res, dim=-1)


def sample_generator(seed: int, step: int, device: torch.device | str,
                     stream: int = 0) -> torch.Generator:
    """A generator keyed on (seed, global step) for the RANSAC samples of
    that step. The card's Philox takes the whole 64-bit key (seed << 32) +
    step; the CPU's Mersenne Twister keeps only a seed's low 32 bits, so
    there the seed is mixed into them (seed 0 keys alike either way). A
    non-zero ``stream`` keys a second, independent set of samples for the
    same step: the key is multiplied by a 64-bit odd constant and the
    stream added, within the generator's key width."""
    gen = torch.Generator(device=device)
    if gen.device.type == "cpu":
        key, width = (seed * 0x9E3779B1 + step) & 0xFFFFFFFF, 0xFFFFFFFF
    else:
        key, width = (seed << 32) + step, 0xFFFFFFFFFFFFFFFF
    if stream:
        key = (key * 0x9E3779B97F4A7C15 + stream) & width
    gen.manual_seed(key)
    return gen


def _sample_hypotheses(key: Key, n_ransac: int, valid: torch.Tensor, k: int = 3
                       ) -> torch.Tensor:
    """(..., H, k) int64 tuples of valid match indices by Gumbel-top-k over
    the valid mask: with replacement across hypotheses, without inside a
    tuple (selectRandomIndices, cpp:143-163). ``key`` is one generator per
    problem of ``valid`` (..., N)."""
    if valid.ndim > 1:
        return torch.stack([_sample_hypotheses(g, n_ransac, v, k)
                            for g, v in zip(key, valid, strict=True)])
    u = torch.rand((n_ransac, valid.shape[0]), generator=key, device=valid.device)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid, g, torch.full_like(g, -torch.inf))
    return torch.topk(g, k, dim=-1).indices


def _take(a: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """a[..., idx, rest] per problem: a (batch, N, *rest), idx (batch, *I)
    -> (batch, *I, *rest), with ``nb`` batch dims."""
    batch, rest = a.shape[:nb], a.shape[nb + 1:]
    inner = idx.shape[nb:]
    flat = idx.reshape(*batch, -1, *([1] * len(rest)))
    out = torch.gather(a, nb, flat.expand(*batch, flat.shape[nb], *rest))
    return out.reshape(*batch, *inner, *rest)


def _triangle_area(uv: torch.Tensor) -> torch.Tensor:
    """Signed area of the triangle of 3 pixel locations (cpp:63)."""
    a, b, c = uv[..., 0, :], uv[..., 1, :], uv[..., 2, :]
    return 0.5 * (a[..., 0] * (b[..., 1] - c[..., 1])
                  + b[..., 0] * (c[..., 1] - a[..., 1])
                  + c[..., 0] * (a[..., 1] - b[..., 1]))


def stereo_vo_solve(
    matches: torch.Tensor,
    valid: torch.Tensor,
    key: Key | None,
    params: StereoVOParams,
    init: torch.Tensor | None = None,
    samples: torch.Tensor | None = None,
) -> StereoVOResult:
    """Frame-to-frame egomotion from padded quad matches.

    Args:
      matches: (..., N, 4, 2) pixels [f1 prevL, f2 prevR, f3 curL, f4 curR].
      valid: (..., N) bool mask of real matches.
      key: RANSAC generator(s), one per problem; unused when ``samples`` is
        given or ``params.ransac`` is False.
      params: solver configuration.
      init: optional (..., 6) initial state.
      samples: optional precomputed (..., H, 3) hypothesis index triples.
    """
    p = params
    nb = matches.ndim - 3
    batch = matches.shape[:nb]
    dtype, dev = matches.dtype, matches.device
    if init is None:
        init = torch.zeros(*batch, 6, dtype=dtype, device=dev)
    init = init.to(dtype).expand(*batch, 6)

    pts3 = geo.triangulate_disparity(matches[..., 0, :], matches[..., 1, :],
                                     p.intr1, p.intr2, p.baseline)
    obs = matches[..., 2:4, :]
    valid_f = valid.to(dtype)
    n_valid = torch.sum(valid, dim=-1)

    if p.ransac:
        if p.hyp_solver not in ("3pt", "p3p", "gn"):
            raise ValueError(f"unknown hyp_solver {p.hyp_solver!r}")
        if samples is None:
            samples = _sample_hypotheses(key, p.n_ransac, valid)
        samples = samples.to(device=dev, dtype=torch.int64)
        sample_uv = _take(matches[..., 2, :], samples, nb)  # (..., H, 3, 2)
        spread_ok = torch.abs(_triangle_area(sample_uv)) > p.min_spread_area
        sample_valid = torch.all(_take(valid, samples, nb), dim=-1) & spread_ok

        P = _take(pts3, samples, nb)  # (..., H, 3, 3)
        O = _take(obs, samples, nb)  # (..., H, 3, 2, 2)
        W = _take(valid_f, samples, nb)  # (..., H, 3)
        init_h = init[..., None, :].expand(*samples.shape[:-1], 6)
        if p.hyp_solver == "3pt":
            # closed-form triad seed on the prev/cur triangulated triples,
            # then a short GN polish
            pts3_cur = geo.triangulate_disparity(
                matches[..., 2, :], matches[..., 3, :], p.intr1, p.intr2, p.baseline)
            Rh, th, ok = pnp.rigid_align_3pt(P, _take(pts3_cur, samples, nb))
            seed = torch.cat([lie.R_to_euler(Rh.transpose(-1, -2)), th], dim=-1)
            good = ok & torch.all(torch.isfinite(seed), dim=-1)
            seed = torch.where(good[..., None], seed, init_h)
            hyp_states = _gn_fixed(seed, P, O, W, p, p.ransac_gn_iters)
        elif p.hyp_solver == "p3p":
            # Grunert P3P on the previous-frame points and the current-left
            # bearings: each sample keeps the one of its 4 candidates with
            # the least reprojection error on its own 3 matches
            f3 = matches[..., 2, :]
            rays = torch.stack([(f3[..., 0] - p.intr1.cu) / p.intr1.fu,
                                (f3[..., 1] - p.intr1.cv) / p.intr1.fv,
                                torch.ones_like(f3[..., 0])], dim=-1)
            rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
            Rs, ts, oks = pnp.p3p_grunert(P, _take(rays, samples, nb))  # (..., H, 4, ...)
            states = torch.cat([lie.R_to_euler(Rs.transpose(-1, -2)), ts], dim=-1)
            good = oks & torch.all(torch.isfinite(states), dim=-1)
            states = torch.where(good[..., None], states, init_h[..., None, :])
            errs3 = torch.sum(_sq_reproj_error(states, P[..., None, :, :],
                                               O[..., None, :, :, :], p), dim=-1)
            pick = torch.argmin(errs3, dim=-1)  # first minimum, as jnp.argmin
            seed = torch.gather(states, -2, pick[..., None, None].expand(
                *pick.shape, 1, 6))[..., 0, :]
            hyp_states = _gn_fixed(seed, P, O, W, p, p.ransac_gn_iters)
        else:
            hyp_states = _gn_fixed(init_h, P, O, W, p, max(p.ransac_gn_iters, 12))

        errs = _sq_reproj_error(hyp_states, pts3[..., None, :, :],
                                obs[..., None, :, :, :], p)  # (..., H, N)
        inl = (errs < p.inlier_threshold ** 2) & valid[..., None, :]
        counts = torch.where(sample_valid, torch.sum(inl, dim=-1),
                             torch.full_like(sample_valid, -1, dtype=torch.int64))
        best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
        c_best = torch.gather(counts, -1, best[..., None])[..., 0]
        inl_best = torch.gather(
            inl, -2, best[..., None, None].expand(*batch, 1, inl.shape[-1]))[..., 0, :]
        inlier_mask = inl_best & (c_best > 0)[..., None]
        h_best = torch.gather(
            hyp_states, -2, best[..., None, None].expand(*batch, 1, 6))[..., 0, :]
        refine_init = torch.where((c_best > 0)[..., None], h_best, init)
    else:
        inlier_mask = valid
        refine_init = init

    n_inliers = torch.sum(inlier_mask, dim=-1)
    w_final = inlier_mask.to(dtype)

    cfg = LMConfig(max_iter=p.max_iter, use_lm=p.use_lm, minimize=True, tau=1e-5,
                   abs_tol=p.e1, grad_tol=p.e2, incr_tol=p.e3, rel_tol=p.e4)
    result = lm_solve(
        lambda s: _normal_eq(s, pts3, obs, w_final, p),
        refine_init,
        cfg,
        cost_fn=lambda s: _cost_only(s, pts3, obs, w_final, p),
    )

    # MAX_ITERATIONS is accepted when the residual is within the inlier
    # threshold (the practical contract, stereo_vo.py:385-397 of the JAX side)
    acceptable = ((result.stop == int(StopCondition.MAX_ITERATIONS))
                  & (result.cost < p.inlier_threshold ** 2))
    success = ((result.success | acceptable)
               & (n_valid >= p.min_matches) & (n_inliers >= p.min_inliers))
    state = torch.where(success[..., None], result.x, init)
    motion = _motion_matrix(state)

    # sigma^2 (J^T J)^-1 at the solution, reordered from [euler, t] to the
    # [dt, dtheta] pose tangent; failed solves carry a large diagonal
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    JJ, _, _ = _normal_eq(state, pts3, obs, w_final, p)
    sigma2 = torch.clamp(result.cost, min=1e-8)
    cov_state = sigma2[..., None, None] * torch.linalg.inv_ex(JJ + 1e-9 * eye6)[0]
    perm = const([3, 4, 5, 0, 1, 2], torch.int64, dev)
    cov = cov_state[..., perm, :][..., :, perm]
    cov = torch.where(success[..., None, None], cov, 1e2 * eye6)

    return StereoVOResult(state=state, motion=motion, inlier_mask=inlier_mask,
                          n_inliers=n_inliers, success=success, stop=result.stop,
                          mean_reproj_error=result.cost, cov=cov)


def _motion_matrix(state: torch.Tensor) -> torch.Tensor:
    """getMotion (cpp:331-342): Rt = [euler_to_R(state).T | t], (..., 4, 4)."""
    R = lie.euler_to_R(state[..., :3]).transpose(-1, -2)
    top = torch.cat([R, state[..., 3:6, None]], dim=-1)
    bottom = const([0.0, 0.0, 0.0, 1.0], state.dtype, state.device).expand(
        *state.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def stereo_vo_batch(matches: torch.Tensor, valid: torch.Tensor, keys: Sequence[torch.Generator],
                    params: StereoVOParams) -> StereoVOResult:
    """A batch of independent frame problems (B, N, 4, 2), one generator per
    problem: ``stereo_vo_solve`` already solves them together."""
    if len(keys) != matches.shape[0]:
        raise ValueError(f"{len(keys)} generators for {matches.shape[0]} problems")
    return stereo_vo_solve(matches, valid, list(keys), params)
