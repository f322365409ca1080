"""Monocular visual odometry: batched essential-matrix RANSAC + cheirality.

Port of ``uasl_motion_estimation_tpu/models/mono_vo.py`` (MonoVisualOdometry,
src/vo/MonoVisualOdometry.cpp:7-87):

* hypotheses, by ``solver``: ``"pencil8"``, one 8-point sample per
  hypothesis, all solved at once; with ``pencil`` the det-constraint pencil
  of the two smallest nullspace vectors gives up to 3 candidate E per
  sample, else the plain 8-point E. ``"5point"``, the exact minimal solver
  (ops/fivepoint.py), up to 10 candidates per 5-point sample, masked.
  ``"hybrid"``, the pencil first and the 5-point only where its inlier
  ratio collapses (``mono_vo_solve``);
* scoring: the squared Sampson distance of every match against every
  hypothesis as one (..., H*, N) tensor; argmax inlier count (``"ransac"``)
  or least median (``"lmeds"``);
* refit: row-weighted 8-point on the winning support, kept only if it does
  not lose support;
* recoverPose: 4 (R, t) decompositions, cheirality by closed-form ray
  midpoint depths;
* polish: ``refine_iters`` Gauss-Newton steps on the signed Sampson
  residuals over the 5-DoF essential manifold, then DLT triangulation.

Every function is batched over leading dims (the sequence scan's steps).
The JAX solver draws its Gumbel-top-k samples from a ``jax.random`` key,
which torch cannot reproduce; here the (..., H, k) sample indices come in
as arguments (``_sample_hypotheses`` of models/stereo_vo.py draws them from
a ``torch.Generator``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import const
from ..ops import geometry as geo
from ..ops import lie
from ..ops import smallalg as sal
from ..ops.fivepoint import fivepoint_candidates
from ..solvers.lm import masked_solve


class MonoVOParams(NamedTuple):
    """Same fields and defaults as the JAX MonoVOParams
    (MonoVisualOdometry.h:21-26 + the RANSAC knobs of VisualOdometry.h:32)."""

    intr: geo.Intrinsics
    n_ransac: int = 200
    inlier_threshold: float = 1.0  # px, Sampson distance
    min_matches: int = 8  # cpp:9
    min_inliers: int = 10  # cpp:47
    max_depth: float = 50.0  # recoverPose distanceThresh (cpp:29)
    robust: str = "ransac"  # "ransac" (max inliers) or "lmeds" (min median)
    pencil: bool = True  # det-constraint pencil: up to 3 E per sample
    refine_iters: int = 6  # GN steps on the essential manifold (0 = off)
    solver: str = "pencil8"  # "pencil8", "5point" (exact minimal) or "hybrid"
    hybrid_ratio: float = 0.45


class MonoVOResult(NamedTuple):
    R: torch.Tensor  # (..., 3, 3) rotation prev->cur
    t: torch.Tensor  # (..., 3) unit-norm translation
    Rt: torch.Tensor  # (..., 4, 4) motion matrix
    E: torch.Tensor  # (..., 3, 3) essential matrix
    inlier_mask: torch.Tensor  # (..., N)
    n_inliers: torch.Tensor  # (...)
    pts3d: torch.Tensor  # (..., N, 3) triangulated points (prev-camera frame)
    success: torch.Tensor  # (...)


# det(a F0 + (1 - a) F1) is a cubic in a; its coefficients [c3, c2, c1, c0]
# are fitted from the values at a in {0, 1, 2, -1} (constant 4x4 inverse)
_PENCIL_A = (0.0, 1.0, 2.0, -1.0)
_VAND_INV = np.linalg.inv(np.array([[a**3, a**2, a, 1.0] for a in _PENCIL_A]))


def _normalize(uv: torch.Tensor, intr: geo.Intrinsics) -> torch.Tensor:
    """Pixel -> normalized camera coordinates."""
    x = (uv[..., 0] - intr.cu) / intr.fu
    y = (uv[..., 1] - intr.cv) / intr.fv
    return torch.stack([x, y], dim=-1)


def _project_essential(F: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, _, Vt = sal.svd3_rotation(F)
    return torch.matmul(U * const([1.0, 1.0, 0.0], F.dtype, F.device), Vt)


def _nullspace_pair(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two smallest nullspace vectors (F0, F1), each (..., 3, 3), of the
    row-weighted, Hartley-conditioned epipolar system of p1, p2 (..., K, 2):
    a zero-weight row vanishes from A^T A and from the statistics."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)

    def condition(p):
        mu = torch.sum(p * w[..., None], dim=-2) / wsum[..., None]
        d = torch.sqrt(torch.sum((p - mu[..., None, :]) ** 2, dim=-1))
        s = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1) / wsum, min=1e-9)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([
            torch.stack([s, zero, -mu[..., 0] * s], dim=-1),
            torch.stack([zero, s, -mu[..., 1] * s], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ], dim=-2)
        return (p - mu[..., None, :]) * s[..., None, None], T

    q1, T1 = condition(p1)
    q2, T2 = condition(p2)
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # (..., K, 9)
    M = torch.matmul((A * w[..., None]).transpose(-1, -2), A)
    _, V = sal.eigh_jacobi(M)
    shape = V.shape[:-2] + (3, 3)
    T2t = T2.transpose(-1, -2)
    F0 = torch.matmul(torch.matmul(T2t, V[..., :, 0].reshape(shape)), T1)
    F1 = torch.matmul(torch.matmul(T2t, V[..., :, 1].reshape(shape)), T1)
    return F0, F1


def _eight_point(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Essential matrix from >= 8 normalized correspondences (..., K, 2),
    optionally row-weighted, projected to the essential manifold."""
    F0, _ = _nullspace_pair(p1, p2, w)
    return _project_essential(F0)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt; pow of a negative base is NaN)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_roots_real(c3, c2, c1, c0):
    """All real roots of c3 x^3 + c2 x^2 + c1 x + c0, branch-free: (..., 3);
    when only one real root exists it fills all slots."""
    c3s = torch.where(torch.abs(c3) < 1e-12, torch.full_like(c3, 1e-12), c3)
    B, C, D = c2 / c3s, c1 / c3s, c0 / c3s
    P = C - B * B / 3.0
    Q = 2.0 * B**3 / 27.0 - B * C / 3.0 + D
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)
    Pn = torch.clamp(P, max=-1e-30)
    m = 2.0 * torch.sqrt(-Pn / 3.0)
    arg = torch.clamp(3.0 * Q / (Pn * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    ks = torch.arange(3, dtype=theta.dtype, device=theta.device)
    s_trig = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * ks / 3.0)
    roots = torch.where((disc >= 0)[..., None], s_card[..., None], s_trig)
    return roots - (B / 3.0)[..., None]


def _pencil_candidates(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3, 3) essential candidates of 8-point samples (..., 8, 2):
    the real roots a of det(a F0 + (1-a) F1) = 0, each projected to the
    essential manifold (7-point-style, planar-safe)."""
    F0, F1 = _nullspace_pair(p1, p2)
    d = torch.stack([sal.det3(a * F0 + (1.0 - a) * F1) for a in _PENCIL_A], dim=-1)
    coeff = torch.matmul(d, const(_VAND_INV.T.tolist(), d.dtype, d.device))  # [c3, c2, c1, c0]
    roots = _cubic_roots_real(coeff[..., 0], coeff[..., 1], coeff[..., 2], coeff[..., 3])
    a = roots[..., None, None]
    return _project_essential(a * F0[..., None, :, :] + (1.0 - a) * F1[..., None, :, :])


def _sampson_sq(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance (normalized coords) of matches (..., N, 2)
    against E (..., 3, 3): (..., N)."""
    h1 = geo.to_homogeneous(p1)
    h2 = geo.to_homogeneous(p2)
    Ex1 = torch.matmul(h1, E.transpose(-1, -2))  # E @ x1
    Etx2 = torch.matmul(h2, E)  # E^T @ x2
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _triangulate_two_view(R, t, p1, p2):
    """Linear DLT triangulation for P1=[I|0], P2=[R|t]: (..., N, 3), the
    nullspace of each point's 4x4 normal matrix by Jacobi eigh."""
    h1 = geo.to_homogeneous(p1)
    h2 = geo.to_homogeneous(p2)
    P2 = torch.cat([R, t[..., None]], dim=-1)[..., None, :, :]  # (..., 1, 3, 4)
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    torch.zeros((3, 1), dtype=R.dtype, device=R.device)], dim=-1)
    rows = torch.stack([
        h1[..., 0, None] * P1[2] - P1[0],
        h1[..., 1, None] * P1[2] - P1[1],
        h2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        h2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., N, 4, 4)
    M = torch.matmul(rows.transpose(-1, -2), rows)
    _, V = sal.eigh_jacobi(M)
    X = V[..., :, 0]
    w = torch.where(torch.abs(X[..., 3]) < 1e-12, torch.full_like(X[..., 3], 1e-12), X[..., 3])
    return X[..., :3] / w[..., None]


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 2) orthonormal basis of the plane perpendicular to unit t."""
    ref = torch.where((torch.abs(t[..., 2]) < 0.9)[..., None],
                      const([0.0, 0.0, 1.0], t.dtype, t.device),
                      const([1.0, 0.0, 0.0], t.dtype, t.device))
    b1 = torch.linalg.cross(t, ref, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _signed_sampson(E, h1, h2, sqrt_w):
    """Weighted signed Sampson residuals (..., N) and their parts."""
    Ex1 = torch.matmul(h1, E.transpose(-1, -2))
    Etx2 = torch.matmul(h2, E)
    num = torch.sum(h2 * Ex1, dim=-1)
    den = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                     + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2 + 1e-18)
    return (num / den) * sqrt_w, Ex1, Etx2, num, den


def _refine_rt(R0, t0, p1, p2, w, iters: int):
    """GN polish of (R, t) on the essential manifold: minimize the weighted
    signed Sampson residuals over 3 rotation + 2 translation-direction
    parameters about the current (R, t), E = [t + B d_t]x exp(d_r) R. Each
    step is one 5x5 solve, kept only where the cost decreases; a fixed
    ``iters`` steps, as the JAX ``fori_loop``.

    The 5-column Jacobian at d = 0 is analytic (the JAX code takes jacfwd of
    the same residual): dE/dd_r[k] = [t]x [e_k]x R and dE/dd_t[j] = [b_j]x R,
    chained through the Sampson quotient."""
    h1 = geo.to_homogeneous(p1)
    h2 = geo.to_homogeneous(p2)
    sqrt_w = torch.sqrt(w)
    eye3 = torch.eye(3, dtype=R0.dtype, device=R0.device)
    gens = lie.skew(eye3)  # [e_k]x, (3, 3, 3)
    eye5 = 1e-9 * torch.eye(5, dtype=R0.dtype, device=R0.device)

    def cost_of(R, t):
        r = _signed_sampson(torch.matmul(lie.skew(t), R), h1, h2, sqrt_w)[0]
        return torch.sum(r * r, dim=-1)

    R, t = R0, t0
    cost = cost_of(R, t)
    for _ in range(iters):
        tx = lie.skew(t)
        basis = _tangent_basis(t)  # (..., 3, 2)
        r, a, b, num, den = _signed_sampson(torch.matmul(tx, R), h1, h2, sqrt_w)
        dE = torch.cat([
            torch.matmul(torch.matmul(tx[..., None, :, :], gens), R[..., None, :, :]),
            torch.matmul(lie.skew(basis.transpose(-1, -2)), R[..., None, :, :]),
        ], dim=-3)  # (..., 5, 3, 3)
        da = torch.matmul(h1[..., None, :, :], dE.transpose(-1, -2))  # (..., 5, N, 3)
        db = torch.matmul(h2[..., None, :, :], dE)
        dnum = torch.sum(h2[..., None, :, :] * da, dim=-1)  # (..., 5, N)
        a_, b_ = a[..., None, :, :], b[..., None, :, :]
        dden = (a_[..., 0] * da[..., 0] + a_[..., 1] * da[..., 1]
                + b_[..., 0] * db[..., 0] + b_[..., 1] * db[..., 1]) / den[..., None, :]
        dr = (dnum * den[..., None, :] - num[..., None, :] * dden) / (den * den)[..., None, :]
        J = (dr * sqrt_w[..., None, :]).transpose(-1, -2)  # (..., N, 5)
        A = torch.matmul(J.transpose(-1, -2), J) + eye5
        g = torch.matmul(J.transpose(-1, -2), r[..., None])[..., 0]
        d, _ = masked_solve(A, g)
        d = -d
        R_new = torch.matmul(lie.so3_exp(d[..., :3]), R)
        t_new = t + torch.matmul(basis, d[..., 3:5, None])[..., 0]
        t_new = t_new / torch.clamp(torch.linalg.norm(t_new, dim=-1, keepdim=True), min=1e-12)
        cost_new = cost_of(R_new, t_new)
        ok = torch.isfinite(cost_new) & (cost_new < cost)
        R = torch.where(ok[..., None, None], R_new, R)
        t = torch.where(ok[..., None], t_new, t)
        cost = torch.where(ok, cost_new, cost)
    return R, t


def _decompose_E(E: torch.Tensor):
    """4 candidate (R, t) pairs from E (Hartley-Zisserman)."""
    U, _, Vt = sal.svd3_rotation(E)
    U = U * torch.sign(sal.det3(U))[..., None, None]
    Vt = Vt * torch.sign(sal.det3(Vt))[..., None, None]
    W = const([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype, E.device)
    R1 = torch.matmul(torch.matmul(U, W), Vt)
    R2 = torch.matmul(torch.matmul(U, W.T), Vt)
    t = U[..., :, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def _midpoint_depths(R, t, p1, p2):
    """(z1, z2) per match from the closed-form ray midpoint: depth signs and
    magnitudes are all cheirality needs."""
    d1 = geo.to_homogeneous(p1)
    o2 = -torch.matmul(R.transpose(-1, -2), t[..., None])[..., 0]
    d2 = torch.matmul(geo.to_homogeneous(p2), R)
    a = torch.sum(d1 * d1, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    r1 = torch.matmul(d1, o2[..., None])[..., 0]
    r2 = torch.matmul(d2, o2[..., None])[..., 0]
    denom = a * c - b * b
    safe = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    return (c * r1 - b * r2) / safe, (b * r1 - a * r2) / safe


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b]] for a (B, M, *rest) and idx (B,)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def minimal_set(solver: str) -> int:
    """Matches per RANSAC sample of ``solver``: 5 for the exact 5-point,
    8 for the pencil (``"hybrid"``'s first pass; its escalation draws its
    own 5-point samples)."""
    return 5 if solver == "5point" else 8


def hybrid_take5(success5, n_inliers5, success8, n_inliers8):
    """Where an escalated 5-point solution replaces the pencil's: success
    leads, then more inliers (a failed pencil solution with more Sampson
    inliers must not beat a successful 5-point one)."""
    return (success5 & ~success8) | ((success5 == success8) & (n_inliers5 > n_inliers8))


def mono_vo_solve(
    matches: torch.Tensor,
    valid: torch.Tensor,
    samples: torch.Tensor,
    params: MonoVOParams,
    samples5: torch.Tensor | None = None,
    stats: dict | None = None,
) -> MonoVOResult:
    """Egomotion from 2-view pixel matches (process(), cpp:7-73).

    Args:
      matches: (..., N, 2, 2) [prev uv, cur uv] pixel matches.
      valid: (..., N) bool.
      samples: (..., H, k) int match indices, one minimal sample per
        hypothesis (H = ``params.n_ransac``; k = ``minimal_set(solver)``:
        5 for ``"5point"``, 8 for ``"pencil8"`` and ``"hybrid"``).
      params: solver configuration.
      samples5: (..., H, 5) the 5-point samples of ``"hybrid"``'s escalation
        (the JAX solver draws them from ``fold_in(key, 5)``).
      stats: for ``"hybrid"``, when given, gets the (...) bool device masks
        ``escalated`` (re-solved with the 5-point) and ``replaced`` (the
        5-point solution kept).

    ``"hybrid"`` solves every problem with the pencil, then re-solves with
    the exact 5-point only the problems whose inliers fall below
    ``hybrid_ratio`` of their valid matches, or whose solve failed: they
    are picked with one host read, solved as one batch and scattered back
    (JAX's per-problem ``lax.cond``). The 5-point solution replaces the
    pencil's where ``hybrid_take5`` says so.
    """
    if params.solver not in ("pencil8", "5point", "hybrid"):
        raise ValueError(f"unknown solver {params.solver!r}")
    if params.robust not in ("ransac", "lmeds"):
        raise ValueError(f"unknown robust scoring {params.robust!r}")
    k = minimal_set(params.solver)
    if samples.shape[-1] != k:
        raise ValueError(f"solver={params.solver!r} takes samples of {k} matches, got "
                         f"{samples.shape[-1]}")
    if params.solver == "hybrid" and (samples5 is None or samples5.shape[-1] != 5):
        raise ValueError("solver='hybrid' needs samples5 (..., H, 5) for its escalation")
    lead = valid.shape[:-1]
    n = valid.shape[-1]

    def flat(x):
        return x.reshape(-1, *x.shape[-2:]).to(torch.int64)

    m, v = matches.reshape(-1, n, 2, 2), valid.reshape(-1, n)
    if params.solver == "hybrid":
        out, escalated, replaced = _hybrid(m, v, flat(samples), flat(samples5), params)
        if stats is not None:
            stats.update(escalated=escalated.reshape(lead), replaced=replaced.reshape(lead))
    else:
        out = _mono_vo_impl(m, v, flat(samples), params)
    return MonoVOResult(*(x.reshape(tuple(lead) + tuple(x.shape[1:])) for x in out))


def _hybrid(matches, valid, samples, samples5, p: MonoVOParams
            ) -> tuple[MonoVOResult, torch.Tensor, torch.Tensor]:
    """``solver="hybrid"`` on one flat batch dim (see mono_vo_solve): the
    result and the (B,) escalated and replaced masks."""
    res8 = _mono_vo_impl(matches, valid, samples, p._replace(solver="pencil8"))
    n_valid = torch.clamp(torch.sum(valid, dim=-1), min=1)
    need5 = (res8.n_inliers < p.hybrid_ratio * n_valid) | ~res8.success
    replaced = torch.zeros_like(need5)
    idx = torch.nonzero(need5).flatten()  # the one host read
    if idx.numel() == 0:
        return res8, need5, replaced
    res5 = _mono_vo_impl(matches[idx], valid[idx], samples5[idx], p._replace(solver="5point"))
    take5 = hybrid_take5(res5.success, res5.n_inliers, res8.success[idx], res8.n_inliers[idx])
    replaced[idx] = take5
    out = []
    for a5, a8 in zip(res5, res8):
        a8 = a8.clone()
        a8[idx] = torch.where(take5.reshape((-1,) + (1,) * (a5.ndim - 1)), a5, a8[idx])
        out.append(a8)
    return MonoVOResult(*out), need5, replaced


def _mono_vo_impl(matches, valid, samples, p: MonoVOParams) -> MonoVOResult:
    """mono_vo_solve of one solver (``"pencil8"`` or ``"5point"``) on one
    flat batch dim: matches (B, N, 2, 2), valid (B, N), samples (B, H, k)."""
    nb = matches.shape[0]
    rows = torch.arange(nb, device=matches.device)
    p1 = _normalize(matches[:, :, 0], p.intr)  # prev
    p2 = _normalize(matches[:, :, 1], p.intr)  # cur
    thr2 = (p.inlier_threshold / p.intr.fu) ** 2

    # --- RANSAC over minimal samples ---
    s1 = p1[rows[:, None, None], samples]  # (B, H, k, 2)
    s2 = p2[rows[:, None, None], samples]
    hyp_ok = None
    if p.solver == "5point":
        Es, hyp_ok = fivepoint_candidates(s1, s2)  # (B, H, 10, 3, 3), (B, H, 10)
        Es, hyp_ok = Es.flatten(1, 2), hyp_ok.flatten(1, 2)
    elif p.pencil:
        Es = _pencil_candidates(s1, s2).flatten(1, 2)  # (B, 3H, 3, 3)
    else:
        Es = _eight_point(s1, s2)  # (B, H, 3, 3)

    d2 = _sampson_sq(Es, p1[:, None], p2[:, None])  # (B, H*, N)
    if hyp_ok is not None:  # a candidate that was not found scores no match
        d2 = torch.where(hyp_ok[..., None], d2, torch.inf)
    inl = (d2 < thr2) & valid[:, None, :]
    if p.robust == "lmeds":
        # least median of squares (cv::LMEDS): the hypothesis with the least
        # median squared Sampson distance over valid matches, then the inlier
        # gate from sigma = 1.4826 (1 + 5/(n-8)) sqrt(med). nanquantile at
        # 0.5 averages the two middle values, as jnp.nanmedian does
        d2m = torch.where(valid[:, None, :], d2, torch.full_like(d2, torch.nan))
        med = torch.nanquantile(d2m, 0.5, dim=-1)  # (B, H*)
        best = torch.argmin(torch.where(torch.isfinite(med), med,
                                        torch.full_like(med, torch.inf)), dim=-1)
        n_valid_f = torch.clamp(torch.sum(valid, dim=-1).to(p1.dtype), min=9.0)
        sigma = 1.4826 * (1.0 + 5.0 / (n_valid_f - 8.0)) * torch.sqrt(
            torch.clamp(_pick(med, best), min=1e-18))
        gate = torch.clamp((2.5 * sigma) ** 2, min=thr2)
        best_mask = (_pick(d2, best) < gate[:, None]) & valid
    else:
        counts = torch.sum(inl, dim=-1)
        best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
        best_mask = _pick(inl, best)

    # refit on the best support set (row-weighted 8-point); keep it only if
    # it does not lose support at the base threshold
    E = _eight_point(p1, p2, best_mask.to(p1.dtype))
    refit_support = torch.sum((_sampson_sq(E, p1, p2) < thr2) & valid, dim=-1)
    minimal_support = torch.sum(_pick(inl, best), dim=-1)
    E = torch.where((refit_support >= minimal_support)[:, None, None], E, _pick(Es, best))
    inlier_mask = (_sampson_sq(E, p1, p2) < thr2) & valid
    n_inliers = torch.sum(inlier_mask, dim=-1)

    # --- recoverPose: cheirality over the 4 decompositions (cpp:29) ---
    cands = _decompose_E(E)
    scores = []
    for R_c, t_c in cands:
        z1, z2 = _midpoint_depths(R_c, t_c, p1, p2)
        good = (z1 > 0) & (z2 > 0) & (z1 < p.max_depth) & inlier_mask
        scores.append(torch.sum(good, dim=-1))
    scores = torch.stack(scores, dim=-1)  # (B, 4)
    ibest = torch.argmax(scores, dim=-1)
    R = _pick(torch.stack([c[0] for c in cands], dim=1), ibest)
    t = _pick(torch.stack([c[1] for c in cands], dim=1), ibest)

    if p.refine_iters > 0:
        R, t = _refine_rt(R, t, p1, p2, inlier_mask.to(p1.dtype), p.refine_iters)
        E = torch.matmul(lie.skew(t), R)
        inlier_mask = (_sampson_sq(E, p1, p2) < thr2) & valid
        n_inliers = torch.sum(inlier_mask, dim=-1)
    X = _triangulate_two_view(R, t, p1, p2)

    Rt = torch.eye(4, dtype=R.dtype, device=R.device).repeat(nb, 1, 1)
    Rt[:, :3, :3] = R
    Rt[:, :3, 3] = t
    success = ((torch.sum(valid, dim=-1) >= p.min_matches)
               & (n_inliers >= p.min_inliers)
               & (_pick(scores, ibest) > 0))
    return MonoVOResult(R=R, t=t, Rt=Rt, E=E, inlier_mask=inlier_mask,
                        n_inliers=n_inliers, pts3d=X, success=success)
