"""Closed-form pose solvers: port of ``uasl_motion_estimation_tpu/ops/pnp.py``.
The triad 3-point rigid alignment and Grunert's P3P seed RANSAC hypotheses;
Umeyama aligns N weighted point pairs. Every function is batched over
leading dims and makes no host read."""

from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _triad_basis(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal frame from a point triple (..., 3, 3) [rows = points]:
    (basis (..., 3, 3) with the frame vectors as COLUMNS, ok flag)."""
    v1 = p[..., 1, :] - p[..., 0, :]
    v2 = p[..., 2, :] - p[..., 0, :]
    e1 = _normalize(v1)
    a = v2 - torch.sum(v2 * e1, dim=-1, keepdim=True) * e1
    e2 = _normalize(a)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    ok = (torch.linalg.norm(v1, dim=-1) > 1e-9) & (torch.linalg.norm(a, dim=-1) > 1e-9)
    return torch.stack([e1, e2, e3], dim=-1), ok


def rigid_align_3pt(p: torch.Tensor, q: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form rigid transform q ~= R @ p + t from 3 point pairs
    (..., 3, 3) by composing the two triangles' triad frames. Returns
    (R (..., 3, 3), t (..., 3), ok (...,) False for degenerate triples)."""
    Bp, ok_p = _triad_basis(p)
    Bq, ok_q = _triad_basis(q)
    R = torch.matmul(Bq, Bp.transpose(-1, -2))
    pc = torch.mean(p, dim=-2)
    qc = torch.mean(q, dim=-2)
    t = qc - torch.matmul(R, pc[..., None])[..., 0]
    return R, t, ok_p & ok_q


def rigid_align_umeyama(p: torch.Tensor, q: torch.Tensor,
                        weights: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares rigid transform q ~= R @ p + t from N weighted pairs
    (..., N, 3) by SVD (Kabsch/Umeyama, no scale). Returns (R, t)."""
    if weights is None:
        weights = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = weights[..., None] / torch.clamp(torch.sum(weights, dim=-1, keepdim=True)[..., None],
                                         min=1e-12)
    pc = torch.sum(p * w, dim=-2)
    qc = torch.sum(q * w, dim=-2)
    H = torch.matmul(((q - qc[..., None, :]) * w).transpose(-1, -2), p - pc[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(torch.matmul(U, Vt)))
    scale = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = torch.matmul(U * scale[..., None, :], Vt)
    t = qc - torch.matmul(R, pc[..., None])[..., 0]
    return R, t


# ---------------------------------------------------------------------------
# Grunert P3P (3D points + bearing rays -> camera pose)
# ---------------------------------------------------------------------------


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root; ``x ** (1/3)`` is NaN for x < 0."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_largest_real_root(B, C, D):
    """Largest real root of t^3 + B t^2 + C t + D, branch-free: Cardano
    where the discriminant is >= 0, the trigonometric form's k = 0 root
    where it is negative."""
    P = C - B * B / 3.0
    Q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)
    Pn = torch.clamp(P, max=-1e-30)  # P < 0 wherever disc < 0
    m = 2.0 * torch.sqrt(-Pn / 3.0)
    arg = torch.clamp(3.0 * Q / (Pn * m), -1.0, 1.0)
    s_trig = m * torch.cos(torch.arccos(arg) / 3.0)
    return torch.where(disc >= 0, s_card, s_trig) - B / 3.0


def _solve_quartic(c4, c3, c2, c1, c0):
    """Roots (..., 4) of c4 x^4 + ... + c0 by Ferrari's factorisation into
    two quadratics through the resolvent cubic, then two Newton steps on
    the real ones. Returns (roots, |imaginary part|); a complex pair gives
    its real part."""
    c4s = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # resolvent cubic in u = alpha^2: u^3 + 2p u^2 + (p^2 - 4r) u - q^2 = 0
    u = torch.clamp(_cubic_largest_real_root(2.0 * p, p * p - 4.0 * r, -q * q), min=1e-12)
    alpha = torch.sqrt(u)
    beta = (p + u - q / alpha) / 2.0
    gamma = (p + u + q / alpha) / 2.0
    # y^2 + alpha y + beta = 0 and y^2 - alpha y + gamma = 0
    d1 = alpha * alpha - 4.0 * beta
    d2 = alpha * alpha - 4.0 * gamma
    sq1 = torch.sqrt(torch.clamp(d1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
    roots_y = torch.stack([(-alpha + sq1) / 2.0, (-alpha - sq1) / 2.0,
                           (alpha + sq2) / 2.0, (alpha - sq2) / 2.0], dim=-1)
    im1 = torch.sqrt(torch.clamp(-d1, min=0.0)) / 2.0
    im2 = torch.sqrt(torch.clamp(-d2, min=0.0)) / 2.0
    imag = torch.stack([im1, im1, im2, im2], dim=-1)
    x = roots_y - (a / 4.0)[..., None]
    k4, k3, k2, k1, k0 = (v[..., None] for v in (c4, c3, c2, c1, c0))
    for _ in range(2):  # Newton polish of the real roots
        f = (((k4 * x + k3) * x + k2) * x + k1) * x + k0
        df = ((4.0 * k4 * x + 3.0 * k3) * x + 2.0 * k2) * x + k1
        step = f / torch.where(torch.abs(df) < 1e-12, torch.full_like(df, 1e-12), df)
        x = torch.where(imag == 0.0, x - step, x)
    return x, imag


def _polish_depths(s, ca, cb, cg, a2, b2, c2, iters: int = 3):
    """Newton steps of the depth triples (..., 3) on the law-of-cosines
    system, each a batched 3x3 solve without a host check; a component
    whose step is not finite keeps its value."""
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(iters):
        s1, s2, s3 = s.unbind(-1)
        f = torch.stack([s2 ** 2 + s3 ** 2 - 2.0 * s2 * s3 * ca - a2,
                         s1 ** 2 + s3 ** 2 - 2.0 * s1 * s3 * cb - b2,
                         s1 ** 2 + s2 ** 2 - 2.0 * s1 * s2 * cg - c2], dim=-1)
        z = torch.zeros_like(s1)
        J = torch.stack([
            torch.stack([z, 2.0 * (s2 - s3 * ca), 2.0 * (s3 - s2 * ca)], dim=-1),
            torch.stack([2.0 * (s1 - s3 * cb), z, 2.0 * (s3 - s1 * cb)], dim=-1),
            torch.stack([2.0 * (s1 - s2 * cg), 2.0 * (s2 - s1 * cg), z], dim=-1),
        ], dim=-2)
        ds = torch.linalg.solve_ex(J + 1e-9 * eye, f[..., None])[0][..., 0]
        s = torch.where(torch.isfinite(ds), s - ds, s)
    return s


def p3p_grunert(pts_world: torch.Tensor, rays: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grunert's closed-form P3P: camera pose from 3 world points and their 3
    unit bearing rays in the camera frame (rows of (..., 3, 3) each).

    The law-of-cosines system for the three depths reduces to a quartic in
    v = s3/s1; each real root gives the depths, a Newton polish refines
    them, and ``rigid_align_3pt`` recovers (R, t). Returns up to 4
    candidates mapping world points into the camera frame: R (..., 4, 3, 3),
    t (..., 4, 3), ok (..., 4) (False for the invalid ones)."""
    p1, p2, p3 = pts_world[..., 0, :], pts_world[..., 1, :], pts_world[..., 2, :]
    a2 = torch.sum((p2 - p3) ** 2, dim=-1)  # side opposite vertex 1
    b2 = torch.sum((p1 - p3) ** 2, dim=-1)
    c2 = torch.sum((p1 - p2) ** 2, dim=-1)
    ca = torch.sum(rays[..., 1, :] * rays[..., 2, :], dim=-1)  # cos alpha
    cb = torch.sum(rays[..., 0, :] * rays[..., 2, :], dim=-1)
    cg = torch.sum(rays[..., 0, :] * rays[..., 1, :], dim=-1)

    b2s = torch.clamp(b2, min=1e-12)
    D = (a2 - c2) / b2s
    E = c2 / b2s
    # the quartic in v from eliminating u = s2/s1 between the law-of-cosines
    # pairs (the coefficients of the JAX version)
    A4 = D ** 2 - 2.0 * D - 4.0 * E * ca ** 2 + 1.0
    A3 = 4.0 * (-(D ** 2) * cb + D * ca * cg + D * cb
                + 2.0 * E * ca ** 2 * cb + 2.0 * E * ca * cg - ca * cg)
    A2 = 2.0 * (2.0 * D ** 2 * cb ** 2 + D ** 2 - 4.0 * D * ca * cb * cg - 2.0 * D * cg ** 2
                - 2.0 * E * ca ** 2 - 8.0 * E * ca * cb * cg - 2.0 * E * cg ** 2
                + 2.0 * ca ** 2 + 2.0 * cg ** 2 - 1.0)
    A1 = 4.0 * (-(D ** 2) * cb + D * ca * cg + 2.0 * D * cb * cg ** 2 - D * cb
                + 2.0 * E * ca * cg + 2.0 * E * cb * cg ** 2 - ca * cg)
    A0 = D ** 2 - 4.0 * D * cg ** 2 + 2.0 * D - 4.0 * E * cg ** 2 + 1.0

    v, v_imag = _solve_quartic(A4, A3, A2, A1, A0)  # (..., 4)
    real_ok = v_imag < 1e-4 * (1.0 + torch.abs(v))
    D_, cb_, cg_, ca_, c2_ = (x[..., None] for x in (D, cb, cg, ca, c2))
    # back-substitute u = ((D-1) v^2 - 2 D cb v + (D+1)) / (2 (cg - v ca))
    num_u = (D_ - 1.0) * v ** 2 - 2.0 * D_ * cb_ * v + (D_ + 1.0)
    den_u = 2.0 * (cg_ - v * ca_)
    u = num_u / torch.where(torch.abs(den_u) < 1e-12, torch.full_like(den_u, 1e-12), den_u)
    s1_sq = c2_ / torch.clamp(1.0 + u ** 2 - 2.0 * u * cg_, min=1e-12)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=1e-12))
    s2, s3 = u * s1, v * s1
    ok = real_ok & (s1_sq > 0) & (s2 > 0) & (s3 > 0)

    # the quartic's float32 roots (~1e-3 relative) would leak ~depth * 1e-3
    # into the translation without the polish
    depths0 = torch.stack([s1, s2, s3], dim=-1)  # (..., 4, 3)
    depths = _polish_depths(depths0, *(x[..., None] for x in (ca, cb, cg, a2, b2, c2)))
    depths = torch.where(torch.all(depths > 0, dim=-1, keepdim=True), depths, depths0)

    cam_pts = depths[..., None] * rays[..., None, :, :]  # (..., 4, 3, 3)
    world = pts_world[..., None, :, :].expand(cam_pts.shape)
    R, t, align_ok = rigid_align_3pt(world, cam_pts)
    return R, t, ok & align_ok
