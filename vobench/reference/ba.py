"""Plain reference of windowed stereo bundle adjustment.

The problem the port's ``ba_solve`` states: cameras (world -> camera, the
first ``n_fixed`` of each window held), points seen in at least two frames
whose depth in the first camera is held in [zmin, zmax], the mean
Huber(``delta``) cost of the 4-residual stereo reprojection error over the
valid observations. The reference minimises it with its own
Levenberg-Marquardt (IRLS weights, a left perturbation of each camera,
landmarks eliminated by the Schur complement) run to a fixed point, and
computes camera covariances from the reduced camera system at a given
solution.
"""

from __future__ import annotations

import torch

from . import geometry as g
from .prec import Prec
from .vo import d_predict, predict


def _residuals(R, t, X, obs, p: Prec, rig):
    """Camera-frame points (K, W, M, 3) and residuals obs - prediction."""
    Xc = p.ein("kwij,kmj->kwmi", R, X) + t[:, :, None, :]
    return Xc, obs - predict(Xc, rig)


def _huber(r, mask, delta):
    """(cost (K,), IRLS weights (K, W, M)) of the mean Huber cost."""
    sq = torch.sum(r * r, -1)
    nrm = torch.sqrt(sq + 1e-12)
    inside = nrm <= delta
    rho = torch.where(inside, sq, 2.0 * delta * nrm - delta * delta)
    cost = torch.sum(rho * mask, (-2, -1)) / torch.clamp(torch.sum(mask, (-2, -1)), min=1.0)
    w = torch.where(inside, torch.ones_like(nrm), delta / nrm) * mask
    return cost, w


def cost(R, t, X, obs, mask, rig, delta, p: Prec) -> torch.Tensor:
    """Mean Huber cost (K,) at a state."""
    return _huber(_residuals(R, t, X, obs, p, rig)[1], mask, delta)[0]


def _blocks(R, t, X, obs, mask, rig, delta, p: Prec):
    """Normal-equation blocks of the IRLS Gauss-Newton step."""
    Xc, r = _residuals(R, t, X, obs, p, rig)
    c, w = _huber(r, mask, delta)
    Jx = d_predict(Xc, rig)  # (K, W, M, 4, 3)
    Jc = torch.cat([p.mm(Jx, -g.skew(Xc)), Jx], -1)  # camera (left perturbation)
    Jp = p.ein("kwmri,kwij->kwmrj", Jx, R)  # point
    Jcw = Jc * w[..., None, None]
    U = p.ein("kwmri,kwmrj->kwij", Jcw, Jc)
    V = p.ein("kwmri,kwmrj->kmij", Jp * w[..., None, None], Jp)
    Wc = p.ein("kwmri,kwmrj->kwmij", Jcw, Jp)
    wr = r * w[..., None]
    bc = p.ein("kwmri,kwmr->kwi", Jc, wr)
    bp = p.ein("kwmri,kwmr->kmi", Jp, wr)
    return U, V, Wc, bc, bp, c


def _reduced(U, Vinv, Wc, p: Prec):
    """S = blockdiag(U) - Wc Vinv Wc^T as (K, 6W, 6W), and Wc Vinv."""
    K, W = U.shape[:2]
    WV = p.ein("kwmij,kmjl->kwmil", Wc, Vinv)
    S = -p.ein("kwmil,kvmjl->kwivj", WV, Wc)
    idx = torch.arange(W, device=U.device)
    S[:, idx, :, idx, :] += U.permute(1, 0, 2, 3)
    return S.reshape(K, 6 * W, 6 * W), WV


def _pin(S: torch.Tensor, W: int, n_fixed: int) -> torch.Tensor:
    """Rows and columns of the first ``n_fixed`` cameras -> identity."""
    free = (torch.arange(6 * W, device=S.device) >= 6 * n_fixed).to(S.dtype)
    return S * free[:, None] * free[None, :] + torch.diag(1.0 - free)


def depth_bounds(rig) -> tuple[float, float]:
    """The stereo depth bounds the port's BAConfig states at its defaults:
    [f B / (2 cu), f B / 0.1]."""
    fb = rig.fu * rig.baseline
    return fb / (2.0 * rig.cu), fb / 0.1


def _clamp_depth(R, t, X, bounds):
    """Points with their depth in each window's first camera clamped."""
    R0, t0 = R[:, 0], t[:, 0]
    pc = torch.einsum("kij,kmj->kmi", R0, X) + t0[:, None]
    pc = torch.cat([pc[..., :2], torch.clamp(pc[..., 2:], *bounds)], -1)
    return torch.einsum("kji,kmj->kmi", R0, pc - t0[:, None])


def solve(R, t, X, obs, mask, rig, n_fixed: int, delta: float, p: Prec, iters: int = 40):
    """Minimise the window costs from (R (K, W, 3, 3), t (K, W, 3), X (K, M, 3)).
    Returns (R, t, X, cost (K,), converged (K,)): converged where the last
    accepted step lowered the cost by under 1e-6 of it, or no step could."""
    obs, mask = p.t(obs), p.t(mask)
    R, t, X = p.t(R), p.t(t), p.t(X)
    K, W = t.shape[:2]
    pt_ok = torch.sum(mask, -2) >= 2.0  # (K, M)
    free_cam = (torch.arange(W, device=t.device) >= n_fixed).to(p.dtype)
    lam = torch.full((K,), 1e-3, dtype=p.dtype, device=t.device)
    last_rel = torch.ones(K, dtype=p.dtype, device=t.device)
    eye3 = torch.eye(3, dtype=p.dtype, device=t.device)
    c = cost(R, t, X, obs, mask, rig, delta, p)
    for _ in range(iters):
        U, V, Wc, bc, bp, _ = _blocks(R, t, X, obs, mask, rig, delta, p)
        Ud = U + lam[:, None, None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-9))
        Vd = V + lam[:, None, None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1), min=1e-9))
        Vd = torch.where(pt_ok[..., None, None], Vd, eye3)
        Vinv = torch.linalg.inv_ex(Vd)[0]
        S, WV = _reduced(Ud, Vinv, Wc, p)
        rhs = (bc - p.ein("kwmil,kml->kwi", WV, bp)) * free_cam[:, None]
        dc = torch.linalg.solve_ex(_pin(S, W, n_fixed), rhs.reshape(K, 6 * W, 1))[0]
        dc = dc.reshape(K, W, 6) * free_cam[:, None]
        dX = p.ein("kmij,kmj->kmi", Vinv, bp - p.ein("kwmij,kwi->kmj", Wc, dc))
        dX = dX * pt_ok[..., None]
        dR = g.rodrigues(dc[..., :3])
        R_new = p.mm(dR, R)
        t_new = p.mm(dR, t[..., None])[..., 0] + dc[..., 3:]
        X_new = _clamp_depth(R_new, t_new, X + dX, depth_bounds(rig))
        c_new = cost(R_new, t_new, X_new, obs, mask, rig, delta, p)
        ok = torch.isfinite(c_new) & (c_new < c)
        last_rel = torch.where(ok, (c - c_new) / torch.clamp(c, min=1e-30), last_rel)
        R = torch.where(ok[:, None, None, None], R_new, R)
        t = torch.where(ok[:, None, None], t_new, t)
        X = torch.where(ok[:, None, None], X_new, X)
        c = torch.where(ok, c_new, c)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-12), torch.clamp(lam * 10.0, max=1e12))
    converged = (last_rel < 1e-6) | (lam >= 1e12)
    return R, t, X, c, converged


def camera_covariances(R, t, X, obs, mask, rig, n_fixed: int, delta: float,
                       p: Prec) -> torch.Tensor:
    """(K, W, 6, 6) covariances of each camera's [rotation vector,
    translation] (additive on the rotation vector, the port's camera
    parametrisation) from the inverse of the reduced camera system at the
    given state, with the port's stated conditioning: points damped by 1e-9,
    a relative Tikhonov term of 1e-6 of the mean |diagonal|, held cameras
    zero, the result symmetrised with its eigenvalues clipped to [0, 1e4]."""
    obs, mask = p.t(obs), p.t(mask)
    R, t, X = p.t(R), p.t(t), p.t(X)
    K, W = t.shape[:2]
    pt_ok = torch.sum(mask, -2) >= 2.0
    U, V, Wc, _, _, _ = _blocks(R, t, X, obs, mask, rig, delta, p)
    # the blocks are in the left perturbation (dR = exp(d) R); the
    # parametrisation w with R = exp(w) moves by d = J_l(w) dw
    Jl = left_jacobian(g.so3_log(R))  # (K, W, 3, 3)
    Tm = torch.zeros(K, W, 6, 6, dtype=p.dtype, device=t.device)
    Tm[..., :3, :3] = Jl
    # the left perturbation also turns t: dt_left = dt + [t]x J_l dw
    Tm[..., 3:, :3] = p.mm(g.skew(t), Jl)
    Tm[..., 3:, 3:] = torch.eye(3, dtype=p.dtype, device=t.device)
    U = p.mm(Tm.transpose(-1, -2), p.mm(U, Tm))
    Wc = p.ein("kwij,kwmil->kwmjl", Tm, Wc)
    eye3 = torch.eye(3, dtype=p.dtype, device=t.device)
    Vd = torch.where(pt_ok[..., None, None], V + 1e-9 * eye3, eye3)
    S, _ = _reduced(U, torch.linalg.inv_ex(Vd)[0], Wc, p)
    S = _pin(S, W, n_fixed)
    eps = 1e-6 * torch.clamp(torch.mean(torch.abs(torch.diagonal(S, dim1=-2, dim2=-1)), -1),
                             min=1.0)
    S = S + eps[:, None, None] * torch.eye(6 * W, dtype=p.dtype, device=t.device)
    Sinv = torch.linalg.inv_ex(S)[0].reshape(K, W, 6, W, 6)
    idx = torch.arange(W, device=t.device)
    cov = Sinv[:, idx, :, idx, :].permute(1, 0, 2, 3)  # (K, W, 6, 6)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    e, vec = torch.linalg.eigh(cov)
    cov = p.mm(vec * torch.clamp(e, 0.0, 1e4)[..., None, :], vec.transpose(-1, -2))
    free = (idx >= n_fixed).to(p.dtype)
    return cov * free[None, :, None, None]


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(w) of SO(3): exp(w + dw) = exp(J_l(w) dw) exp(w) to first order."""
    th2 = torch.sum(w * w, -1)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th * th * th))
    K = g.skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def motion_covariances(R, t, cam_cov, p: Prec) -> torch.Tensor:
    """(K, W-1, 6, 6) covariances of the step motions m_j = T_{j+1} T_j^-1
    on their [dt, dtheta] right tangent, to first order in each endpoint
    camera's [rotation vector, translation] (the cameras independent), by
    central differences."""
    R, t, cam_cov = p.t(R), p.t(t), p.t(cam_cov)
    K, W = t.shape[:2]
    cam = torch.cat([g.so3_log(R), t], -1)  # (K, W, 6)

    def motion(c0, c1):
        T0 = g.rigid(g.rodrigues(c0[..., :3]), c0[..., 3:])
        T1 = g.rigid(g.rodrigues(c1[..., :3]), c1[..., 3:])
        return p.mm(T1, g.rigid_inv(T0, p))

    c0, c1 = cam[:, :-1], cam[:, 1:]
    m0_inv = g.rigid_inv(motion(c0, c1), p)
    h = 1e-6 if p.dtype == torch.float64 else 1e-3
    cols0, cols1 = [], []
    for k in range(6):
        e = torch.zeros(6, dtype=p.dtype, device=t.device)
        e[k] = h

        def tangent(m):
            dM = p.mm(m0_inv, m)
            return torch.cat([dM[..., :3, 3], g.so3_log(dM[..., :3, :3])], -1)

        cols0.append((tangent(motion(c0 + e, c1)) - tangent(motion(c0 - e, c1))) / (2 * h))
        cols1.append((tangent(motion(c0, c1 + e)) - tangent(motion(c0, c1 - e))) / (2 * h))
    J0, J1 = torch.stack(cols0, -1), torch.stack(cols1, -1)  # (K, W-1, 6, 6)
    C0, C1 = cam_cov[:, :-1], cam_cov[:, 1:]
    return (p.mm(J0, p.mm(C0, J0.transpose(-1, -2)))
            + p.mm(J1, p.mm(C1, J1.transpose(-1, -2))))
