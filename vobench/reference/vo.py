"""Plain reference of the stereo pose solve and the pose chain.

A step's motion maps previous-frame camera points into the current frame,
X_cur = R X_prev + t. Given a step's quad matches [prev left, prev right,
cur left, cur right] and the matches to use, the reference triangulates the
previous pair and minimises the mean squared 4-residual reprojection error
in the current pair (the cost the port's stereo VO refines) by
Levenberg-Marquardt from a given start, in its own parametrisation (a left
perturbation of the transformed point).
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as g
from .prec import Prec


def triangulate(left: torch.Tensor, right: torch.Tensor, rig, p: Prec) -> torch.Tensor:
    """Rectified-stereo points (..., 3) from left/right pixels (..., 2):
    disparity d = u_l - u_r (1e-5 where not positive), X = ((u_l - cu) B,
    (v_l - cv) B, fu B) / d."""
    left, right = p.t(left), p.t(right)
    d = left[..., 0] - right[..., 0]
    d = torch.where(d > 0, d, torch.full_like(d, 1e-5))
    b = rig.baseline
    return torch.stack([(left[..., 0] - rig.cu) * b / d, (left[..., 1] - rig.cv) * b / d,
                        rig.fu * b / d], -1)


def predict(Xc: torch.Tensor, rig) -> torch.Tensor:
    """(..., 4) [u_l, v_l, u_r, v_r] of camera-frame points (..., 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = rig.fu * x / z + rig.cu
    v = rig.fv * y / z + rig.cv
    return torch.stack([u, v, rig.fu * (x - rig.baseline) / z + rig.cu, v], -1)


def d_predict(Xc: torch.Tensor, rig) -> torch.Tensor:
    """d predict / d Xc, (..., 4, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    zero = torch.zeros_like(z)
    ru = torch.stack([rig.fu / z, zero, -rig.fu * x / (z * z)], -1)
    rv = torch.stack([zero, rig.fv / z, -rig.fv * y / (z * z)], -1)
    rr = torch.stack([rig.fu / z, zero, -rig.fu * (x - rig.baseline) / (z * z)], -1)
    return torch.stack([ru, rv, rr, rv], -2)


def solve_motion(quads: torch.Tensor, use: torch.Tensor, rig, p: Prec,
                 init: torch.Tensor | None = None, iters: int = 30):
    """Least-squares motions of a batch of steps.

    ``quads`` (B, N, 4, 2) pixels, ``use`` (B, N) bool: the matches that
    enter; ``init`` (B, 4, 4) the start (the identity by default). Returns
    (motion (B, 4, 4), mean squared residual (B,)) in ``p.dtype``."""
    quads = p.t(quads)
    w = use.to(p.dtype)
    X = triangulate(quads[..., 0, :], quads[..., 1, :], rig, p)
    obs = torch.cat([quads[..., 2, :], quads[..., 3, :]], -1)  # (B, N, 4)
    B = quads.shape[0]
    if init is None:
        init = torch.eye(4, dtype=p.dtype, device=quads.device).repeat(B, 1, 1)
    init = p.t(init).to(quads.device)
    R, t = init[:, :3, :3], init[:, :3, 3]
    lam = torch.full((B,), 1e-3, dtype=p.dtype, device=quads.device)
    n = torch.clamp(4.0 * w.sum(-1), min=1.0)

    def cost_of(R, t):
        Xc = p.mm(X, R.transpose(-1, -2)) + t[:, None]
        r = obs - predict(Xc, rig)
        return torch.sum(r * r * w[..., None], (-2, -1)) / n, r, Xc

    cost, r, Xc = cost_of(R, t)
    eye6 = torch.eye(6, dtype=p.dtype, device=quads.device)
    for _ in range(iters):
        Jx = d_predict(Xc, rig)  # (B, N, 4, 3)
        J = torch.cat([p.mm(Jx, -g.skew(Xc)), Jx], -1)  # (B, N, 4, 6)
        H = p.ein("bnri,bnrj->bij", J * w[..., None, None], J)
        b = p.ein("bnri,bnr->bi", J, r * w[..., None])
        Hd = H + lam[:, None, None] * eye6 * torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                                          min=1e-9)[:, None, :]
        dx = torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
        dR = g.rodrigues(dx[:, :3])
        R_new = p.mm(dR, R)
        t_new = p.mm(dR, t[..., None])[..., 0] + dx[:, 3:]
        c_new, r_new, Xc_new = cost_of(R_new, t_new)
        ok = torch.isfinite(c_new) & (c_new < cost)
        R = torch.where(ok[:, None, None], R_new, R)
        t = torch.where(ok[:, None], t_new, t)
        r = torch.where(ok[:, None, None], r_new, r)
        Xc = torch.where(ok[:, None, None], Xc_new, Xc)
        cost = torch.where(ok, c_new, cost)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-12), torch.clamp(lam * 10.0, max=1e12))
    return g.rigid(R, t), cost


def chain(motions: torch.Tensor, success: torch.Tensor, p: Prec) -> torch.Tensor:
    """Cam-to-world poses (B + 1, 4, 4) of a chain from the identity:
    pose_{i+1} = pose_i motion_i^-1 where step i succeeded, else pose_i."""
    motions = p.t(motions)
    pose = torch.eye(4, dtype=p.dtype, device=motions.device)
    out = [pose]
    for m, ok in zip(motions, success.tolist()):
        if ok:
            pose = p.mm(pose, torch.linalg.inv(m))
        out.append(pose)
    return torch.stack(out)


def truth_motions(poses_c2w: np.ndarray) -> torch.Tensor:
    """True step motions (B, 4, 4) float64: inv(T_{i+1}) T_i."""
    T = torch.as_tensor(poses_c2w, dtype=torch.float64)
    return torch.linalg.inv(T[1:]) @ T[:-1]


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of positions after the least-squares rigid alignment (Umeyama)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    est = (R @ est.T).T + mu_g - R @ mu_e
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
