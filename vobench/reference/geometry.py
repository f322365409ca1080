"""Rotations, rigid motions and their gaps, in plain PyTorch."""

from __future__ import annotations

import torch

from .prec import Prec


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    th2 = torch.sum(w * w, -1)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), for angles
    below pi - 1e-3 (all that occur here)."""
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    th = torch.arccos(c)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-6
    s = torch.where(small, torch.ones_like(th), torch.sin(th))
    f = torch.where(small, 0.5 + th * th / 12.0, th / (2.0 * s))
    return f[..., None] * v


def rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from R (..., 3, 3) and t (..., 3)."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def rigid_inv(T: torch.Tensor, p: Prec) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rigid(Rt, -p.mm(Rt, T[..., :3, 3:4])[..., 0])


def angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 3, 3), float64."""
    R = R.to(torch.float64)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    s = 0.5 * torch.linalg.norm(torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                                             R[..., 1, 0] - R[..., 0, 1]], -1), dim=-1)
    return torch.atan2(s, c)


def pose_gap_px(A: torch.Tensor, B: torch.Tensor, fu: float, depth: float = 15.0) -> torch.Tensor:
    """Gap between rigid transforms (..., 4, 4) as the pixels it moves a
    point ``depth`` metres ahead: fu * (|t_A - t_B| / depth + angle(R_A^T R_B)),
    float64 (the install policy's measure in ``models/smoother.py``)."""
    A, B = A.to(torch.float64), B.to(torch.float64)
    dt = torch.linalg.norm(A[..., :3, 3] - B[..., :3, 3], dim=-1)
    return fu * (dt / depth + angle(A[..., :3, :3].transpose(-1, -2) @ B[..., :3, :3]))


def cast(planes, T_c2w: torch.Tensor, uv: torch.Tensor, rig, p: Prec) -> torch.Tensor:
    """World points (F, N, 3) seen at pixels ``uv`` (F, N, 2) by cameras
    ``T_c2w`` (F, 4, 4): the nearest hit beyond 0.5 of the ray with the
    planes ``planes`` = (points (P, 3), normals (P, 3)); NaN where none."""
    uv = p.t(uv)
    d = torch.stack([(uv[..., 0] - rig.cu) / rig.fu, (uv[..., 1] - rig.cv) / rig.fv,
                     torch.ones_like(uv[..., 0])], -1)
    T = p.t(T_c2w)
    d_world = p.mm(d, T[:, :3, :3].transpose(-1, -2))
    c = T[:, None, :3, 3]
    best = torch.full(d_world.shape[:-1], torch.inf, dtype=p.dtype, device=uv.device)
    for p0, n in zip(p.t(planes[0]), p.t(planes[1])):
        denom = p.mm(d_world, n[:, None])[..., 0]
        t = p.mm(p0 - c, n[:, None])[..., 0] / denom
        hit = (t > 0.5) & (t < best) & (torch.abs(denom) > 1e-9)
        best = torch.where(hit, t, best)
    X = c + best[..., None] * d_world
    return torch.where(torch.isfinite(best)[..., None], X, torch.full_like(X, torch.nan))


def project(T_c2w: torch.Tensor, X: torch.Tensor, rig, p: Prec, right: bool = False) -> torch.Tensor:
    """Pixels (F, N, 2) of world points X (F, N, 3) in the left (or, with
    ``right``, the right) camera of the rig at ``T_c2w`` (F, 4, 4), through
    the homogeneous world-to-camera transform."""
    T = p.t(T_c2w)
    Rt = T[:, :3, :3].transpose(-1, -2)
    t = -p.mm(Rt, T[:, :3, 3:4])
    if right:
        t = t - torch.tensor([[rig.baseline], [0.0], [0.0]], dtype=t.dtype, device=t.device)
    w2c = torch.cat([Rt, t], -1)  # (F, 3, 4)
    X = p.t(X)
    pc = p.mm(torch.cat([X, torch.ones_like(X[..., :1])], -1), w2c.transpose(-1, -2))
    return torch.stack([rig.fu * pc[..., 0] / pc[..., 2] + rig.cu,
                        rig.fv * pc[..., 1] / pc[..., 2] + rig.cv], -1)
