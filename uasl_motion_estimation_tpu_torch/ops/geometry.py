"""Projective geometry: the subset of ``uasl_motion_estimation_tpu/ops/geometry.py``
the ported paths need (homogeneous coordinates, pinhole intrinsics,
projection, rectified-stereo triangulation, relative scale) and its float64
numpy covariance transport. Points are ``(..., 2|3)`` tensors."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """(..., N) euclidean -> (..., N+1) homogeneous with last coord 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., N+1) homogeneous -> (..., N) euclidean; a last coordinate
    below ``eps`` in magnitude becomes +-eps (to_euclidean,
    feature_types.h:49-86)."""
    w = pts[..., -1:]
    w = torch.where(torch.abs(w) < eps, torch.where(w < 0, -eps, eps), w)
    return pts[..., :-1] / w


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (StereoVisualOdometry::parameters fu1..cv2,
    vo/StereoVisualOdometry.h:24-33), as Python floats."""

    fu: float
    fv: float
    cu: float
    cv: float


def project(pts3: torch.Tensor, intr: Intrinsics,
            baseline_shift: float = 0.0) -> torch.Tensor:
    """Camera-frame 3D points to pixels: u = fu*(x - b)/z + cu; ``b`` makes the
    right camera of a rectified pair (P2, StereoVisualOdometry.cpp:137)."""
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr.fu * (x - baseline_shift) / z + intr.cu
    v = intr.fv * y / z + intr.cv
    return torch.stack([u, v], dim=-1)


def triangulate_disparity(
    left_uv: torch.Tensor,
    right_uv: torch.Tensor,
    intr_left: Intrinsics,
    intr_right: Intrinsics,
    baseline: float,
    min_disparity: float = 1e-5,
) -> torch.Tensor:
    """Rectified-stereo triangulation (StereoVisualOdometry::project3D,
    cpp:22-32): d = (u_l - cu_l) - (u_r - cu_r), clamped to >= min_disparity;
    X = ((u_l - cu_l) B, (v_l - cv_l) B, fu_l B) / d."""
    du = (left_uv[..., 0] - intr_left.cu) - (right_uv[..., 0] - intr_right.cu)
    d = torch.where(du > 0, du, torch.full_like(du, min_disparity))
    x = (left_uv[..., 0] - intr_left.cu) * baseline / d
    y = (left_uv[..., 1] - intr_left.cv) * baseline / d
    z = intr_left.fu * baseline / d
    return torch.stack([x, y, z], dim=-1)


def relative_scale(pts_a: torch.Tensor, pts_b: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Median ratio of the distances between consecutive points of two
    (..., N, 3) point sets (pair i is points i and i-1, cyclically): the
    robust form of ``MonoVisualOdometry::findRelativeScale``
    (MonoVisualOdometry.cpp:76-87). With ``mask`` (..., N), a pair counts
    only where both its points are masked in, and no pair gives NaN. The
    median of an even count averages the two middle values, as
    ``jnp.(nan)median`` does (``torch.(nan)median`` would take the lower):
    a quantile at 0.5. Returns (...)."""
    da = torch.linalg.norm(pts_a - torch.roll(pts_a, 1, dims=-2), dim=-1)
    db = torch.linalg.norm(pts_b - torch.roll(pts_b, 1, dims=-2), dim=-1)
    ratio = da / torch.where(db < 1e-12, 1e-12, db)
    if mask is None:
        return torch.quantile(ratio, 0.5, dim=-1)
    pair = mask & torch.roll(mask, 1, dims=-1)
    return torch.nanquantile(torch.where(pair, ratio, torch.nan), 0.5, dim=-1)


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) covariance transport on the [dt, dtheta] right
# tangent (poseMultiplicationWithCovariance / invertPoseWithCovariance
# semantics, feature_types.cpp:172-241). The engines compose their pose
# chains on the host in float64, and these carry the covariance with them.
# ---------------------------------------------------------------------------


def se3_adjoint_np(T: np.ndarray) -> np.ndarray:
    """(4, 4) -> (6, 6) adjoint on the [dt, dtheta] right tangent:
    T exp(xi) = exp(Ad_T xi) T, with Ad = [[R, [t]x R], [0, R]]."""
    R = T[:3, :3]
    t = T[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                  dtype=np.float64)
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = tx @ R
    A[3:, 3:] = R
    return A


def compose_with_covariance_np(Ta: np.ndarray, Ca: np.ndarray, Tb: np.ndarray,
                               Cb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(Ta @ Tb, covariance) under independent right-tangent covariances:
    C = Ad(Tb^-1) Ca Ad(Tb^-1)^T + Cb."""
    J = se3_adjoint_np(np.linalg.inv(Tb))
    return Ta @ Tb, J @ Ca @ J.T + Cb


def invert_with_covariance_np(T: np.ndarray, C: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray]:
    """(T^-1, Ad(T) C Ad(T)^T)."""
    A = se3_adjoint_np(T)
    return np.linalg.inv(T), A @ C @ A.T
