"""Projective geometry: port of ``uasl_motion_estimation_tpu/ops/geometry.py``
(homogeneous coordinates, pinhole intrinsics, projection, rectified-stereo
triangulation, relative scale, rigid poses with first-order covariance
propagation) and its float64 numpy covariance transport. Points are
``(..., 2|3)`` tensors."""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import lie


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
# Poses
# ---------------------------------------------------------------------------


class Pose(NamedTuple):
    """Rigid transform T(x) = R(q) x + t with an optional 6x6 covariance on
    the [translation(3), rotation(3)] tangent (the reference's pose
    covariance Jacobians, feature_types.cpp:83-95)."""

    q: torch.Tensor  # (..., 4) quaternion [w, x, y, z]
    t: torch.Tensor  # (..., 3)
    cov: torch.Tensor | None = None  # (..., 6, 6) or None

    @property
    def R(self) -> torch.Tensor:
        return lie.quat_to_R(self.q)

    def matrix(self) -> torch.Tensor:
        """4x4 homogeneous transform (CamPose::TrMat, feature_types.cpp:32-42)."""
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform (..., N, 3) euclidean points."""
        return torch.matmul(pts, self.R.transpose(-1, -2)) + self.t[..., None, :]

    def compose(self, other: "Pose") -> "Pose":
        """self * other: ``other`` applied first (CamPose::operator*)."""
        return Pose(q=lie.quat_normalize(lie.quat_mul(self.q, other.q)),
                    t=lie.quat_rotate(self.q, other.t) + self.t)

    def inverse(self) -> "Pose":
        """T^-1 (CamPose::inv, feature_types.cpp:61-69)."""
        qc = lie.quat_conj(self.q)
        return Pose(q=qc, t=-lie.quat_rotate(qc, self.t))


def pose_identity(dtype=torch.float32, device=None) -> Pose:
    return Pose(q=lie.quat_identity(dtype, device), t=torch.zeros(3, dtype=dtype, device=device))


def pose_from_matrix(T: torch.Tensor) -> Pose:
    return Pose(q=lie.R_to_quat(T[..., :3, :3]), t=T[..., :3, 3])


def _perturb(p: Pose, xi: torch.Tensor) -> Pose:
    """Right perturbation by (..., 6) [dt, dtheta], the tangent used for
    covariances."""
    return Pose(q=lie.quat_normalize(lie.quat_mul(p.q, lie.quat_exp(xi[..., 3:6]))),
                t=p.t + lie.quat_rotate(p.q, xi[..., 0:3]))


def _local_delta(out: Pose, res_q: torch.Tensor, res_t: torch.Tensor) -> torch.Tensor:
    """(..., 6) [dt, dtheta] of (res_q, res_t) in the local tangent of ``out``."""
    qc = lie.quat_conj(out.q)
    dtheta = lie.quat_log(lie.quat_mul(qc, res_q))
    return torch.cat([lie.quat_rotate(qc, res_t - out.t), dtheta], dim=-1)


def _tangent_jacobians(f: Callable[..., Pose], *poses: Pose
                       ) -> tuple[Pose, list[torch.Tensor]]:
    """Jacobians of the pose-valued f(*poses) with respect to each pose's
    local tangent, J_i = d log(f(.. p_i exp(xi) ..)) / d xi at xi = 0 in the
    output's local tangent (the reference's hand-coded getG/getH blocks,
    feature_types.cpp:83-169, by forward-mode autodiff as ``jax.jacfwd``)."""
    out = f(*poses)

    def local_delta(xi_all: torch.Tensor) -> torch.Tensor:
        # differentiated with a leading dim of 1: under torch.func, a
        # torch.where over 0-d operands can promote its tangent to float64
        xi = xi_all[None]
        res = f(*(_perturb(p, xi[:, 6 * i:6 * i + 6]) for i, p in enumerate(poses)))
        return _local_delta(out, res.q, res.t)[0]

    xi0 = torch.zeros(6 * len(poses), dtype=out.t.dtype, device=out.t.device)
    J = torch.func.jacfwd(local_delta)(xi0)  # (6, 6 * len(poses))
    return out, [J[:, 6 * i:6 * i + 6] for i in range(len(poses))]


def compose_with_covariance(p1: Pose, p2: Pose) -> Pose:
    """p1 * p2 with first-order covariance propagation
    (poseMultiplicationWithCovariance, feature_types.cpp:172-193).
    Needs p1.cov and p2.cov."""
    out, (J1, J2) = _tangent_jacobians(lambda a, b: a.compose(b), p1, p2)
    return Pose(out.q, out.t, J1 @ p1.cov @ J1.T + J2 @ p2.cov @ J2.T)


def invert_with_covariance(p: Pose) -> Pose:
    """Pose inverse with covariance (invertPoseWithCovariance,
    feature_types.cpp:225-241)."""
    out, (J,) = _tangent_jacobians(lambda a: a.inverse(), p)
    return Pose(out.q, out.t, J @ p.cov @ J.T)


def scale_pose_with_covariance(p: Pose, scale, scale_var) -> Pose:
    """Translation scaled by ``scale`` (variance ``scale_var``), covariance
    propagated through the augmented 7x7 covariance with J = [[s I, 0, t],
    [0, I, 0]] (ScalePoseWithCovariance, feature_types.cpp:244-251)."""
    out = Pose(p.q, p.t * scale)

    def local_delta(xi_s: torch.Tensor) -> torch.Tensor:
        xi = xi_s[None]  # a leading dim of 1, as in _tangent_jacobians
        pp = _perturb(p, xi[:, :6])
        return _local_delta(out, pp.q, pp.t * (scale + xi[:, 6:]))[0]

    J = torch.func.jacfwd(local_delta)(torch.zeros(7, dtype=p.t.dtype, device=p.t.device))
    aug = torch.zeros(7, 7, dtype=p.t.dtype, device=p.t.device)
    aug[:6, :6] = p.cov
    aug[6, 6] = scale_var
    return Pose(out.q, out.t, J @ aug @ J.T)


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
