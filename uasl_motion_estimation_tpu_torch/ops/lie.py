"""Rotation algebra: port of ``uasl_motion_estimation_tpu/ops/lie.py``
(Euler angles and their derivatives, skew, quaternions ``[w, x, y, z]``,
the SO(3) exp/log maps and right Jacobian, and the XYZ/OpenCV frame
conversions).

Conventions are the reference's: ``(roll, pitch, yaw)`` about (x, y, z) and
``R = Rx(roll) @ Ry(pitch) @ Rz(yaw)`` in the row convention of
``Euler<T>::getR3`` (rotation_utils.cpp:25-33). Every function is batched
over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x with [v]_x @ u = v x u: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _trig(rpy: torch.Tensor):
    return (torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0]),
            torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1]),
            torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2]))


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_to_R(rpy: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) (..., 3) -> (..., 3, 3) DCM (Euler::getR3)."""
    cr, sr, cp, sp, cy, sy = _trig(rpy)
    return _mat([
        [cp * cy, cp * sy, -sp],
        [sp * sr * cy - cr * sy, sr * sp * sy + cr * cy, cp * sr],
        [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cp * cr],
    ])


def euler_dR(rpy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic (dR/droll, dR/dpitch, dR/dyaw) (Euler::getdRdr/p/y,
    rotation_utils.cpp:58-91)."""
    cr, sr, cp, sp, cy, sy = _trig(rpy)
    zeros = torch.zeros_like(cr)
    dRdr = _mat([
        [zeros, zeros, zeros],
        [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp],
        [-sr * sp * cy + cr * sy, -sr * sp * sy - cr * cy, -sr * cp],
    ])
    dRdp = _mat([
        [-cy * sp, -sy * sp, -cp],
        [sr * cp * cy, sr * cp * sy, -sr * sp],
        [cr * cp * cy, cr * cp * sy, -cr * sp],
    ])
    dRdy = _mat([
        [-cp * sy, cp * cy, zeros],
        [-sr * sp * sy - cr * cy, sr * sp * cy - cr * sy, zeros],
        [-cr * sp * sy + sr * cy, cr * sp * cy + sr * sy, zeros],
    ])
    return dRdr, dRdp, dRdy


def R_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of euler_to_R (Euler::fromMat, rotation_utils.cpp:94-152)."""
    roll = torch.atan2(R[..., 1, 2], R[..., 2, 2])
    pitch = -torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    yaw = torch.atan2(R[..., 0, 1], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (Quat::conj, rotation_utils.h)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (q1 applied after q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> the standard rotation matrix (Quat::getR3,
    rotation_utils.h:232-238): ``quat_to_R(euler_to_quat(e)) ==
    euler_to_R(e).T``."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    return _mat([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def euler_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """Euler -> quaternion (Euler::getQuat, rotation_utils.cpp:155-165)."""
    half = rpy * 0.5
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quat::getEuler (rotation_utils.cpp:249-253): euler_to_R is the
    transpose of the standard matrix."""
    return R_to_euler(quat_to_R(q).transpose(-1, -2))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """quat_to_R(q) @ v."""
    return torch.matmul(quat_to_R(q), v[..., None])[..., 0]


def _safe_sqrt(x2: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """sqrt with the argument itself replaced by 1 where ``small``, so no
    NaN tangent leaks through a later ``where`` (autodiff-safe at 0)."""
    return torch.sqrt(torch.where(small, torch.ones_like(x2), x2))


def _sinc_half(theta2: torch.Tensor) -> torch.Tensor:
    """sin(t/2)/t with a series below t^2 = 1e-8 (t = sqrt(theta2))."""
    small = theta2 < _EPS
    safe = _safe_sqrt(theta2, small)
    return torch.where(small, 0.5 - theta2 / 48.0, torch.sin(safe * 0.5) / safe)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> quaternion (exp_map_Quat)."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < _EPS
    theta = _safe_sqrt(theta2, small)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(theta * 0.5))
    return torch.cat([w[..., None], v * _sinc_half(theta2)[..., None]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z) with
    w >= 0, branch-free: the trace method's four candidates, the one with
    the largest pivot kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)  # first maximum, as jnp.argmax
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., branch, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (log_map_Quat), shortest arc, with
    a series for the small angle."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1)
    small = vn2 < _EPS
    vn = _safe_sqrt(vn2, small)
    theta = 2.0 * torch.atan2(vn, w)
    # small angle: theta/vn -> 2/w * (1 - vn2/(3 w^2)), exact to O(vn2^2)
    scale = torch.where(small, 2.0 / w * (1.0 - vn2 / (3.0 * w * w)), theta / vn)
    return q[..., 1:] * scale[..., None]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: (..., 3, 3) rotation -> (..., 3) rotation vector (log_map_Mat)."""
    return quat_log(R_to_quat(R))


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (..., 3) -> (..., 3, 3) (exp_map_Mat,
    rotation_utils.h:191-218), with the JAX version's Taylor branch below
    theta^2 = 1e-8."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < _EPS
    safe_t = _safe_sqrt(theta2, small)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    K = skew(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_right_jacobian(v: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(v) of SO(3): exp(v + dv) ~ exp(v) exp(J_r dv)."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < _EPS
    safe_t = _safe_sqrt(theta2, small)
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe_t - torch.sin(safe_t)) / safe_t ** 3)
    K = skew(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye - A[..., None, None] * K + B[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# Reference-frame conversion (rotation_utils.h:19, rotation_utils.cpp:321-354)
# ---------------------------------------------------------------------------

# TREF maps the XYZ convention (x forward, y left, z up) to the OpenCV camera
# convention (x right, y down, z forward)
TREF = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def _tref(like: torch.Tensor) -> torch.Tensor:
    return const(TREF.tolist(), like.dtype, like.device)


def xyz_to_opencv(v: torch.Tensor) -> torch.Tensor:
    """A 3-vector (or rpy triple) from XYZ to OpenCV axes (convertToOpenCV,
    rotation_utils.cpp:321-326, 347-350)."""
    return v @ _tref(v).T


def opencv_to_xyz(v: torch.Tensor) -> torch.Tensor:
    """Inverse of xyz_to_opencv (convertToXYZ, rotation_utils.cpp:329-333)."""
    return v @ _tref(v)


def quat_xyz_to_opencv(q: torch.Tensor) -> torch.Tensor:
    """q -> q_TREF * q (convertToOpenCV for Quat, rotation_utils.cpp:336-340)."""
    return quat_mul(R_to_quat(_tref(q)), q)


def quat_opencv_to_xyz(q: torch.Tensor) -> torch.Tensor:
    """q -> conj(q_TREF) * q (convertToXYZ for Quat, rotation_utils.cpp:342-345)."""
    return quat_mul(quat_conj(R_to_quat(_tref(q))), q)
