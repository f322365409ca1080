"""Rotation algebra: the subset of ``uasl_motion_estimation_tpu/ops/lie.py``
the ported paths need (Euler angles, their derivatives, skew, so3_exp).

Conventions are the reference's: ``(roll, pitch, yaw)`` about (x, y, z) and
``R = Rx(roll) @ Ry(pitch) @ Rz(yaw)`` in the row convention of
``Euler<T>::getR3`` (rotation_utils.cpp:25-33). Every function is batched
over leading dimensions.
"""

from __future__ import annotations

import torch

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


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (..., 3) -> (..., 3, 3) (exp_map_Mat,
    rotation_utils.h:191-218), with the JAX version's Taylor branch below
    theta^2 = 1e-8."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < _EPS
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    K = skew(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)
