"""Projective geometry: the subset of ``uasl_motion_estimation_tpu/ops/geometry.py``
the stereo-VO path needs (pinhole intrinsics, projection, rectified-stereo
triangulation). Points are ``(..., 2|3)`` tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
