"""Closed-form minimal pose solver for RANSAC seeds: the triad 3-point rigid
alignment of ``uasl_motion_estimation_tpu/ops/pnp.py``. Batched over leading
dims. (Grunert P3P and Umeyama are not ported yet.)"""

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
