"""Covariance-weighted trajectory stitching for overlapping segments.

Port of ``uasl_motion_estimation_tpu/parallel/stitching.py``. A long
sequence is split into segments with a few shared frames; each segment's
trajectory lives in its own frame-0 gauge, and the shared frames give the
SE(3) transform that aligns each segment into its predecessor's frame.
Per overlap frame k the candidate alignment is A_k = T_prev_k (T_next_k)^-1;
the candidates are fused by a weighted mean in the se(3) tangent at the
first one, with weights from pose covariances where there are any. The
alignments compose by a prefix product (``prefix_products``, where JAX has
``lax.associative_scan``).

``chain_covariances_np`` and ``overlap_weights_np`` are host-side numpy in
float64, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from ..ops.geometry import compose_with_covariance_np, invert_with_covariance_np


def prefix_products(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along dim 0 of (B, n, n) matrices, earlier
    @ later: out[i] = x[0] @ ... @ x[i]. A log-depth doubling scan: ceil(log2
    B) batched products instead of a loop over B."""
    out = x
    d = 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], torch.matmul(out[:-d], out[d:])])
        d *= 2
    return out


def _se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, theta] (translation first, the
    covariance ordering of ops/geometry.py)."""
    return torch.cat([T[..., :3, 3], lie.so3_log(T[..., :3, :3])], dim=-1)


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    top = torch.cat([lie.so3_exp(xi[..., 3:6]), xi[..., 0:3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def align_overlap(poses_prev: torch.Tensor, poses_next: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """SE(3) alignment A with poses_prev[k] ~= A @ poses_next[k].

    ``poses_prev``, ``poses_next`` (..., K, 4, 4): the overlap frames in the
    previous and in the next segment's frame; ``weights`` (..., K)
    confidence weights (e.g. 1/trace(cov)), uniform when None. Returns
    (..., 4, 4): the tangent-space weighted mean around the first candidate
    (exact when the candidates agree; first order otherwise)."""
    cand = torch.matmul(poses_prev, torch.linalg.inv(poses_next))
    base = cand[..., 0, :, :]
    delta = _se3_log(torch.matmul(torch.linalg.inv(base)[..., None, :, :], cand))  # (..., K, 6)
    if weights is None:
        weights = torch.ones(cand.shape[:-2], dtype=cand.dtype, device=cand.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    mean = torch.sum(w[..., None] * delta, dim=-2)
    return torch.matmul(base, _se3_exp(mean))


def weights_from_covariances(covs: torch.Tensor) -> torch.Tensor:
    """(K, 6, 6) pose covariances -> (K,) inverse-trace confidence weights."""
    return 1.0 / torch.clamp(torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1), min=1e-12)


def chain_covariances_np(motions, motion_covs) -> np.ndarray:
    """Pose covariance along the chain traj[i+1] = traj[i] @ inv(m_i).

    ``motions`` (B, 4, 4) frame-to-frame, ``motion_covs`` (B, 6, 6)
    per-motion [dt, dtheta]-tangent covariances. Returns (B + 1, 6, 6):
    traj[0] is the gauge anchor with zero covariance."""
    b = len(motions)
    out = np.zeros((b + 1, 6, 6))
    T = np.eye(4)
    C = np.zeros((6, 6))
    for i in range(b):
        inv_m, C_inv = invert_with_covariance_np(np.asarray(motions[i], np.float64),
                                                 np.asarray(motion_covs[i], np.float64))
        T, C = compose_with_covariance_np(T, C, inv_m, C_inv)
        out[i + 1] = C
    return out


def overlap_weights_np(cov_prev, cov_next) -> np.ndarray:
    """(K, 6, 6) x2 -> (K,) weights combining both sides' overlap-frame
    uncertainties: w_k = 1 / (tr(C_prev_k) + tr(C_next_k))."""
    tr = (np.trace(np.asarray(cov_prev), axis1=-2, axis2=-1)
          + np.trace(np.asarray(cov_next), axis1=-2, axis2=-1))
    return 1.0 / np.maximum(tr, 1e-12)


def stitch_segments(segment_poses: torch.Tensor, overlap: int,
                    overlap_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Stitch S overlapping segment trajectories into one.

    ``segment_poses`` (S, F, 4, 4): cam-to-world poses per segment, each in
    its own frame-0 gauge; segment s+1's first ``overlap`` frames are
    segment s's last ``overlap``. ``overlap_weights`` (S-1, overlap)
    optional confidence weights. Returns (S * (F - overlap) + overlap, 4, 4)
    poses in segment 0's frame."""
    f = segment_poses.shape[1]
    aligns = align_overlap(segment_poses[:-1, f - overlap:], segment_poses[1:, :overlap],
                           overlap_weights)  # (S-1, 4, 4)
    # segment k's gauge transform = A_0 @ ... @ A_{k-1}
    eye = torch.eye(4, dtype=segment_poses.dtype, device=segment_poses.device)[None]
    gauges = torch.cat([eye, prefix_products(aligns)])
    aligned = torch.matmul(gauges[:, None], segment_poses)
    # drop the duplicated overlap frames of every segment after the first
    return torch.cat([aligned[0], aligned[1:, overlap:].reshape(-1, 4, 4)])
