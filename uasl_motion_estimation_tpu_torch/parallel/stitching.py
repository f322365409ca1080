"""Host-side stitching helpers: the part of
``uasl_motion_estimation_tpu/parallel/stitching.py`` the unified engine
needs, ``chain_covariances_np`` (plain numpy, float64)."""

from __future__ import annotations

import numpy as np

from ..ops.geometry import compose_with_covariance_np, invert_with_covariance_np


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
