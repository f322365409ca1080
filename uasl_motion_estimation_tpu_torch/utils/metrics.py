"""Trajectory evaluation (ATE/RPE) and structured per-frame metrics.

The reference has no quantitative evaluation (SURVEY.md section 6); these are
the standard KITTI/TUM-style metrics the BASELINE.json targets are defined in,
plus a JSONL metrics emitter replacing the reference's ad-hoc cout/CSV logging
(file_IO.h:214-222, optimisation.cpp:42-45).
"""

from __future__ import annotations

import json
import time
from typing import IO

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False
                      ) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (optionally similarity) alignment est -> gt.

    Returns (R, t, s) minimizing ||gt - (s R est + t)||^2.
    """
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max(e.var(0).sum(), 1e-12)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of position residuals)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
        ) -> tuple[float, float]:
    """Relative pose error over ``delta``-frame steps.

    Args: (N, 4, 4) cam-to-world pose arrays.
    Returns (translational RMSE [m/step], rotational RMSE [rad/step]).
    """
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        cos = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )


class MetricsLogger:
    """Per-frame JSONL metrics (inliers, reprojection error, track count, fps),
    replacing the reference's cout/cerr + log-file observability."""

    def __init__(self, stream: IO | None = None, path: str | None = None,
                 keep: bool = True):
        self._own = None
        if path is not None:
            self._own = open(path, "a")
        self.stream = stream or self._own
        self._t0 = time.perf_counter()
        # in-memory record list (keep=False for unbounded runs)
        self.records: list[dict] = []
        self._keep = keep

    def log(self, **fields) -> dict:
        rec = {"t": round(time.perf_counter() - self._t0, 6), **fields}
        if self.stream is not None:
            self.stream.write(json.dumps(rec) + "\n")
        if self._keep:
            self.records.append(rec)
        return rec

    def close(self):
        if self._own is not None:
            self._own.close()
