"""Plain reference of the integrated engine's host-side stages: each
window's BA start from its track table and VO motions, and the
composition of the windows' motions into trajectories.

What the port's ``models/smoother.py`` states, written out again: a window
of W frames is posed in its first frame (camera 0 the identity, camera j
the chain of the window's step motions), its points are triangulated from
the first frame's stereo pair, and a track enters BA when it is seen in the
first frame, in at least ``min_obs`` frames, and its worst residual
component against that start stays within ``gate_px``. Each step takes the
VO motion of the covering window with the best (success, inliers), and the
refined motion of the covering window with the most gated support at both
ends (at least ``min_frame_obs``) whose refinement lies within
``install_px`` (pixels at 15 m) of that window's own VO motion.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as g
from .prec import Prec
from .vo import predict, triangulate


def window_start(motions: torch.Tensor, obs: torch.Tensor, mask: torch.Tensor, rig,
                 min_obs: int, gate_px: float, p: Prec):
    """BA start of windows: (R (K, W, 3, 3), t (K, W, 3), points (K, M, 3),
    gated mask (K, W, M), worst residual of each track (K, M)).

    ``motions`` (K, W-1, 4, 4) window step motions (failed ones the
    identity), ``obs`` (K, W, M, 4) [ul, vl, ur, vr], ``mask`` (K, W, M)."""
    motions, obs = p.t(motions), p.t(obs)
    K, W = obs.shape[:2]
    T = torch.eye(4, dtype=p.dtype, device=obs.device).expand(K, 4, 4)
    Ts = [T]
    for j in range(1, W):
        T = p.mm(motions[:, j - 1], T)
        Ts.append(T)
    T = torch.stack(Ts, 1)
    R, t = T[..., :3, :3], T[..., :3, 3]
    X = triangulate(obs[:, 0, :, 0:2], obs[:, 0, :, 2:4], rig, p)
    Xc = p.ein("kwij,kmj->kwmi", R, X) + t[:, :, None, :]
    err = torch.amax(torch.abs(obs - predict(Xc, rig)), -1)
    worst = torch.amax(torch.where(mask, err, torch.zeros_like(err)), -2)
    keep = mask[:, 0] & (torch.sum(mask, -2) >= min_obs) & (worst <= gate_px)
    return R, t, X, mask & keep[:, None, :], worst


def compose(vo_motions, vo_success, vo_inliers, refined, frame_obs, starts, n_frames: int,
            fu: float, min_frame_obs: int, install_px: float, p: Prec):
    """(trajectory from the VO motions, trajectory with the refinements
    installed), cam-to-world (n_frames, 4, 4), from the windows' outputs
    (numpy: (K, W-1, 4, 4) motions, (K, W-1) flags and inlier counts,
    (K, W) gated observations per frame) and window ``starts``."""
    b = n_frames - 1
    K, Wm1 = vo_success.shape
    vo_m = np.asarray(vo_motions, np.float64)
    ref = np.asarray(refined, np.float64)
    motions = np.tile(np.eye(4), (b, 1, 1))
    best = [(-1, -1)] * b
    cands: dict[int, list] = {}
    for i, s in enumerate(starts):
        for j in range(Wm1):
            m = int(s) + j
            if m >= b:
                continue
            key = (int(vo_success[i, j]), int(vo_inliers[i, j]))
            if key > best[m]:
                best[m] = key
                motions[m] = vo_m[i, j]
            support = int(min(frame_obs[i, j], frame_obs[i, j + 1]))
            if support >= min_frame_obs:
                cands.setdefault(m, []).append((support, ref[i, j], vo_m[i, j]))
    motions_ba = motions.copy()
    for m, cs in cands.items():
        for _, r, v in sorted(cs, key=lambda c: -c[0]):
            gap = float(g.pose_gap_px(torch.from_numpy(r), torch.from_numpy(v), fu))
            if gap <= install_px:
                motions_ba[m] = r
                break

    def chain(ms):
        ms = p.t(torch.from_numpy(ms))
        out = [torch.eye(4, dtype=p.dtype)]
        for m in ms:
            out.append(p.mm(out[-1], torch.linalg.inv(m)))
        return torch.stack(out).double().numpy()

    return chain(motions), chain(motions_ba)
