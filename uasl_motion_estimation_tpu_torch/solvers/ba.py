"""Windowed bundle adjustment: batched Levenberg-Marquardt with a dense
Schur complement over the landmarks.

Port of ``uasl_motion_estimation_tpu/solvers/ba.py`` (the reference's
Ceres-based ``BundleAdjuster<M>``, BundleAdjuster.h:183-528): a fixed-shape
(window, track) observation table, the stereo 4-residual or mono 2-residual
reprojection error, Huber(1.0) as IRLS weights, per-frame 6x6 and per-point
3x3 normal-equation blocks, landmarks eliminated in parallel, the dense
(6W, 6W) reduced camera system solved with the first ``n_fixed`` frames
pinned, and first-frame depths clamped after each step.

Every function takes problems batched over leading dims: ``cam`` (..., W, 6),
``pts`` (..., M, 3), ``obs`` (..., W, M, R), ``mask`` (..., W, M). Where JAX
``vmap``s a ``while_loop`` over windows, ``ba_solve`` is a batched masked
loop: a window that has converged keeps its state, damping and iteration
count from then on, so a batched solve equals each window's solo solve. The
loop reads one flag back from the device per iteration to leave early.

The Jacobians are analytic: the derivative of the projection, and that of
``so3_exp``'s own formula in both of its branches (what ``jax.jacfwd``
pushes through the JAX version), so the tangent at the zero rotation, the
first camera of every window, is finite. Products run in full float32
(``device.setup_device`` turns TF32 off), as JAX's ``precision="highest"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import geometry as geo
from ..ops import lie
from ..utils import profiling
from .lm import _sel


class BAConfig(NamedTuple):
    """Same fields and defaults as the JAX BAConfig."""

    intr: geo.Intrinsics
    baseline: float = 0.0  # 0 -> mono (2 residuals); >0 -> stereo (4 residuals)
    huber_delta: float = 1.0  # HuberLoss(1.0), BundleAdjuster.h:447
    max_iter: int = 50
    n_fixed: int = 2  # fixed first frames (gauge)
    lambda0: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e6
    ftol: float = 1e-3  # function_tolerance (h:418)
    zmin_frac: float = 0.0  # zmin = zmin_frac * fu * baseline
    zmax_depth: float = 0.0  # 0 -> fu*baseline/0.1 when stereo (h:442)


class BAProblem(NamedTuple):
    cam: torch.Tensor  # (..., W, 6) [angle-axis(3), translation(3)], world->cam
    pts: torch.Tensor  # (..., M, 3) world points
    obs: torch.Tensor  # (..., W, M, R) pixels, R=4 stereo [ul,vl,ur,vr] / 2 mono
    mask: torch.Tensor  # (..., W, M) bool observation validity


class BAResult(NamedTuple):
    cam: torch.Tensor
    pts: torch.Tensor
    cost: torch.Tensor  # (...) final robust mean cost over valid residuals
    n_iter: torch.Tensor  # (...) int32
    converged: torch.Tensor  # (...) bool


def _camera_points(cam: torch.Tensor, pts: torch.Tensor):
    """(R (..., W, 3, 3), camera-frame points (..., W, M, 3))."""
    R = lie.so3_exp(cam[..., :3])
    pc = torch.matmul(pts[..., None, :, :], R.transpose(-1, -2)) + cam[..., :, None, 3:6]
    return R, pc


def _predict(pc: torch.Tensor, cfg: BAConfig) -> torch.Tensor:
    """(..., R) predicted pixels of camera-frame points: [ul, v, ur, v]
    sharing predicted_y (BundleAdjuster.h:153-171), or [u, v] mono."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    ul = cfg.intr.fu * x / z + cfg.intr.cu
    v = cfg.intr.fv * y / z + cfg.intr.cv
    if cfg.baseline > 0:
        ur = cfg.intr.fu * (x - cfg.baseline) / z + cfg.intr.cu
        return torch.stack([ul, v, ur, v], dim=-1)
    return torch.stack([ul, v], dim=-1)


def _residuals(cam, pts, obs, cfg: BAConfig) -> torch.Tensor:
    """Per-observation residuals obs - prediction, (..., W, M, R)."""
    return obs - _predict(_camera_points(cam, pts)[1], cfg)


def _drot_point(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d(so3_exp(v) p)/dv, (..., 3, 3), for v (..., 3) against p (..., 3),
    differentiating so3_exp's own expression R p = p + A (v x p) +
    B v x (v x p) in the branch it takes: A, B and their theta^2 slopes from
    the closed forms, or from the Taylor series below theta^2 = 1e-8."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < lie._EPS  # so3_exp's branch
    t = lie._safe_sqrt(theta2, small)
    s, c = torch.sin(t), torch.cos(t)
    A = torch.where(small, 1.0 - theta2 / 6.0, s / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - c) / (t * t))
    dA = torch.where(small, torch.full_like(t, -1.0 / 6.0), (t * c - s) / (2.0 * t ** 3))
    dB = torch.where(small, torch.full_like(t, -1.0 / 24.0),
                     (t * s - 2.0 * (1.0 - c)) / (2.0 * t ** 4))
    kp = torch.linalg.cross(v, p, dim=-1)  # v x p
    kkp = torch.linalg.cross(v, kp, dim=-1)  # v x (v x p)
    vp = torch.sum(v * p, dim=-1)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    outer = lambda a, b: a[..., :, None] * b[..., None, :]  # noqa: E731
    return (2.0 * dA[..., None, None] * outer(kp, v)
            - A[..., None, None] * lie.skew(p)
            + 2.0 * dB[..., None, None] * outer(kkp, v)
            + B[..., None, None] * (vp[..., None, None] * eye + outer(v, p)
                                    - 2.0 * outer(p, v)))


def _residuals_jacobians(cam, pts, obs, cfg: BAConfig):
    """Residuals r (..., W, M, R) and the Jacobians of the PREDICTIONS,
    J_c (..., W, M, R, 6) and J_p (..., W, M, R, 3)."""
    R, pc = _camera_points(cam, pts)
    x, y, zr = pc[..., 0], pc[..., 1], pc[..., 2]
    clamped = torch.abs(zr) < 1e-9
    z = torch.where(clamped, torch.full_like(zr, 1e-9), zr)
    dz = (~clamped).to(z.dtype)  # the clamp's slope
    fu, fv = cfg.intr.fu, cfg.intr.fv
    zero = torch.zeros_like(z)
    rows = [torch.stack([fu / z, zero, -fu * x / (z * z) * dz], dim=-1),
            torch.stack([zero, fv / z, -fv * y / (z * z) * dz], dim=-1)]
    if cfg.baseline > 0:
        rows = [rows[0], rows[1],
                torch.stack([fu / z, zero, -fu * (x - cfg.baseline) / (z * z) * dz], dim=-1),
                rows[1]]
    dpred = torch.stack(rows, dim=-2)  # (..., W, M, R, 3) d prediction / d pc
    aa = cam[..., :, None, :3].expand(*pc.shape[:-1], 3)
    p = pts[..., None, :, :].expand(*pc.shape)
    Jrot = torch.matmul(dpred, _drot_point(aa, p))  # (..., W, M, R, 3)
    Jc = torch.cat([Jrot, dpred], dim=-1)  # d pc / d t = I
    Jp = torch.einsum("...wmrk,...wkj->...wmrj", dpred, R)
    r = obs - _predict(pc, cfg)
    return r, Jc, Jp


def _huber_weights(r: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss on each observation's residual norm."""
    nrm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    w = torch.where(nrm <= delta, torch.ones_like(nrm), delta / nrm)
    return w * mask


def _robust_cost(r: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean Huber cost over the valid observations, (...)."""
    sq = torch.sum(r * r, dim=-1)
    nrm = torch.sqrt(sq + 1e-12)
    rho = torch.where(nrm <= delta, sq, 2.0 * delta * nrm - delta * delta)
    return (torch.sum(rho * mask, dim=(-2, -1))
            / torch.clamp(torch.sum(mask, dim=(-2, -1)), min=1.0))


def _normal_blocks(cam, pts, obs, mask, cfg: BAConfig):
    """U (..., W, 6, 6), V (..., M, 3, 3), Wc (..., W, M, 6, 3), bc (..., W, 6),
    bp (..., M, 3) and the robust cost."""
    r, Jc, Jp = _residuals_jacobians(cam, pts, obs, cfg)
    w = _huber_weights(r, mask, cfg.huber_delta)[..., None, None]
    Jcw = Jc * w
    U = torch.einsum("...wmri,...wmrj->...wij", Jcw, Jc)
    V = torch.einsum("...wmri,...wmrj->...mij", Jp * w, Jp)
    Wc = torch.einsum("...wmri,...wmrj->...wmij", Jcw, Jp)
    wr = r * w[..., 0]
    bc = torch.einsum("...wmri,...wmr->...wi", Jc, wr)
    bp = torch.einsum("...wmri,...wmr->...mi", Jp, wr)
    return U, V, Wc, bc, bp, _robust_cost(r, mask, cfg.huber_delta)


def _gauge(S: torch.Tensor, n_fixed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pin the first ``n_fixed`` frames of a (..., W, 6, W, 6) reduced
    system: their rows and columns become the identity. Returns (S, free)."""
    W = S.shape[-2]
    free = (torch.arange(W, device=S.device) >= n_fixed).to(S.dtype)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + torch.einsum("wv,ij->wivj", torch.diag(1.0 - free), eye6)
    return S, free


def _reduced_system(U, Vinv, Wc):
    """S = blockdiag(U) - Wc Vinv Wc^T, (..., W, 6, W, 6), and Wc Vinv."""
    W = U.shape[-3]
    WV = torch.einsum("...wmij,...mjk->...wmik", Wc, Vinv)
    S = -torch.einsum("...wmik,...vmlk->...wivl", WV, Wc)
    S = S + torch.einsum("wv,...wij->...wivj", torch.eye(W, dtype=U.dtype, device=U.device), U)
    return S, WV


def _schur_solve(U, V, Wc, bc, bp, lam, n_fixed: int, pt_valid):
    """Eliminate the landmarks, solve the damped reduced camera system and
    back-substitute. ``lam`` (...). Returns (dcam (..., W, 6), dpts
    (..., M, 3), ok (...)): ok is False where the solve was singular or not
    finite."""
    W = Wc.shape[-4]
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    lam4 = lam[..., None, None, None]
    # multiplicative diagonal damping (Ceres-style)
    Ud = U + lam4 * eye6 * torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1)[..., None], min=1e-6)
    Vd = V + lam4 * eye3 * torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1)[..., None], min=1e-6)
    # unobserved / invalid points get the identity (their updates are zeroed)
    Vd = torch.where(pt_valid[..., None, None], Vd, eye3)
    Vinv = torch.linalg.inv_ex(Vd)[0]
    S, WV = _reduced_system(Ud, Vinv, Wc)
    rhs = bc - torch.einsum("...wmik,...mk->...wi", WV, bp)
    S, free = _gauge(S, n_fixed)
    rhs = rhs * free[:, None]
    batch = S.shape[:-4]
    dcam, info = torch.linalg.solve_ex(S.reshape(*batch, W * 6, W * 6),
                                       rhs.reshape(*batch, W * 6, 1))
    dcam = dcam.reshape(*batch, W, 6)
    dpts = torch.einsum("...mij,...mj->...mi", Vinv,
                        bp - torch.einsum("...wmij,...wi->...mj", Wc, dcam))
    dpts = dpts * pt_valid[..., None]
    ok = ((info == 0) & torch.all(torch.isfinite(dcam), dim=(-2, -1))
          & torch.all(torch.isfinite(dpts), dim=(-2, -1)))
    return dcam, dpts, ok


def _clamp_depth(cam, pts, cfg: BAConfig) -> torch.Tensor:
    """Clamp depth in the first camera to [zmin, zmax]
    (BundleAdjuster.h:442-443, 455-459); mono problems are left as they are."""
    if cfg.baseline <= 0:
        return pts
    fB = cfg.intr.fu * cfg.baseline
    zmax = cfg.zmax_depth if cfg.zmax_depth > 0 else fB / 0.1
    zmin = max(cfg.zmin_frac * fB, fB / (2.0 * cfg.intr.cu))
    R0 = lie.so3_exp(cam[..., 0, :3])  # (..., 3, 3)
    t0 = cam[..., None, 0, 3:6]
    pc = torch.matmul(pts, R0.transpose(-1, -2)) + t0
    pc = torch.cat([pc[..., :2], torch.clamp(pc[..., 2:], zmin, zmax)], dim=-1)
    return torch.matmul(pc - t0, R0)


def ba_solve(problem: BAProblem, cfg: BAConfig) -> BAResult:
    """Run windowed BA to convergence (optimise(), BundleAdjuster.h:432-476)
    for every problem of the batch."""
    with profiling.span("ba.solve"):
        cam0, obs = problem.cam, problem.obs
        mask = problem.mask.to(cam0.dtype)
        pt_valid = torch.sum(mask, dim=-2) >= 2.0  # (..., M): >= 2 views
        batch = cam0.shape[:-2]

        cam, pts = cam0, problem.pts
        cost = _robust_cost(_residuals(cam, pts, obs, cfg), mask, cfg.huber_delta)
        lam = torch.full(batch, cfg.lambda0, dtype=cam0.dtype, device=cam0.device)
        k = torch.zeros(batch, dtype=torch.int32, device=cam0.device)
        done = torch.zeros(batch, dtype=torch.bool, device=cam0.device)

        trips = reads = 0
        for _ in range(cfg.max_iter):
            reads += 1
            if bool(done.all()):
                break
            trips += 1
            U, V, Wc, bc, bp, cost_lin = _normal_blocks(cam, pts, obs, mask, cfg)
            dcam, dpts, ok = _schur_solve(U, V, Wc, bc, bp, lam, cfg.n_fixed, pt_valid)
            cam_new = cam + dcam
            pts_new = _clamp_depth(cam_new, pts + dpts, cfg)
            cost_new = _robust_cost(_residuals(cam_new, pts_new, obs, cfg), mask,
                                    cfg.huber_delta)

            # a window that is done keeps everything: under vmap the JAX loop
            # runs to the slowest window, and without this latch a converged
            # window would keep taking steps driven by its batch-mates
            accept = ok & (cost_new < cost_lin) & ~done
            rel_decrease = (cost_lin - cost_new) / torch.clamp(cost_lin, min=1e-12)
            # a small decrease signals convergence only when damping is not
            # inflated (an accepted but heavily damped step is just a short step)
            newly_done = accept & (rel_decrease < cfg.ftol) & (lam <= cfg.lambda0)
            lam_next = torch.where(accept, torch.clamp(lam * cfg.lambda_down, min=cfg.lambda_min),
                                   torch.clamp(lam * cfg.lambda_up, max=cfg.lambda_max))
            cam = _sel(accept, cam_new, cam)
            pts = _sel(accept, pts_new, pts)
            cost = torch.where(done, cost, torch.where(accept, cost_new, cost_lin))
            k = torch.where(done, k, k + 1)
            done_next = done | newly_done | (lam >= cfg.lambda_max)
            lam = torch.where(done, lam, lam_next)
            done = done_next
        profiling.count("ba.calls")
        profiling.count("ba.trips", trips)
        profiling.count("sync.ba", reads)
        return BAResult(cam=cam, pts=pts, cost=cost, n_iter=k, converged=done)


def gate_tracks(cam, pts, obs, mask, cfg: BAConfig, gate_px: float) -> torch.Tensor:
    """Pre-BA inlier gate: (..., M) keep-mask of tracks whose WORST
    per-component reprojection residual against the initial cameras stays
    within ``gate_px`` (the window-level analogue of computeInliers,
    StereoVisualOdometry.cpp:94-114)."""
    pred = _predict(_camera_points(cam, pts)[1], cfg)  # (..., W, M, R)
    err = torch.amax(torch.abs(obs - pred), dim=-1)
    err = torch.where(mask, err, torch.zeros_like(err))
    return torch.amax(err, dim=-2) <= gate_px


def ba_camera_covariances(problem: BAProblem, cfg: BAConfig) -> torch.Tensor:
    """Per-camera 6x6 covariances (..., W, 6, 6) from the inverse of the
    reduced camera system (extract_covariance, BundleAdjuster.h:478-528).
    Call after ``ba_solve``; the fixed (gauge) frames get zero covariance."""
    mask = problem.mask.to(problem.cam.dtype)
    pt_valid = torch.sum(mask, dim=-2) >= 2.0
    U, V, Wc, _, _, _ = _normal_blocks(problem.cam, problem.pts, problem.obs, mask, cfg)
    W = U.shape[-3]
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vd = torch.where(pt_valid[..., None, None], V + 1e-9 * eye3, eye3)
    S, _ = _reduced_system(U, torch.linalg.inv_ex(Vd)[0], Wc)
    S, free = _gauge(S, cfg.n_fixed)
    batch = S.shape[:-4]
    Sf = S.reshape(*batch, W * 6, W * 6)
    # relative Tikhonov: a frame with almost no surviving observations makes
    # S near-singular and its float32 inverse indefinite
    diag = torch.diagonal(Sf, dim1=-2, dim2=-1)
    eps = 1e-6 * torch.clamp(torch.mean(torch.abs(diag), dim=-1), min=1.0)
    Sf = Sf + eps[..., None, None] * torch.eye(W * 6, dtype=U.dtype, device=U.device)
    Sinv = torch.linalg.inv_ex(Sf)[0].reshape(*batch, W, 6, W, 6)
    cov = torch.diagonal(Sinv, dim1=-4, dim2=-2).movedim(-1, -3)  # (..., W, 6, 6)
    # symmetrize and clip the eigenvalues to [0, 1e4]: consumers need valid
    # covariances even from degenerate windows
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    eig, vec = torch.linalg.eigh(cov)
    profiling.count("sync.cov_eigh")  # eigh reads its solver's status back on the host
    eig = torch.clamp(eig, 0.0, 1e4)
    cov = torch.matmul(vec * eig[..., None, :], vec.transpose(-1, -2))
    return cov * free[:, None, None]
