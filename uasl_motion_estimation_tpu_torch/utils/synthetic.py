"""Synthetic stereo-sequence renderer with exact ground truth.

The build environment has no datasets (zero egress), so integration tests and
benchmarks run on an exactly-rendered synthetic world: textured planes
(ground + side walls + backdrop) ray-cast into a rectified stereo pair along a
KITTI-like forward trajectory. Geometry is exact, so pose/ATE checks measure
solver quality, not data quality.

Host-side numpy (cold path by design — the reference's equivalent I/O layer is
also CPU-side, file_IO.cpp). Camera convention: x right, y down, z forward;
cam-to-world poses; right camera offset by +baseline along x.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CameraRig(NamedTuple):
    fu: float = 718.856
    fv: float = 718.856
    cu: float = 607.19
    cv: float = 185.22
    baseline: float = 0.5372
    height: int = 376
    width: int = 1241


class _Plane(NamedTuple):
    point: np.ndarray  # (3,)
    normal: np.ndarray  # (3,) unit
    u_axis: np.ndarray  # (3,) texture u direction
    v_axis: np.ndarray  # (3,) texture v direction
    texture: np.ndarray  # (T, T) float32
    tex_scale: float  # pixels per meter


class _MovingQuad(NamedTuple):
    """Finite textured rectangle with its own linear motion: rendered with
    the same ray-cast depth test as the static planes, so its pixels are
    photometrically-consistent features whose image motion contradicts the
    camera egomotion — exactly the outlier population the reference's RANSAC
    machinery exists to reject (StereoVisualOdometry.cpp:58-114)."""

    point0: np.ndarray  # (3,) center at frame 0 (world)
    velocity: np.ndarray  # (3,) meters/frame (world)
    normal: np.ndarray  # (3,) unit
    u_axis: np.ndarray  # (3,)
    v_axis: np.ndarray  # (3,)
    half_u: float  # half-extent along u_axis (meters)
    half_v: float  # half-extent along v_axis (meters)
    texture: np.ndarray  # (T, T) float32
    tex_scale: float  # texels per meter


class CorruptionConfig(NamedTuple):
    """Robust-regime stressors for the synthetic world (VERDICT round 2,
    missing #5): the noiseless plane world never exercised the outlier
    rejection that is the reference's engineering core, so benchmarks on it
    proved only the easy case.

    All stressors are deterministic in (seed, frame index, camera) so the
    same corrupted frames can be fed to both this framework and the compiled
    reference binary for a fair ATE comparison.
    """

    # per-frame-per-camera photometric model: I' = gain * I + bias + noise
    gain_std: float = 0.08  # multiplicative, lognormal-ish around 1
    bias_std: float = 6.0  # additive intensity offset
    noise_std: float = 4.0  # iid pixel noise (sensor noise)
    # independently moving textured objects (VO outlier generators)
    n_moving_objects: int = 2
    # near-field occluder: a weakly-textured quad sweeping across the view,
    # killing the tracks it covers (track dropout + birth churn)
    occluder: bool = True


def _smooth_texture(rng: np.ndarray, size: int, octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise: textured at several scales so both GFTT and
    coarse pyramid levels of KLT have signal."""
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        s = max(size >> (octaves - 1 - o), 4)
        layer = rng.uniform(-1, 1, (s, s)).astype(np.float32)
        # bilinear upsample to full size
        yi = np.linspace(0, s - 1, size, dtype=np.float32)
        xi = np.linspace(0, s - 1, size, dtype=np.float32)
        y0 = np.clip(yi.astype(int), 0, s - 2)
        x0 = np.clip(xi.astype(int), 0, s - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            layer[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + layer[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + layer[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + layer[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        tex += amp * up
        amp *= 0.6
    tex -= tex.min()
    tex *= 235.0 / max(tex.max(), 1e-6)
    return tex + 10.0


def kitti_like_trajectory(n_frames: int, speed: float = 0.8,
                          max_yaw_rate: float = 0.03) -> np.ndarray:
    """(N, 4, 4) cam-to-world poses: forward motion with a sinusoidal yaw.

    KITTI seq-00-like scale: ~0.8 m/frame at 10 Hz, with peak yaw rate
    ~0.03 rad/frame (matching real sequences; above ~0.1 rad/frame the
    inter-frame image shift exceeds any tracker's pyramid range)."""
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # yaw about y (down)
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        fwd = R @ np.array([0.0, 0.0, 1.0])
        pos = pos + speed * fwd
        yaw += max_yaw_rate * np.sin(0.05 * i)
    return poses


def stress_trajectory(kind: str, n_frames: int, speed: float = 0.8,
                      turn_rate_deg: float = 10.0) -> np.ndarray:
    """(N, 4, 4) adversarial trajectories (VERDICT r4 item 5 — the committed
    worlds were all gentle forward motion, while the stated benchmark domain
    includes near-stop 90-degree turns and pure-rotation segments):

    * "sharp_turn": forward driving with a 90-degree turn at 10 deg/frame in
      the middle third (urban corner at speed);
    * "near_stop": decelerate to ~1 cm/frame for the middle third (traffic
      stop) with residual yaw jitter, then resume;
    * "pure_rotation": full stop + 4 deg/frame yaw-in-place stretch (the
      classic stereo-VO degenerate regime: no translation, disparity priors
      stale, KLT flow is pure rotation).
    """
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)
    yaw = 0.0
    third = n_frames // 3
    for i in range(n_frames):
        if kind == "sharp_turn":
            v = speed
            n_turn = int(round(90.0 / turn_rate_deg))
            dyaw = (np.deg2rad(turn_rate_deg)
                    if third <= i < third + n_turn else 0.0)
        elif kind == "near_stop":
            in_stop = third <= i < 2 * third
            v = 0.01 if in_stop else speed
            dyaw = 0.002 * np.sin(0.7 * i) if in_stop else 0.0
        elif kind == "pure_rotation":
            in_rot = third <= i < 2 * third
            v = 0.0 if in_rot else speed
            dyaw = np.deg2rad(4.0) if in_rot else 0.0
        else:
            raise ValueError(f"unknown stress kind {kind!r}")
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + v * (R @ np.array([0.0, 0.0, 1.0]))
        yaw += dyaw
    return poses


class SyntheticStereoSequence:
    """Renders (left, right) uint8-range float32 frames plus exact GT poses."""

    def __init__(
        self,
        n_frames: int = 50,
        rig: CameraRig = CameraRig(),
        seed: int = 0,
        trajectory: np.ndarray | None = None,
        tex_size: int = 1024,
        corruption: CorruptionConfig | None = None,
        cross_modal: bool = False,
        low_texture_band: tuple[float, float] | None = None,
        low_texture_contrast: float = 0.08,
        hall_half_width: float = 12.0,
    ):
        self.rig = rig
        self.n_frames = n_frames
        self.seed = seed
        self.corruption = corruption
        # Low-texture stretch (VERDICT r4 item 5): within world-z in
        # ``low_texture_band``, every surface's texture contrast collapses
        # to ``low_texture_contrast`` of normal — a featureless corridor
        # section that starves detection and weakens KLT/ZNCC signal.
        self.low_texture_band = low_texture_band
        self.low_texture_contrast = low_texture_contrast
        # Cross-modal rig (the reference's multispectral use case,
        # optimisation.cpp:150-228): the right camera observes the SAME
        # geometry through a different modality — rendered as an inverted
        # nonlinear intensity remap, under which intensity matching (ZNCC,
        # KLT) anti-correlates while mutual information still peaks at the
        # true disparity. Applied before photometric corruption.
        self.cross_modal = cross_modal
        self.poses = (
            trajectory if trajectory is not None else kitti_like_trajectory(n_frames)
        )
        rng = np.random.default_rng(seed)
        mk = lambda: _smooth_texture(rng, tex_size)
        big = 400.0  # meters of world covered by one texture tile
        self.planes = [
            # ground plane at y = +1.7 (camera 1.7 m above ground, y down)
            _Plane(np.array([0.0, 1.7, 0.0]), np.array([0.0, -1.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]), mk(),
                   tex_size / big),
            # side walls at x = +-hall_half_width (default 12; stress worlds
            # with turning trajectories widen the hall so the post-turn
            # heading does not drive into a wall within the sequence)
            _Plane(np.array([-hall_half_width, 0.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]),
                   np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]), mk(),
                   tex_size / big),
            _Plane(np.array([hall_half_width, 0.0, 0.0]),
                   np.array([-1.0, 0.0, 0.0]),
                   np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]), mk(),
                   tex_size / big),
        ]
        self.quads: list[_MovingQuad] = []
        if corruption is not None:
            self.quads = self._make_moving_quads(corruption, rng, tex_size)

    def _make_moving_quads(
        self, c: CorruptionConfig, rng: np.random.Generator, tex_size: int
    ) -> list[_MovingQuad]:
        """Moving objects sized/placed for the default forward trajectory
        (~0.8 m/frame): each stays in view for tens of frames, drifting
        laterally so its feature tracks contradict the egomotion."""
        quads = []
        # texture scale chosen so the object is RESOLVABLE at its viewing
        # distance (~20-50 m): aliased noise-texture would make its features
        # unmatchable (they'd fail ZNCC instead of becoming coherent
        # wrong-motion outliers, which is the stress this exists to create)
        small = 60.0  # meters of object covered by one texture tile
        for k in range(c.n_moving_objects):
            side = -1.0 if k % 2 == 0 else 1.0
            # car-sized quad facing the camera, spaced along the route,
            # moving with ~0.5 m/frame forward + slow lateral drift
            quads.append(_MovingQuad(
                point0=np.array([side * 4.0, 0.7, 22.0 + 28.0 * k]),
                velocity=np.array([-side * 0.06, 0.0, 0.55]),
                normal=np.array([0.0, 0.0, -1.0]),
                u_axis=np.array([1.0, 0.0, 0.0]),
                v_axis=np.array([0.0, 1.0, 0.0]),
                half_u=1.9,
                half_v=0.85,
                texture=_smooth_texture(rng, tex_size),
                tex_scale=tex_size / small,
            ))
        if c.occluder:
            # weakly-textured near-field quad, 2.6 m ahead of the (nominal)
            # camera, sweeping laterally across the view: tracks under it die
            # (dropout) and its own low-contrast surface starves detection
            tex = _smooth_texture(rng, tex_size)
            tex = 118.0 + 0.12 * (tex - float(tex.mean()))
            sweep = 7.0 / max(self.n_frames, 1)  # full crossing per sequence
            quads.append(_MovingQuad(
                point0=np.array([-3.5, -0.2, 4.5]),
                velocity=np.array([sweep, 0.0, 0.8]),
                normal=np.array([0.0, 0.0, -1.0]),
                u_axis=np.array([1.0, 0.0, 0.0]),
                v_axis=np.array([0.0, 1.0, 0.0]),
                half_u=0.5,
                half_v=0.9,
                texture=tex.astype(np.float32),
                tex_scale=tex_size / 3.0,
            ))
        return quads

    @staticmethod
    def _sample_tex(tex: np.ndarray, tu: np.ndarray, tv: np.ndarray,
                    scale: float) -> np.ndarray:
        """Bilinear wrap-around texture lookup at (tu, tv) meters."""
        ts = tex.shape[0]
        tu = np.mod(tu * scale, ts - 1)
        tv = np.mod(tv * scale, ts - 1)
        u0 = tu.astype(np.int32)
        v0 = tv.astype(np.int32)
        fu_ = tu - u0
        fv_ = tv - v0
        return (
            tex[v0, u0] * (1 - fv_) * (1 - fu_)
            + tex[v0, u0 + 1] * (1 - fv_) * fu_
            + tex[v0 + 1, u0] * fv_ * (1 - fu_)
            + tex[v0 + 1, u0 + 1] * fv_ * fu_
        )

    def _render(
        self, T_c2w: np.ndarray, frame_idx: int = 0, return_depth: bool = False
    ) -> np.ndarray:
        rig = self.rig
        h, w = rig.height, rig.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        d_cam = np.stack(
            [(xs - rig.cu) / rig.fu, (ys - rig.cv) / rig.fv, np.ones_like(xs)], -1
        )  # (h, w, 3)
        R, c = T_c2w[:3, :3], T_c2w[:3, 3]
        d_world = d_cam @ R.T  # (h, w, 3)

        best_t = np.full((h, w), np.inf, np.float32)
        out = np.full((h, w), 96.0, np.float32)  # sky/backdrop value
        for pl in self.planes:
            denom = d_world @ pl.normal
            num = (pl.point - c) @ pl.normal
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            hit = (t > 0.5) & (t < best_t) & (np.abs(denom) > 1e-9)
            if not hit.any():
                continue
            t_safe = np.where(hit, t, 1.0)
            p = c + t_safe[..., None] * d_world  # world intersection
            tu = (p - pl.point) @ pl.u_axis
            tv = (p - pl.point) @ pl.v_axis
            val = self._sample_tex(pl.texture, tu, tv, pl.tex_scale)
            if self.low_texture_band is not None:
                z0, z1 = self.low_texture_band
                in_band = (p[..., 2] >= z0) & (p[..., 2] <= z1)
                flat = 118.0 + self.low_texture_contrast * (val - 118.0)
                val = np.where(in_band, flat, val)
            out = np.where(hit, val, out)
            best_t = np.where(hit, t, best_t)
        for q in self.quads:
            center = q.point0 + frame_idx * q.velocity
            denom = d_world @ q.normal
            num = (center - c) @ q.normal
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            t_safe = np.where(np.isfinite(t), t, 1.0)
            p = c + t_safe[..., None] * d_world
            tu = (p - center) @ q.u_axis
            tv = (p - center) @ q.v_axis
            hit = (
                (t > 0.3) & (t < best_t) & (np.abs(denom) > 1e-9)
                & (np.abs(tu) <= q.half_u) & (np.abs(tv) <= q.half_v)
            )
            if not hit.any():
                continue
            val = self._sample_tex(q.texture, tu + q.half_u, tv + q.half_v,
                                   q.tex_scale)
            out = np.where(hit, val, out)
            best_t = np.where(hit, t, best_t)
        if return_depth:
            # the ray direction has unit camera-z component, so the ray
            # parameter t IS the camera-frame depth z
            return out, best_t
        return out

    def gt_disparity(self, i: int) -> np.ndarray:
        """Exact left-camera disparity map for frame i: fu * B / z, with 0
        where no surface is hit — the accuracy reference for the stereo
        matchers (VERDICT r2 item 6). Uncorrupted geometry: photometric
        corruption never moves surfaces."""
        _, z = self._render(self.poses[i], i, return_depth=True)
        with np.errstate(divide="ignore"):
            d = self.rig.fu * self.rig.baseline / z
        return np.where(np.isfinite(d), d, 0.0).astype(np.float32)

    def _corrupt(self, img: np.ndarray, frame_idx: int, cam: int) -> np.ndarray:
        """Per-frame-per-camera photometric corruption, deterministic in
        (seed, frame, cam) so both frameworks see identical pixels."""
        c = self.corruption
        rng = np.random.default_rng([self.seed, frame_idx, cam, 0x9E3779B9])
        gain = float(np.exp(rng.normal(0.0, c.gain_std)))
        bias = float(rng.normal(0.0, c.bias_std))
        noise = rng.normal(0.0, c.noise_std, img.shape).astype(np.float32)
        return np.clip(gain * img + bias + noise, 0.0, 255.0)

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(left, right) float32 (H, W) images for frame i."""
        T = self.poses[i]
        T_right = T.copy()
        T_right[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([self.rig.baseline, 0, 0])
        left, right = self._render(T, i), self._render(T_right, i)
        if self.cross_modal:
            # inverted + gamma-warped: monotone-DECREASING intensity map, so
            # ZNCC anti-correlates; the nonlinearity keeps it from being a
            # pure affine flip (which zero-mean matchers could still absorb)
            right = 255.0 * (1.0 - (right / 255.0) ** 0.7)
        if self.corruption is not None:
            left = self._corrupt(left, i, 0)
            right = self._corrupt(right, i, 1)
        return left, right

    def gt_positions(self) -> np.ndarray:
        return self.poses[:, :3, 3].copy()


def stereo_ba_windows(rng: np.random.Generator, intr, baseline: float, n_cams: int,
                      n_pts: int, window: int, overlap: int, noise: float,
                      image_shape: tuple[int, int] | None = None):
    """Windowed stereo-BA world: ``n_cams`` cameras (angle-axis, translation)
    moving forward 0.8 m a frame, ``n_pts`` points 8-45 m ahead, their exact
    stereo projections through ``intr`` (fu, fv, cu, cv) and ``baseline``,
    observed where the point is in front (and inside ``image_shape`` (h, w)
    where given) with ``noise`` px of Gaussian noise; cut into windows of
    ``window`` frames overlapping by ``overlap``. Every draw comes from
    ``rng``.

    Returns (cams (n_cams, 6), starts, (cam, pts, obs, mask)): the last is
    the windows' exact problem with a leading window axis, as
    ``solvers.ba.BAProblem`` takes it."""
    import torch

    from ..ops import lie  # torch; the renderer above needs only numpy

    i = np.arange(n_cams)[:, None]
    cams = np.concatenate([i * [0.002, 0.004, 0.001], i * [0.05, 0.02, -0.8]], 1)
    cams = cams.astype(np.float32)
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 45, n_pts)], -1).astype(np.float32)
    R = lie.so3_exp(torch.from_numpy(cams[:, :3])).numpy()
    pc = np.einsum("wij,mj->wmi", R, pts) + cams[:, None, 3:6]
    z = pc[..., 2]
    ul = intr.fu * pc[..., 0] / z + intr.cu
    v = intr.fv * pc[..., 1] / z + intr.cv
    ur = intr.fu * (pc[..., 0] - baseline) / z + intr.cu
    obs = np.stack([ul, v, ur, v], -1).astype(np.float32)
    mask = z > 1.0
    if image_shape is not None:
        mask &= (ul > 0) & (ul < image_shape[1]) & (v > 0) & (v < image_shape[0])
    obs += rng.normal(scale=noise, size=obs.shape).astype(np.float32)
    starts = list(range(0, n_cams - window + 1, window - overlap))
    return cams, starts, (np.stack([cams[s:s + window] for s in starts]),
                          np.stack([pts] * len(starts)),
                          np.stack([obs[s:s + window] for s in starts]),
                          np.stack([mask[s:s + window] for s in starts]))


def perturb_windows(cam: np.ndarray, pts: np.ndarray, rng: np.random.Generator,
                    n_fixed: int, pts_sigma: float = 0.3):
    """A start for windowed BA: every window camera moved by N(0, 0.01) but
    window 0's first ``n_fixed`` (they carry the gauge), then, where
    ``pts_sigma`` > 0, every point by N(0, ``pts_sigma``). Returns
    (cam, pts), float32."""
    wc = cam + rng.normal(scale=0.01, size=cam.shape).astype(np.float32)
    wc[0, :n_fixed] = cam[0, :n_fixed]
    if pts_sigma > 0:
        pts = pts + rng.normal(scale=pts_sigma, size=pts.shape).astype(np.float32)
    return wc, pts


def ba_window(intr, baseline: float, n_frames: int = 6, n_pts: int = 120, noise: float = 0.0,
              stereo: bool = True, seed: int = 7, image_shape: tuple[int, int] = (480, 640)):
    """One BA window with exact projections, drawn as the JAX package's BA
    tests draw theirs (``make_window``): cameras (angle-axis, world->cam
    translation) moving -0.8 m along z a frame, ``n_pts`` points 8-30 m
    ahead, their stereo (or mono) projections through ``intr`` and
    ``baseline``, observed where in front and inside ``image_shape`` (h,
    w), then ``noise`` px of Gaussian noise. Returns (cams, pts, obs, mask)
    as float32 / bool numpy arrays."""
    import torch

    from ..ops import lie  # torch; the renderer above needs only numpy

    rng = np.random.default_rng(seed)
    i = np.arange(n_frames)[:, None]
    cams = np.concatenate([i * [0.002, 0.004, 0.001], i * [0.05, 0.02, -0.8]], 1)
    cams = cams.astype(np.float32)
    pts = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 30, n_pts)], -1).astype(np.float32)
    obs = np.zeros((n_frames, n_pts, 4 if stereo else 2), np.float32)
    mask = np.zeros((n_frames, n_pts), bool)
    rot = lie.so3_exp(torch.from_numpy(cams[:, :3])).numpy()
    for w, cam in enumerate(cams):
        pc = pts @ rot[w].T + cam[3:6]
        z = pc[:, 2]
        ul = intr.fu * pc[:, 0] / z + intr.cu
        v = intr.fv * pc[:, 1] / z + intr.cv
        if stereo:
            ur = intr.fu * (pc[:, 0] - baseline) / z + intr.cu
            obs[w] = np.stack([ul, v, ur, v], -1)
        else:
            obs[w] = np.stack([ul, v], -1)
        mask[w] = (z > 1.0) & (ul > 0) & (ul < image_shape[1]) & (v > 0) & (v < image_shape[0])
    obs += rng.normal(scale=noise, size=obs.shape)
    return cams, pts, obs, mask


def perturb_ba_window(cams: np.ndarray, pts: np.ndarray, cam_scale: float = 0.01,
                      pt_scale: float = 0.3, seed: int = 13):
    """``ba_window``'s start for BA, as the JAX package's BA tests perturb
    theirs: every camera but the first two moved by N(0, ``cam_scale``),
    every point by N(0, ``pt_scale``). Returns (cams, pts), float32."""
    rng = np.random.default_rng(seed)
    cams_p = cams.copy()
    cams_p[2:] += rng.normal(scale=cam_scale, size=cams_p[2:].shape)
    pts_p = pts + rng.normal(scale=pt_scale, size=pts.shape)
    return cams_p.astype(np.float32), pts_p.astype(np.float32)
