"""The benchmark's synthetic world, rendered on the device.

Frozen copies of what the port's ``utils/synthetic.py`` draws, so that a
later change to the program cannot change the benchmark's inputs:

- ``smooth_texture``, ``kitti_like_trajectory``: the hall's value-noise
  textures (made on the host from the seed) and the forward drive with a
  sinusoidal yaw;
- ``Hall``: the textured planes of ``SyntheticStereoSequence`` (ground at
  y = +1.7 m, walls at x = +-12 m) and ``render``, a torch copy of its
  ``_render`` and ``frame`` for the planes only (no moving objects, no
  photometric corruption), batched over frames and run on the device in
  float64 from float32 ray directions, as the numpy original does;
- ``ba_window``, ``perturb_ba_window``: the JAX package's BA test windows.

The plain reference (``vobench/reference/geometry.py``) casts rays against
the same planes to judge correspondences.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Rig(NamedTuple):
    fu: float
    fv: float
    cu: float
    cv: float
    baseline: float
    height: int
    width: int


def smooth_texture(rng: np.random.Generator, size: int, octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [10, 245], float32 (size, size)."""
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        s = max(size >> (octaves - 1 - o), 4)
        layer = rng.uniform(-1, 1, (s, s)).astype(np.float32)
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
    """(N, 4, 4) float64 cam-to-world poses: 0.8 m a frame forward with a
    sinusoidal yaw (x right, y down, z forward)."""
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + speed * (R @ np.array([0.0, 0.0, 1.0]))
        yaw += max_yaw_rate * np.sin(0.05 * i)
    return poses


def right_poses(poses: np.ndarray, baseline: float) -> np.ndarray:
    """Cam-to-world poses of the right camera, +baseline along camera x."""
    out = poses.copy()
    out[:, :3, 3] = poses[:, :3, 3] + poses[:, :3, :3] @ np.array([baseline, 0.0, 0.0])
    return out


class Hall:
    """The three textured planes of the JAX package's synthetic hall, on
    ``device``. ``seed`` draws the three 1024 x 1024 textures on the host."""

    BACKDROP = 96.0
    WORLD_PER_TILE = 400.0  # metres of world one texture tile covers

    def __init__(self, seed: int, device, tex_size: int = 1024,
                 hall_half_width: float = 12.0):
        rng = np.random.default_rng(seed)
        texs = [smooth_texture(rng, tex_size) for _ in range(3)]
        self.tex_size = tex_size
        self.scale = tex_size / self.WORLD_PER_TILE
        self.textures = torch.from_numpy(np.stack(texs)).to(device)
        f64 = dict(dtype=torch.float64, device=device)
        hw = hall_half_width
        # rows: ground, left wall, right wall
        self.point = torch.tensor([[0.0, 1.7, 0.0], [-hw, 0.0, 0.0], [hw, 0.0, 0.0]], **f64)
        self.normal = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], **f64)
        self.u_axis = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], **f64)
        self.v_axis = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], **f64)
        self.device = torch.device(device)

    def _sample(self, k: int, tu: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
        """Bilinear wrap-around lookup of texture k at (tu, tv) metres."""
        ts = self.tex_size
        tu = torch.remainder(tu * self.scale, ts - 1)
        tv = torch.remainder(tv * self.scale, ts - 1)
        u0 = tu.to(torch.int32).long()
        v0 = tv.to(torch.int32).long()
        fu = tu - u0
        fv = tv - v0
        tex = self.textures[k].reshape(-1)
        at = lambda v, u: tex[v * ts + u].to(torch.float64)  # noqa: E731
        return (at(v0, u0) * (1 - fv) * (1 - fu) + at(v0, u0 + 1) * (1 - fv) * fu
                + at(v0 + 1, u0) * fv * (1 - fu) + at(v0 + 1, u0 + 1) * fv * fu)

    def _rays(self, rig: Rig) -> torch.Tensor:
        """(h, w, 3) camera-frame ray directions with unit z, computed in
        float32 as the numpy renderer does, then widened."""
        ys, xs = torch.meshgrid(torch.arange(rig.height, dtype=torch.float32, device=self.device),
                                torch.arange(rig.width, dtype=torch.float32, device=self.device),
                                indexing="ij")
        d = torch.stack([(xs - rig.cu) / rig.fu, (ys - rig.cv) / rig.fv, torch.ones_like(xs)], -1)
        return d.to(torch.float64)

    def _trace(self, T_c2w: torch.Tensor, d_cam: torch.Tensor):
        """Nearest plane hit of each ray: (grey, ray parameter t) float64,
        the backdrop and inf where nothing is hit. ``T_c2w`` (F, 4, 4),
        ``d_cam`` (F, P, 3) camera-frame rays with unit z."""
        d_world = torch.matmul(d_cam, T_c2w[:, :3, :3].transpose(-1, -2))
        cw = T_c2w[:, None, :3, 3]
        best_t = torch.full(d_world.shape[:-1], torch.inf, dtype=torch.float64, device=self.device)
        out = torch.full_like(best_t, self.BACKDROP)
        for k in range(3):
            n, p0 = self.normal[k], self.point[k]
            denom = d_world @ n
            t = ((p0 - cw) @ n) / denom
            hit = (t > 0.5) & (t < best_t) & (torch.abs(denom) > 1e-9)
            t_safe = torch.where(hit, t, torch.ones_like(t))
            p = cw + t_safe[..., None] * d_world
            val = self._sample(k, (p - p0) @ self.u_axis[k], (p - p0) @ self.v_axis[k])
            out = torch.where(hit, val, out)
            best_t = torch.where(hit, t, best_t)
        return out, best_t

    def render(self, poses_c2w: np.ndarray, rig: Rig, batch: int = 16) -> torch.Tensor:
        """(F, h, w) uint8 frames of the camera at each pose (float64 grey
        values clipped to [0, 255] and truncated, as ``_u8`` does)."""
        return torch.cat([self.render_f64(poses_c2w[i:i + batch], rig)
                          .clamp_(0.0, 255.0).to(torch.uint8)
                          for i in range(0, len(poses_c2w), batch)])

    def render_f64(self, poses_c2w: np.ndarray, rig: Rig) -> torch.Tensor:
        """(F, h, w) float64 grey values before the uint8 cast."""
        T = torch.as_tensor(np.asarray(poses_c2w), dtype=torch.float64, device=self.device)
        rays = self._rays(rig).reshape(1, -1, 3).expand(T.shape[0], -1, 3)
        return self._trace(T, rays)[0].reshape(T.shape[0], rig.height, rig.width)

    def stereo(self, poses_c2w: np.ndarray, rig: Rig) -> tuple[torch.Tensor, torch.Tensor]:
        """(lefts, rights) (F, h, w) uint8 of the rig along ``poses_c2w``."""
        return (self.render(poses_c2w, rig),
                self.render(right_poses(poses_c2w, rig.baseline), rig))


def so3_exp_f32(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues in float32 with a Taylor branch below theta^2 = 1e-8 (the
    formula the port's BA window builder uses)."""
    theta2 = torch.sum(v * v, dim=-1)
    small = theta2 < 1e-8
    t = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    z = torch.zeros_like(v[..., 0])
    K = torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                     torch.stack([v[..., 2], z, -v[..., 0]], -1),
                     torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def ba_window(intr, baseline: float, n_frames: int = 6, n_pts: int = 120, noise: float = 0.0,
              seed: int = 7, image_shape: tuple[int, int] = (480, 640)):
    """One stereo BA window with exact projections plus ``noise`` px of
    Gaussian noise: cameras (angle-axis, world->cam translation) moving
    -0.8 m along z a frame, ``n_pts`` points 8-30 m ahead, observed where in
    front and inside ``image_shape`` (h, w). ``intr`` has fu, fv, cu, cv.
    Returns (cams, pts, obs, mask) float32 / bool numpy arrays."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_frames)[:, None]
    cams = np.concatenate([i * [0.002, 0.004, 0.001], i * [0.05, 0.02, -0.8]], 1)
    cams = cams.astype(np.float32)
    pts = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 30, n_pts)], -1).astype(np.float32)
    obs = np.zeros((n_frames, n_pts, 4), np.float32)
    mask = np.zeros((n_frames, n_pts), bool)
    rot = so3_exp_f32(torch.from_numpy(cams[:, :3])).numpy()
    for w, cam in enumerate(cams):
        pc = pts @ rot[w].T + cam[3:6]
        z = pc[:, 2]
        ul = intr.fu * pc[:, 0] / z + intr.cu
        v = intr.fv * pc[:, 1] / z + intr.cv
        ur = intr.fu * (pc[:, 0] - baseline) / z + intr.cu
        obs[w] = np.stack([ul, v, ur, v], -1)
        mask[w] = (z > 1.0) & (ul > 0) & (ul < image_shape[1]) & (v > 0) & (v < image_shape[0])
    obs += rng.normal(scale=noise, size=obs.shape)
    return cams, pts, obs, mask


def perturb_ba_window(cams: np.ndarray, pts: np.ndarray, cam_scale: float = 0.01,
                      pt_scale: float = 0.3, seed: int = 13):
    """The window's BA start: every camera but the first two moved by
    N(0, ``cam_scale``), every point by N(0, ``pt_scale``); float32."""
    rng = np.random.default_rng(seed)
    cams_p = cams.copy()
    cams_p[2:] += rng.normal(scale=cam_scale, size=cams_p[2:].shape)
    pts_p = pts + rng.normal(scale=pt_scale, size=pts.shape)
    return cams_p.astype(np.float32), pts_p.astype(np.float32)


def ba_windows(intr, baseline: float, seeds: list[int], n_frames: int, n_pts: int, noise: float,
               image_shape: tuple[int, int]):
    """For each seed s, ``ba_window(seed=s)`` started from
    ``perturb_ba_window(seed=s + 100)``, stacked: (start cams
    (K, n_frames, 6), start points (K, n_pts, 3), obs, mask). The same
    draws and the same float32 arithmetic, with the projections of every
    window made at once: only the seeded draws stay one window at a time."""
    k, w, m = len(seeds), n_frames, n_pts
    i = np.arange(w)[:, None]
    cams = np.concatenate([i * [0.002, 0.004, 0.001], i * [0.05, 0.02, -0.8]], 1).astype(np.float32)
    pts = np.empty((k, m, 3), np.float32)
    obs_noise, cam_noise, pt_noise = np.empty((k, w, m, 4)), np.empty((k, w - 2, 6)), np.empty((k, m, 3))
    for j, s in enumerate(seeds):
        rng = np.random.default_rng(s)
        pts[j] = np.stack([rng.uniform(-8, 8, m), rng.uniform(-3, 3, m), rng.uniform(8, 30, m)], -1)
        obs_noise[j] = rng.normal(scale=noise, size=(w, m, 4))
        rng = np.random.default_rng(s + 100)
        cam_noise[j] = rng.normal(scale=0.01, size=(w - 2, 6))
        pt_noise[j] = rng.normal(scale=0.3, size=(m, 3))
    obs = np.zeros((k, w, m, 4), np.float32)
    mask = np.zeros((k, w, m), bool)
    rot = so3_exp_f32(torch.from_numpy(cams[:, :3])).numpy()
    flat = pts.reshape(-1, 3)
    for f, cam in enumerate(cams):
        pc = flat @ rot[f].T + cam[3:6]
        z = pc[:, 2]
        ul = intr.fu * pc[:, 0] / z + intr.cu
        v = intr.fv * pc[:, 1] / z + intr.cv
        ur = intr.fu * (pc[:, 0] - baseline) / z + intr.cu
        obs[:, f] = np.stack([ul, v, ur, v], -1).reshape(k, m, 4)
        mask[:, f] = ((z > 1.0) & (ul > 0) & (ul < image_shape[1]) & (v > 0)
                      & (v < image_shape[0])).reshape(k, m)
    obs += obs_noise
    cams_p = np.repeat(cams[None], k, 0)
    cams_p[:, 2:] += cam_noise
    return cams_p, (pts + pt_noise).astype(np.float32), obs, mask
