"""Image operations: pyramids, gradients, corner response, grid detection,
sampling. Port of ``uasl_motion_estimation_tpu/ops/image.py`` (the subset on
the staged stereo-VO path).

Every function takes images ``(..., H, W)`` float32 with any leading batch
dims (the sequence scan's chunk steps) and points ``(..., N, 2)`` as
``[x, y]``, as the JAX functions do under ``vmap``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels.gather import gather_tiles


def _edge_pad(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Replicate the first/last slice ``r`` times along ``dim`` (jnp.pad
    mode="edge" along one axis, for any rank)."""
    n = img.shape[dim]
    shape = list(img.shape)
    shape[dim] = r
    first = img.narrow(dim, 0, 1).expand(shape)
    last = img.narrow(dim, n - 1, 1).expand(shape)
    return torch.cat([first, img, last], dim=dim)


def _filter1d(img: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Small 1-D FIR filter along ``dim``, SAME size, edge replicated; the
    shifted-add sum of the JAX version, term by term in the same order."""
    taps = np.asarray(taps, dtype=np.float64)
    r = len(taps) // 2
    p = _edge_pad(img, r, dim) if r else img
    n = img.shape[dim]
    out = None
    for i, t in enumerate(taps):
        term = float(t) * p.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def _sep_filter(img: torch.Tensor, k_row, k_col) -> torch.Tensor:
    """Separable filter: k_col applied along rows, k_row along columns."""
    return _filter1d(_filter1d(img, k_col, -2), k_row, -1)


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def gaussian_blur5(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (Burt-Adelson pyramid kernel)."""
    return _sep_filter(img, _BINOMIAL5, _BINOMIAL5)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimation (cv2.pyrDown semantics); contiguous, so the
    level can go straight to the gather kernel."""
    return gaussian_blur5(img)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, n_levels: int) -> list[torch.Tensor]:
    """Gaussian pyramid, level 0 = full resolution."""
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx, gy), cv2.Sobel ksize=3 normalization."""
    smooth = np.array([1.0, 2.0, 1.0])
    diff = np.array([-1.0, 0.0, 1.0])
    return _sep_filter(img, diff, smooth), _sep_filter(img, smooth, diff)


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    k = np.ones(2 * radius + 1) / (2 * radius + 1)
    return _sep_filter(img, k, k)


def shi_tomasi_response(img: torch.Tensor, window_radius: int = 2) -> torch.Tensor:
    """GFTT min-eigenvalue corner response of the box-filtered structure
    tensor [a b; b c]: (a+c)/2 - sqrt(((a-c)/2)^2 + b^2)."""
    gx, gy = sobel(img)
    a = _box_filter(gx * gx, window_radius)
    b = _box_filter(gx * gy, window_radius)
    c = _box_filter(gy * gy, window_radius)
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return half_tr - disc


def subpixel_peak_2d(patch3: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel offset (dx, dy) from (..., 3, 3) score patches
    (nonMaxSupScanline3x3's parabola fit, feature_types.cpp:330-349)."""
    dx = 0.5 * (patch3[..., 1, 2] - patch3[..., 1, 0])
    dy = 0.5 * (patch3[..., 2, 1] - patch3[..., 0, 1])
    dxx = patch3[..., 1, 2] - 2.0 * patch3[..., 1, 1] + patch3[..., 1, 0]
    dyy = patch3[..., 2, 1] - 2.0 * patch3[..., 1, 1] + patch3[..., 0, 1]
    off_x = torch.where(torch.abs(dxx) > 1e-9, -dx / dxx, torch.zeros_like(dx))
    off_y = torch.where(torch.abs(dyy) > 1e-9, -dy / dyy, torch.zeros_like(dy))
    return torch.stack([torch.clamp(off_x, -0.5, 0.5),
                        torch.clamp(off_y, -0.5, 0.5)], dim=-1)


def _grid_shape(h: int, w: int, max_features: int) -> tuple[int, int]:
    """(rows, cols) of the bucket grid: ~square cells, rows*cols <= budget."""
    gh = max(1, int(round((max_features * h / w) ** 0.5)))
    gw = max(1, max_features // gh)
    while gh * gw > max_features:  # pragma: no cover - round() guard
        gw -= 1
    return gh, gw


def detect_features_grid(
    img: torch.Tensor,
    max_features: int = 500,
    quality_level: float = 0.01,
    border: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GFTT detection by grid bucketing: best strict 3x3 local maximum per
    cell, border and quality gates (feature_types.cpp:253-351 semantics).

    Returns (xy (..., max_features, 2) float32, scores, valid); cells beyond
    the grid and textureless cells are invalid."""
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    raw = shi_tomasi_response(img)
    # reduce_window max with SAME padding == max_pool2d padded with -inf
    pooled = F.max_pool2d(raw.reshape(-1, 1, h, w), 3, stride=1, padding=1)
    pooled = pooled.reshape(raw.shape)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    neg_inf = torch.tensor(-torch.inf, dtype=raw.dtype, device=raw.device)
    resp = torch.where((raw >= pooled) & in_border, raw, neg_inf)

    gh, gw = _grid_shape(h, w, max_features)
    ch = -(-h // gh)
    cw = -(-w // gw)
    resp_p = F.pad(resp, (0, gw * cw - w, 0, gh * ch - h), value=-torch.inf)
    cells = resp_p.reshape(*lead, gh, ch, gw, cw).transpose(-3, -2).reshape(
        *lead, gh * gw, ch * cw)
    best = torch.argmax(cells, dim=-1)  # first maximum, as jnp.argmax
    scores = torch.gather(cells, -1, best[..., None])[..., 0]
    cell_idx = torch.arange(gh * gw, device=img.device)
    y = (cell_idx // gw) * ch + best // cw
    x = (cell_idx % gw) * cw + best % cw

    xy_i = torch.stack([x, y], dim=-1).to(torch.float32)
    patches = extract_patches(raw, xy_i, 1)
    xy = xy_i + subpixel_peak_2d(patches)
    smax = torch.amax(scores, dim=-1, keepdim=True)
    valid = torch.isfinite(scores) & (scores > quality_level * smax)

    pad = max_features - gh * gw
    if pad > 0:
        xy = torch.cat([xy, xy.new_zeros(*lead, pad, 2)], dim=-2)
        scores = torch.cat([scores, scores.new_full((*lead, pad), -torch.inf)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(*lead, pad)], dim=-1)
    return xy, scores, valid


def _gather_points(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
                   ) -> torch.Tensor:
    """img[..., yi, xi] with yi/xi of shape lead + rest (one image per lead)."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h * w)
    lin = (yi.long() * w + xi.long()).reshape(flat.shape[0], -1)
    return torch.gather(flat, 1, lin).reshape(yi.shape)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of img (..., H, W) at float [x, y] locations
    (..., M..., 2); out-of-bounds coordinates clamp to the edge."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    if xy.shape[:len(lead)] != lead:
        raise ValueError("bilinear_sample: points must share the image's leading dims")
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = _gather_points(img, y0, x0)
    v01 = _gather_points(img, y0, x0 + 1)
    v10 = _gather_points(img, y0 + 1, x0)
    v11 = _gather_points(img, y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, radius: int
                    ) -> torch.Tensor:
    """Bilinear (2r+1)x(2r+1) patches around float centers (..., N, 2)."""
    k = 2 * radius + 1
    r = torch.arange(k, dtype=img.dtype, device=img.device) - radius
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx, dy], dim=-1)  # (k, k, 2) as (x, y)
    return bilinear_sample(img, centers[..., :, None, None, :] + offs)


def extract_tiles(img: torch.Tensor, anchors: torch.Tensor, size: int,
                  size_w: int | None = None) -> torch.Tensor:
    """Integer (size x size_w) tiles at top-left ``anchors`` (..., N, 2)
    int32 [x, y]; out-of-bounds reads come from edge replication. Goes
    through the tile-gather kernel K1 (ops/kernels/gather.py)."""
    size_w = size if size_w is None else size_w
    return gather_tiles(img.contiguous(), anchors.to(torch.int32).contiguous(),
                        size, size_w)


def sample_tiles(tiles: torch.Tensor, offsets: torch.Tensor, kh: int,
                 kw: int | None = None) -> torch.Tensor:
    """Bilinear (kh x kw) patches of (..., N, Sh, Sw) tiles at float top-left
    ``offsets`` (..., N, 2) [x, y] in tile coordinates, as two small batched
    matmuls: patch = Wy @ tile @ Wx^T with tent weights
    Wy[i, s] = max(0, 1 - |(y0 + i) - s|). Offsets are clamped so the patch
    stays inside the tile."""
    kw = kh if kw is None else kw
    sh, sw = tiles.shape[-2:]
    dtype, dev = tiles.dtype, tiles.device
    ox = torch.clamp(offsets[..., 0], 0.0, float(sw - kw))
    oy = torch.clamp(offsets[..., 1], 0.0, float(sh - kh))
    iy = torch.arange(kh, dtype=dtype, device=dev)
    ix = torch.arange(kw, dtype=dtype, device=dev)
    ssh = torch.arange(sh, dtype=dtype, device=dev)
    ssw = torch.arange(sw, dtype=dtype, device=dev)
    wy = torch.clamp(1.0 - torch.abs(oy[..., None, None] + iy[:, None] - ssh), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(ox[..., None, None] + ix[:, None] - ssw), min=0.0)
    return torch.matmul(torch.matmul(wy, tiles), wx.transpose(-1, -2))


def extract_patches_sep(img: torch.Tensor, centers: torch.Tensor, radius: int
                        ) -> torch.Tensor:
    """Drop-in for extract_patches: one integer tile gather + separable
    bilinear matmuls instead of 4 scattered taps per pixel."""
    h, w = img.shape[-2:]
    k = 2 * radius + 1
    x = torch.clamp(centers[..., 0], 0.0, w - 1.0)
    y = torch.clamp(centers[..., 1], 0.0, h - 1.0)
    ax = torch.floor(x).to(torch.int32) - radius
    ay = torch.floor(y).to(torch.int32) - radius
    tiles = extract_tiles(img, torch.stack([ax, ay], dim=-1), k + 1)
    offs = torch.stack([x - ax.to(img.dtype) - radius,
                        y - ay.to(img.dtype) - radius], dim=-1)
    return sample_tiles(tiles, offs, k)


def patch_in_bounds(centers: torch.Tensor, radius: float, h: int, w: int
                    ) -> torch.Tensor:
    """(..., N) bool: whole patch inside the image (bb.contains,
    optimisation.cpp:155, 183)."""
    x, y = centers[..., 0], centers[..., 1]
    return (x >= radius) & (x < w - radius - 1) & (y >= radius) & (y < h - radius - 1)
