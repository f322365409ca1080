"""ZNCC disparity cost volume. Port of ``uasl_motion_estimation_tpu/ops/stereo.py``.

For each feature, one horizontal strip of the right image covering every
candidate window (one tile gather, kernel K1) and one left template; window
moments from column sums and cumsum differencing, the cross term as one small
batched matmul per template column. Batched over leading dims.
"""

from __future__ import annotations

import torch

from . import image as im


def zncc_disparity_scores(
    left: torch.Tensor,
    right: torch.Tensor,
    feats_xy: torch.Tensor,
    max_disparity: int,
    radius: int,
    eps: float = 1e-6,
    d_offset: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., N, D) ZNCC score of each left feature (sampled at its nearest
    pixel) against right candidates at disparity ``d_offset + i`` for slot
    i in [0, max_disparity); out-of-image or negative-disparity candidates
    get -inf. ``d_offset`` (..., N) int32 defaults to 0."""
    h, w = left.shape[-2:]
    dtype = left.dtype
    d_max = max_disparity
    r = radius
    k = 2 * r + 1
    npix = k * k

    # torch.round is round-half-to-even, as jnp.round
    xi = torch.clamp(torch.round(feats_xy[..., 0]).to(torch.int32), 0, w - 1)
    yi = torch.clamp(torch.round(feats_xy[..., 1]).to(torch.int32), 0, h - 1)
    if d_offset is None:
        d_offset = torch.zeros_like(xi)

    strip_w = d_max + 2 * r
    strip_anchor = torch.stack([xi - d_offset - (d_max - 1) - r, yi - r], dim=-1)
    strip = im.extract_tiles(right, strip_anchor, k, strip_w)  # (..., N, K, S)

    tpl = im.extract_tiles(left, torch.stack([xi - r, yi - r], dim=-1), k)
    tpl0 = tpl - torch.mean(tpl, dim=(-2, -1), keepdim=True)
    tnorm = torch.sqrt(torch.clamp(torch.sum(tpl0 * tpl0, dim=(-2, -1)), min=eps))

    # centred at 128 so the f32 cumsums keep ~1e-5 relative precision
    strip_c = strip - 128.0
    col1 = torch.sum(strip_c, dim=-2)  # (..., N, S)
    col2 = torch.sum(strip_c * strip_c, dim=-2)
    zero = torch.zeros_like(col1[..., :1])
    cs1 = torch.cat([zero, torch.cumsum(col1, dim=-1)], dim=-1)
    cs2 = torch.cat([zero, torch.cumsum(col2, dim=-1)], dim=-1)
    s1 = cs1[..., k:k + d_max] - cs1[..., :d_max]
    s2 = cs2[..., k:k + d_max] - cs2[..., :d_max]
    var_n = torch.clamp(s2 - s1 * s1 / npix, min=eps)  # npix * var

    # cross term per template column; Sum(tpl0) = 0 cancels the window mean
    corr = 0
    for c in range(k):
        corr = corr + torch.matmul(tpl0[..., None, :, c],
                                   strip_c[..., :, c:c + d_max])[..., 0, :]

    z = corr / (torch.sqrt(var_n) * tnorm[..., None])
    z = torch.flip(z, dims=(-1,))  # slot t = D-1-d  ->  index by d

    d_range = torch.arange(d_max, dtype=torch.int32, device=left.device)
    d_abs = d_offset[..., None] + d_range
    ok = (
        (d_abs >= 0)
        & ((xi[..., None] - d_abs - r) >= 0)
        & ((xi + r) < w)[..., None]
        & ((yi - r) >= 0)[..., None]
        & ((yi + r) < h)[..., None]
    )
    return torch.where(ok, z, torch.full_like(z, -torch.inf)).to(dtype)
