"""The card's peaks and the bytes a kernel must move, frozen here so that a
change to the program cannot change the yardstick.

``gather_bytes`` is a copy of the port's ``ops/kernels/gather.py``
``gather_bytes`` (kernel K1, the tile gather): every distinct image pixel
the tiles cover, read once; the anchors, read once; the tiles, written
once. It counts the same bytes whatever implements the gather.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at its 700 W limit
H100_HBM_BYTES_PER_S = 3.35e12


def _source_index(anchors: torch.Tensor, h: int, w: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """(..., N, tile_h, tile_w) index into the (h, w) image of the pixel each
    tile element copies (edge replication: clamped rows and columns)."""
    ax = torch.clamp(anchors[..., 0].long(), -tile_w, w - 1)
    ay = torch.clamp(anchors[..., 1].long(), -tile_h, h - 1)
    rows = torch.clamp(ay[..., None] + torch.arange(tile_h, device=anchors.device), 0, h - 1)
    cols = torch.clamp(ax[..., None] + torch.arange(tile_w, device=anchors.device), 0, w - 1)
    return rows[..., :, None] * w + cols[..., None, :]


def gather_bytes(anchors: torch.Tensor, h: int, w: int, tile_h: int, tile_w: int) -> int:
    """Bytes one K1 launch must move for (..., N, 2) int32 anchors into
    (..., h, w) float32 images."""
    n = anchors.shape[-2]
    anc = anchors.reshape(-1, n, 2)
    batch = anc.shape[0]
    lin = _source_index(anc, h, w, tile_h, tile_w).reshape(batch, -1)
    lin = lin + torch.arange(batch, device=lin.device)[:, None] * (h * w)
    seen = torch.zeros(batch * h * w, dtype=torch.bool, device=lin.device)
    seen[lin.reshape(-1)] = True
    return 4 * (int(seen.sum()) + anc.numel() + batch * n * tile_h * tile_w)
