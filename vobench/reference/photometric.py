"""Plain reference of the front end's two photometric conditions, in float64.

A tracked point q of a feature at p is where the next image's window
matches the previous image's window: the zero-mean window difference has no
component along the template's gradients, so the Lucas-Kanade step from q
is zero. A right match r of a left point l is where the right window
matches the left one along the row: the 1-D step along x, with the right
window's gradient, is zero. Each function returns the length of the step
the reference would still take from the given positions, with the
definitions the port's front end states (11 x 11 windows, bilinear
sampling with edge replication, Scharr gradients of the 13 x 13 window,
zero-mean differences).
"""

from __future__ import annotations

import torch


def _window(img: torch.Tensor, pts: torch.Tensor, r: int) -> torch.Tensor:
    """(B, N, 2r+1, 2r+1) bilinear windows of images (B, H, W) centred at
    pts (B, N, 2) [x, y], edge-replicated, float64."""
    B, H, W = img.shape
    img = img.to(torch.float64).reshape(B, -1)
    off = torch.arange(-r, r + 1, dtype=torch.float64, device=pts.device)
    x = pts[..., 0, None].double() + off  # (B, N, k)
    y = pts[..., 1, None].double() + off
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None, :], (y - y0)[..., :, None]
    xi = [torch.clamp(x0 + d, 0, W - 1).long() for d in (0, 1)]
    yi = [torch.clamp(y0 + d, 0, H - 1).long() for d in (0, 1)]

    def at(yy, xx):
        lin = yy[..., :, None] * W + xx[..., None, :]  # (B, N, k, k)
        return torch.gather(img, 1, lin.reshape(B, -1)).reshape(lin.shape)

    return ((1 - fy) * ((1 - fx) * at(yi[0], xi[0]) + fx * at(yi[0], xi[1]))
            + fy * ((1 - fx) * at(yi[1], xi[0]) + fx * at(yi[1], xi[1])))


def _grads(big: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr x and y gradients of the interior of (..., k+2, k+2) windows."""
    sy = (3.0 * big[..., :-2, :] + 10.0 * big[..., 1:-1, :] + 3.0 * big[..., 2:, :]) / 16.0
    sx = (3.0 * big[..., :, :-2] + 10.0 * big[..., :, 1:-1] + 3.0 * big[..., :, 2:]) / 16.0
    return (sy[..., :, 2:] - sy[..., :, :-2]) * 0.5, (sx[..., 2:, :] - sx[..., :-2, :]) * 0.5


def _zero_mean(e: torch.Tensor) -> torch.Tensor:
    return e - torch.mean(e, dim=(-2, -1), keepdim=True)


def klt_step(prev: torch.Tensor, nxt: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
             r: int = 5) -> torch.Tensor:
    """|Lucas-Kanade step| (B, N) at q in ``nxt`` for the template at p in
    ``prev`` (images (B, H, W), points (B, N, 2))."""
    big = _window(prev, p, r + 1)
    gx, gy = _grads(big)
    err = _zero_mean(_window(nxt, q, r) - big[..., 1:-1, 1:-1])
    a11, a12, a22 = (gx * gx).sum((-2, -1)), (gx * gy).sum((-2, -1)), (gy * gy).sum((-2, -1))
    b1, b2 = (err * gx).sum((-2, -1)), (err * gy).sum((-2, -1))
    det = a11 * a22 - a12 * a12
    dx = -(a22 * b1 - a12 * b2) / det
    dy = -(a11 * b2 - a12 * b1) / det
    return torch.hypot(dx, dy)


def stereo_step(left: torch.Tensor, right: torch.Tensor, pl: torch.Tensor, pr: torch.Tensor,
                r: int = 5) -> torch.Tensor:
    """|1-D step along x| (B, N) at pr in ``right`` for the template at pl
    in ``left``."""
    tpl = _window(left, pl, r)
    big = _window(right, pr, r + 1)
    g, _ = _grads(big)
    err = _zero_mean(big[..., 1:-1, 1:-1] - tpl)
    return torch.abs((err * g).sum((-2, -1)) / torch.clamp((g * g).sum((-2, -1)), min=1e-6))
