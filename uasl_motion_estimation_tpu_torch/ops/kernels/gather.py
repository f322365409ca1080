"""Tile gather (kernel K1): CUDA kernel wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``uasl_motion_estimation_tpu/ops/pallas/gather.py``
(``_gather_kernel``), the TPU branch of ``ops/image.py::extract_tiles``. The
CUDA source is ``csrc/gather_tiles.cu``; it is bound by bytes (a copy), and
its design note is in the source.

``gather_tiles`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import build_library

SOURCE = "gather_tiles.cu"


class _GatherKernel:
    """Lazily built ctypes binding of ``gather_tiles_f32`` plus its launch
    count (one per launch, nowhere else)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_library(SOURCE)))
            fn = lib.gather_tiles_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.argtypes += [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, img: torch.Tensor, anchors: torch.Tensor, tile_h: int,
                 tile_w: int) -> torch.Tensor:
        batch, h, w = img.shape
        n = anchors.shape[1]
        out = torch.empty((batch, n, tile_h, tile_w), dtype=img.dtype,
                          device=img.device)
        fn = self.load()
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = fn(img.data_ptr(), anchors.data_ptr(), out.data_ptr(),
                     batch, h, w, n, tile_h, tile_w, stream)
        if err != 0:
            raise RuntimeError(f"gather_tiles_f32 launch failed: CUDA error {err}")
        self.launches += 1
        return out


GATHER = _GatherKernel()


def gather_tiles_plain(img: torch.Tensor, anchors: torch.Tensor, tile_h: int,
                       tile_w: int) -> torch.Tensor:
    """Plain PyTorch K1 on (B, H, W) images and (B, N, 2) anchors: edge
    replication as clamped row/column indices (the same values as an
    edge-padded image indexed at the shifted anchors)."""
    batch, h, w = img.shape
    n = anchors.shape[1]
    ax = torch.clamp(anchors[..., 0].long(), -tile_w, w - 1)
    ay = torch.clamp(anchors[..., 1].long(), -tile_h, h - 1)
    rows = torch.clamp(ay[..., None] + torch.arange(tile_h, device=img.device), 0, h - 1)
    cols = torch.clamp(ax[..., None] + torch.arange(tile_w, device=img.device), 0, w - 1)
    lin = rows[..., :, None] * w + cols[..., None, :]  # (B, N, th, tw)
    out = torch.gather(img.reshape(batch, h * w), 1, lin.reshape(batch, -1))
    return out.reshape(batch, n, tile_h, tile_w)


def _check(img: torch.Tensor, anchors: torch.Tensor, tile_h: int, tile_w: int):
    if img.dtype != torch.float32:
        raise TypeError(f"gather_tiles: image must be float32, got {img.dtype}")
    if anchors.dtype != torch.int32:
        raise TypeError(f"gather_tiles: anchors must be int32, got {anchors.dtype}")
    if img.ndim < 2 or anchors.ndim != img.ndim or anchors.shape[-1] != 2:
        raise ValueError(
            f"gather_tiles: want image (..., H, W) and anchors (..., N, 2), "
            f"got {tuple(img.shape)} and {tuple(anchors.shape)}")
    if img.shape[:-2] != anchors.shape[:-2]:
        raise ValueError(
            f"gather_tiles: leading dims differ: {tuple(img.shape[:-2])} vs "
            f"{tuple(anchors.shape[:-2])}")
    if img.device != anchors.device:
        raise ValueError(f"gather_tiles: image on {img.device}, anchors on {anchors.device}")
    if not (img.is_contiguous() and anchors.is_contiguous()):
        raise ValueError("gather_tiles: image and anchors must be contiguous")
    if tile_h < 1 or tile_w < 1 or img.shape[-1] < 1 or img.shape[-2] < 1:
        raise ValueError("gather_tiles: empty image or tile")


def gather_tiles(img: torch.Tensor, anchors: torch.Tensor, tile_h: int,
                 tile_w: int) -> torch.Tensor:
    """(..., N, tile_h, tile_w) tiles of ``img`` (..., H, W) at integer
    top-left corners ``anchors`` (..., N, 2) int32 [x, y]; out-of-bounds
    reads are edge-replicated. Leading dims are a batch (one image each)."""
    _check(img, anchors, tile_h, tile_w)
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    n = anchors.shape[-2]
    img3 = img.reshape(-1, h, w)
    anc3 = anchors.reshape(-1, n, 2)
    if img.device.type == "cpu":
        out = gather_tiles_plain(img3, anc3, tile_h, tile_w)
    elif img.device.type == "cuda":
        if img3.shape[0] > 65535:
            raise ValueError("gather_tiles: batch above 65535")
        out = GATHER(img3, anc3, tile_h, tile_w)
    else:
        raise ValueError(f"gather_tiles: no kernel for device {img.device}")
    return out.reshape(*lead, n, tile_h, tile_w)
