"""Joint-histogram mutual information (kernel K2): CUDA kernel wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``uasl_motion_estimation_tpu/ops/pallas/mi.py``
(``_mi_kernel``), the TPU branch of ``ops/similarity.py::
mutual_information_batched``. The CUDA source is ``csrc/mi_hist.cu``; it is
bound by bytes (the ids it reads), and its design note is in the source.

Pair ``b`` scores ``qa[b // rep]`` against ``qb[b]``. ``mi_pairs`` takes the
plain version for a CPU tensor and launches the kernel for a CUDA tensor;
there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import build_library

SOURCE = "mi_hist.cu"
MAX_BINS = 32


class _MIKernel:
    """Lazily built ctypes binding of ``mi_hist_pairs`` plus its launch count
    (one per launch, nowhere else)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_library(SOURCE)))
            fn = lib.mi_hist_pairs
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, qa: torch.Tensor, qb: torch.Tensor, rep: int, n_valid: int,
                 bins: int) -> torch.Tensor:
        n_pairs, p = qb.shape
        out = torch.empty((n_pairs,), dtype=torch.float32, device=qb.device)
        fn = self.load()
        with torch.cuda.device(qb.device):
            stream = torch.cuda.current_stream(qb.device).cuda_stream
            err = fn(qa.data_ptr(), qb.data_ptr(), out.data_ptr(), n_pairs, rep, p,
                     bins, n_valid, stream)
        if err != 0:
            raise RuntimeError(f"mi_hist_pairs launch failed: CUDA error {err}")
        self.launches += 1
        return out


MI = _MIKernel()


def mi_from_joint(pj: torch.Tensor) -> torch.Tensor:
    """MI in bits from (..., bins, bins) normalised joint histograms (row =
    id of a), with the marginals summed from ``pj``, over the cells where
    pj > 0 and pa * pb > 0."""
    pa = torch.sum(pj, dim=-1, keepdim=True)
    pb = torch.sum(pj, dim=-2, keepdim=True)
    denom = pa * pb
    valid = (pj > 0) & (denom > 0)
    ratio = torch.where(valid, pj / torch.where(valid, denom, torch.ones_like(denom)),
                        torch.ones_like(pj))
    return torch.sum(torch.where(valid, pj * torch.log2(ratio), torch.zeros_like(pj)),
                     dim=(-2, -1))


def mi_pairs_plain(qa: torch.Tensor, qb: torch.Tensor, rep: int, n_valid: int,
                   bins: int) -> torch.Tensor:
    """Plain PyTorch K2: scatter_add of ``qa * bins + qb`` into (B, bins^2)
    counts, pixels with an id outside [0, bins) masked out, then the MI of
    the counts over ``n_valid``."""
    a = qa.long().repeat_interleave(rep, dim=0) if rep > 1 else qa.long()
    b = qb.long()
    keep = (a >= 0) & (a < bins) & (b >= 0) & (b < bins)
    idx = torch.where(keep, a * bins + b, torch.zeros_like(a))
    counts = torch.zeros((b.shape[0], bins * bins), dtype=torch.float32, device=qb.device)
    counts.scatter_add_(1, idx, keep.to(torch.float32))
    return mi_from_joint(counts.reshape(-1, bins, bins) / float(n_valid))


def _check(qa: torch.Tensor, qb: torch.Tensor, rep: int, n_valid: int, bins: int):
    if qa.dtype != torch.int32 or qb.dtype != torch.int32:
        raise TypeError(f"mi_pairs: ids must be int32, got {qa.dtype} and {qb.dtype}")
    if qa.ndim != 2 or qb.ndim != 2 or qa.shape[1] != qb.shape[1]:
        raise ValueError(f"mi_pairs: want qa (A, P) and qb (A * rep, P), got "
                         f"{tuple(qa.shape)} and {tuple(qb.shape)}")
    if rep < 1 or qa.shape[0] * rep != qb.shape[0]:
        raise ValueError(f"mi_pairs: qb has {qb.shape[0]} rows, qa {qa.shape[0]} x rep {rep}")
    if qa.device != qb.device:
        raise ValueError(f"mi_pairs: qa on {qa.device}, qb on {qb.device}")
    if not (qa.is_contiguous() and qb.is_contiguous()):
        raise ValueError("mi_pairs: qa and qb must be contiguous")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"mi_pairs: bins must lie in [1, {MAX_BINS}], got {bins}")
    if n_valid < 1 or qa.shape[1] < 1:
        raise ValueError(f"mi_pairs: n_valid {n_valid} and P {qa.shape[1]} must be >= 1")


def mi_pairs(qa: torch.Tensor, qb: torch.Tensor, rep: int = 1, n_valid: int | None = None,
             bins: int = 20) -> torch.Tensor:
    """(A * rep,) MI in bits of quantised patch pairs: ``qa`` (A, P) int32
    scored against each of ``rep`` consecutive rows of ``qb`` (A * rep, P)
    int32, normalised by ``n_valid`` (default P). An id outside [0, bins)
    drops its pixel from the histogram."""
    n_valid = qa.shape[-1] if n_valid is None else int(n_valid)
    _check(qa, qb, rep, n_valid, bins)
    if qb.device.type == "cpu":
        return mi_pairs_plain(qa, qb, rep, n_valid, bins)
    if qb.device.type == "cuda":
        return MI(qa, qb, rep, n_valid, bins)
    raise ValueError(f"mi_pairs: no kernel for device {qb.device}")
