"""Joint-histogram mutual information (kernel K2): CUDA kernel wrapper and its
plain PyTorch versions.

Replaces the Pallas TPU kernel ``uasl_motion_estimation_tpu/ops/pallas/mi.py``
(``_mi_kernel``), the TPU branch of ``ops/similarity.py::
mutual_information_batched``. The CUDA source is ``csrc/mi_hist.cu``; its
design note (sparse exact counts, bound by shared-memory operations) is in
the source. Two modes:

- ``mi_pairs``: pair ``q`` scores ``qa[q // rep]`` against ``qb[q]`` (int32
  ids, ids outside [0, bins) dropped). The scale LM and the router use it.
- ``mi_strip``: the MI matcher. Feature ``f`` scores its left patch ``qa[f]``
  against each window of its right strip ``strip[f]`` (uint8 ids): candidate
  ``d`` is the window at columns [D-1-d, D-1-d+k).

Each takes the plain version for a CPU tensor and launches the kernel for a
CUDA tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import build_library

SOURCE = "mi_hist.cu"
MAX_BINS = 32
MAX_STRIP_PIXELS = 256  # k * k in strip mode: at most 8 pixels per lane
MAX_PAIR_PIXELS = 512  # P in pair mode: at most 16 pixels per lane


class _MIKernel:
    """Lazily built ctypes bindings of ``mi_hist_pairs`` and ``mi_hist_strip``
    plus their launch counts (one per launch, nowhere else): ``launches``
    counts both modes, ``strip_launches`` the strip mode alone."""

    def __init__(self):
        self.launches = 0
        self.strip_launches = 0
        self._pairs = None
        self._strip = None

    def load(self):
        if self._pairs is None:
            lib = ctypes.CDLL(str(build_library(SOURCE)))
            ptrs = [ctypes.c_void_p] * 3
            self._pairs = lib.mi_hist_pairs
            self._pairs.argtypes = ptrs + [ctypes.c_int64] + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            self._pairs.restype = ctypes.c_int
            self._strip = lib.mi_hist_strip
            self._strip.argtypes = ptrs + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            self._strip.restype = ctypes.c_int
        return self._pairs, self._strip

    @staticmethod
    def _launch(name, fn, dev, *args):
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    def __call__(self, qa: torch.Tensor, qb: torch.Tensor, rep: int, n_valid: int,
                 bins: int) -> torch.Tensor:
        n_pairs, p = qb.shape
        out = torch.empty((n_pairs,), dtype=torch.float32, device=qb.device)
        self._launch("mi_hist_pairs", self.load()[0], qb.device, qa.data_ptr(),
                     qb.data_ptr(), out.data_ptr(), n_pairs, rep, p, bins, n_valid)
        self.launches += 1
        return out

    def strip(self, qa: torch.Tensor, strip: torch.Tensor, bins: int) -> torch.Tensor:
        n_feat, k, s = strip.shape
        n_disp = s - k + 1
        out = torch.empty((n_feat, n_disp), dtype=torch.float32, device=strip.device)
        self._launch("mi_hist_strip", self.load()[1], strip.device, qa.data_ptr(),
                     strip.data_ptr(), out.data_ptr(), n_feat, k, n_disp, bins)
        self.launches += 1
        self.strip_launches += 1
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
    if n_valid < 1 or not 1 <= qa.shape[1] <= MAX_PAIR_PIXELS:
        raise ValueError(f"mi_pairs: n_valid {n_valid} must be >= 1 and P {qa.shape[1]} in "
                         f"[1, {MAX_PAIR_PIXELS}]")


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


def strip_windows(strip: torch.Tensor, k: int) -> torch.Tensor:
    """(A, k, D + k - 1) strips -> (A, D, k, k) windows indexed by candidate
    ``d``: window ``d`` is columns [D-1-d, D-1-d+k), so it sits at x - d."""
    win = strip.unfold(-1, k, 1)  # (A, k, D, k): win[a, i, t, j] = strip[a, i, t + j]
    return win.permute(0, 2, 1, 3).flip(1)


def mi_strip_plain(qa: torch.Tensor, strip: torch.Tensor, bins: int) -> torch.Tensor:
    """Plain PyTorch K2 strip mode: the strip unfolded into its D windows,
    indexed by ``d``, then ``mi_pairs_plain`` with ``rep = D``."""
    n_feat, k, s = strip.shape
    n_disp = s - k + 1
    qb = strip_windows(strip, k).reshape(n_feat * n_disp, k * k)
    return mi_pairs_plain(qa, qb, n_disp, k * k, bins).reshape(n_feat, n_disp)


def _check_strip(qa: torch.Tensor, strip: torch.Tensor, bins: int):
    if qa.dtype != torch.uint8 or strip.dtype != torch.uint8:
        raise TypeError(f"mi_strip: ids must be uint8, got {qa.dtype} and {strip.dtype}")
    if strip.ndim != 3 or qa.ndim != 2 or qa.shape != (strip.shape[0], strip.shape[1] ** 2):
        raise ValueError(f"mi_strip: want qa (A, k * k) and strip (A, k, D + k - 1), got "
                         f"{tuple(qa.shape)} and {tuple(strip.shape)}")
    k = strip.shape[1]
    if not 1 <= k * k <= MAX_STRIP_PIXELS or strip.shape[2] < k:
        raise ValueError(f"mi_strip: k {k} (k * k <= {MAX_STRIP_PIXELS}) and strip width "
                         f"{strip.shape[2]} (>= k) out of range")
    if qa.device != strip.device:
        raise ValueError(f"mi_strip: qa on {qa.device}, strip on {strip.device}")
    if not (qa.is_contiguous() and strip.is_contiguous()):
        raise ValueError("mi_strip: qa and strip must be contiguous")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"mi_strip: bins must lie in [1, {MAX_BINS}], got {bins}")


def mi_strip(qa: torch.Tensor, strip: torch.Tensor, bins: int = 20) -> torch.Tensor:
    """(A, D) MI in bits of each left patch ``qa`` (A, k * k) uint8 against
    the D windows of its strip ``strip`` (A, k, D + k - 1) uint8; window
    ``d`` is columns [D-1-d, D-1-d+k). Ids must lie in [0, bins): a CPU
    tensor with any other id raises, and the kernel gives that feature NaN
    scores."""
    _check_strip(qa, strip, bins)
    if strip.device.type == "cpu":
        if any(t.numel() and int(t.max()) >= bins for t in (qa, strip)):
            raise ValueError(f"mi_strip: ids must lie in [0, {bins})")
        return mi_strip_plain(qa, strip, bins)
    if strip.device.type == "cuda":
        return MI.strip(qa, strip, bins)
    raise ValueError(f"mi_strip: no kernel for device {strip.device}")
