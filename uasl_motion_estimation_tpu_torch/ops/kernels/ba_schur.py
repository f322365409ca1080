"""Windowed BA's reduced camera system and step (kernel K3: kernels A and B).

Replaces no TPU kernel: the JAX package's ``solvers/ba.py`` is plain
``jnp``. The CUDA source is ``csrc/ba_schur.cu``; its note says what bounds
it and how the design meets that bound. Per LM iteration of
``solvers/ba.py`` ``ba_solve``:

- ``reduce`` (kernel A) returns each window's gauged, damped reduced camera
  system S (..., 6W, 6W), its right-hand side (..., 6W), the robust cost at
  the current state (...) and each point's V^-1 and bp (..., M, 12);
- ``step`` (kernel B) takes the cameras' update from the dense solve of S,
  back-substitutes the points, clamps their depths in the first camera and
  returns the new state, its robust cost and whether the update is finite.

Both take float32 CUDA tensors, and bool masks, contiguous and on one card.
Their plain version is ``solvers/ba.py``'s chain (``_reduce_plain``,
``_step_plain``), which ``solvers/ba.py`` runs for CPU tensors; a tensor on
any other device raises here.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ._build import build_library

SOURCE = "ba_schur.cu"
# S is held whole in the block's shared memory: (6W)^2 floats, 147 KB at
# W = 32. The port's callers run W = 3 (latency-mode tests), 5 (the
# integrated engine, the latency mode, the streaming engines, config 2),
# 6 (a pipeline test) and 10 (config 4, kitti-ba-windows).
MAX_FRAMES = 32


def bind(library: str | Path):
    """(``ba_reduce_f32``, ``ba_step_f32``) of a built library, with their
    argument types."""
    lib = ctypes.CDLL(str(library))
    reduce_fn, step_fn = lib.ba_reduce_f32, lib.ba_step_f32
    reduce_fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 7
                          + [ctypes.c_void_p])
    step_fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 8
                        + [ctypes.c_void_p])
    reduce_fn.restype = step_fn.restype = ctypes.c_int
    return reduce_fn, step_fn


class _BASchurKernel:
    """Lazily built ctypes bindings of kernels A and B plus their launch
    count (one per launch of either, nowhere else)."""

    def __init__(self):
        self.launches = 0
        self._fns = None

    def load(self):
        if self._fns is None:
            self._fns = bind(build_library(SOURCE))
        return self._fns

    def launch(self, which: int, device: torch.device, *args) -> None:
        fn = self.load()[which]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            name = ("ba_reduce_f32", "ba_step_f32")[which]
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.launches += 1


BA_SCHUR = _BASchurKernel()


_BOOLS = ("mask", "pt_valid", "done")


def _check(baseline: float, **tensors) -> tuple[tuple[int, ...], int, int, int]:
    """Raise on what the kernels do not take; returns (leading dims, W, M, R)."""
    for name, t in tensors.items():
        want = torch.bool if name in _BOOLS else torch.float32
        if t.dtype != want:
            raise TypeError(f"ba_schur: {name} must be {want}, got {t.dtype}")
    cam, obs = tensors["cam"], tensors["obs"]
    if cam.ndim < 2 or cam.shape[-1] != 6 or obs.ndim != cam.ndim + 1:
        raise ValueError(f"ba_schur: want cam (..., W, 6) and obs (..., W, M, R), got "
                         f"{tuple(cam.shape)} and {tuple(obs.shape)}")
    lead, W = tuple(cam.shape[:-2]), cam.shape[-2]
    M, R = obs.shape[-2:]
    tails = {"cam": (W, 6), "pts": (M, 3), "obs": (W, M, R), "mask": (W, M), "pt_valid": (M,),
             "lam": (), "done": (), "dcam": (W, 6), "aux": (M, 12)}
    for name, t in tensors.items():
        if tuple(t.shape) != lead + tails[name]:
            raise ValueError(f"ba_schur: {name} has shape {tuple(t.shape)}, want "
                             f"{lead + tails[name]}")
    if R != (4 if baseline > 0 else 2):
        raise ValueError(f"ba_schur: {R} residuals an observation with baseline {baseline}")
    if not 1 <= W <= MAX_FRAMES:
        raise ValueError(f"ba_schur: {W} frames a window; the kernels take 1 to {MAX_FRAMES}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"ba_schur: {name} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"ba_schur: no kernel for tensors on {sorted(map(str, devices))}")
    return lead, W, M, R


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def reduce(cam, pts, obs, mask, lam, done, pt_valid, *, intr, baseline: float,
           huber_delta: float, n_fixed: int, v_eps: float = 0.0, want_aux: bool = True):
    """Kernel A: (S (..., 6W, 6W), rhs (..., 6W), cost (...), aux (..., M, 12)
    or None). ``lam`` (...) damps U and V multiplicatively; ``v_eps`` is added
    to every valid point's V; ``done`` (..., or None) marks windows whose
    outputs are discarded (they get the identity system)."""
    opt = {} if done is None else {"done": done}
    lead, W, M, R = _check(baseline, cam=cam, pts=pts, obs=obs, mask=mask, pt_valid=pt_valid,
                           lam=lam, **opt)
    n = 6 * W
    S = torch.empty((*lead, n, n), dtype=cam.dtype, device=cam.device)
    rhs = torch.empty((*lead, n), dtype=cam.dtype, device=cam.device)
    cost = torch.empty(lead, dtype=cam.dtype, device=cam.device)
    out_aux = torch.empty((*lead, M, 12), dtype=cam.dtype, device=cam.device) if want_aux else None
    BA_SCHUR.launch(0, cam.device, cam.data_ptr(), pts.data_ptr(), obs.data_ptr(),
                    mask.data_ptr(), _ptr(done), pt_valid.data_ptr(), lam.data_ptr(),
                    S.data_ptr(), rhs.data_ptr(), cost.data_ptr(), _ptr(out_aux),
                    math.prod(lead), W, M, R, n_fixed, intr.fu, intr.fv, intr.cu, intr.cv,
                    baseline, huber_delta, v_eps)
    return S, rhs, cost, out_aux


def step(cam, pts, obs, mask, dcam, aux, done, pt_valid, *, intr, baseline: float,
         huber_delta: float, zlim: tuple[float, float] | None):
    """Kernel B: (cam_new (..., W, 6), pts_new (..., M, 3), cost_new (...),
    finite (...) bool). ``dcam`` (..., W, 6) is the cameras' update, ``aux``
    kernel A's; ``zlim`` (zmin, zmax) clamps the depths in the first camera
    after the step, None leaves them (mono)."""
    opt = {} if done is None else {"done": done}
    lead, W, M, R = _check(baseline, cam=cam, pts=pts, obs=obs, mask=mask, pt_valid=pt_valid,
                           dcam=dcam, aux=aux, **opt)
    cam_new, pts_new = torch.empty_like(cam), torch.empty_like(pts)
    cost = torch.empty(lead, dtype=cam.dtype, device=cam.device)
    finite = torch.empty(lead, dtype=torch.bool, device=cam.device)
    zmin, zmax = zlim if zlim is not None else (0.0, 0.0)
    BA_SCHUR.launch(1, cam.device, cam.data_ptr(), pts.data_ptr(), obs.data_ptr(),
                    mask.data_ptr(), _ptr(done), pt_valid.data_ptr(), dcam.data_ptr(),
                    aux.data_ptr(), cam_new.data_ptr(), pts_new.data_ptr(), cost.data_ptr(),
                    finite.data_ptr(), math.prod(lead), W, M, R, int(zlim is not None),
                    intr.fu, intr.fv, intr.cu, intr.cv, baseline, huber_delta, zmin, zmax)
    return cam_new, pts_new, cost, finite
