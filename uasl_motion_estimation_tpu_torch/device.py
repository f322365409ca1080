"""Device selection and float32 precision policy.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise instead of quietly running on
the CPU.

The JAX reference pins full-f32 products wherever precision matters
(``ops/image.py`` sample_tiles, ``ops/stereo.py`` cross term,
``models/stereo_vo.py`` normal equations, ``ops/pnp.py`` triad alignment).
On Hopper the same hazard is TF32, which cuDNN convolutions use by default
and matmuls may be switched to: both are turned off here.

``const`` gives the small constant tensors that JAX folds into its jitted
programs: each is copied to the device once per (values, dtype, device)
and then reused, instead of once per call.
"""

from __future__ import annotations

import functools

import torch


def setup_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default: the CUDA card; raises when there is none)
    and pin full-f32 matmul and convolution arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card (torch.cuda.is_available() is False); pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _frozen(values):
    """Nested lists or tuples of numbers as nested tuples (hashable)."""
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once and cached: callers
    share the tensor and must not write to it."""
    return _const(_frozen(values), dtype, torch.device(device))
