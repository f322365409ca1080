"""Device selection and float32 precision policy.

The JAX reference pins full-f32 products wherever precision matters
(``ops/image.py`` sample_tiles, ``ops/stereo.py`` cross term,
``models/stereo_vo.py`` normal equations, ``ops/pnp.py`` triad alignment).
On Hopper the same hazard is TF32, which cuDNN convolutions use by default
and matmuls may be switched to: both are turned off here.
"""

from __future__ import annotations

import torch


def setup_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default: the first CUDA card if there is one,
    else the CPU) and pin full-f32 matmul and convolution arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)
